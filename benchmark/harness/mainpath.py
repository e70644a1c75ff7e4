"""The CBF-filtered rollout step of a configuration (the rollout and the
latency cells): the program's step as the window drives it, the
recording of the steps a seed samples, and their check against the
reference.

One step is the port's `bench.py::filtered_step` with every draw made by
the benchmark: the policy samples from standard normals, the centralized
filter corrects the action (warm-started from the previous step's u*),
the env steps and resets from the given reset draws."""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from benchmark.harness import draws as D
from benchmark.harness.compare import Check, policy_out, rel_gap, state_gap, to_lower, worst
from benchmark.harness.weights import load_mlp, mlp_weights, widths_of


@dataclass
class Record:
    """One sampled step: its inputs and what the program produced."""

    state: object  # the step's input state (a copy)
    obs: torch.Tensor
    noise: torch.Tensor
    draws: object
    action: torch.Tensor = None
    finfo: object = None
    state_out: object = None
    obs_out: torch.Tensor = None
    reward: torch.Tensor = None
    done: torch.Tensor = None


def parameters(mod, config: dict, batch: int, dev):
    """The `Parameters` of module `mod` (the port's or the reference's
    `config`) for this configuration at `batch` envs."""
    return mod.Parameters(**config["parameters"], num_vmas_envs=batch, device=str(dev))


def build(pkg, config: dict, batch: int, dev):
    """(env, filter, policy) of the configuration at `batch` envs from the
    modules of `pkg` (the port's or the reference's)."""
    p = parameters(pkg.config, config, batch, dev)
    env = pkg.env.make_env(p, device=dev)
    f = config["filter"]
    cbf = pkg.cbf_qp.CBFSafetyFilter(
        pkg.cbf_qp.CBFConfig(n_agents=p.n_agents, n_circles=f["n_circles"], dt=p.dt,
                             newton_iters=f["newton_iters"],
                             newton_soft_iters=f["newton_soft_iters"]),
        env.cfg, env.tables, max_group_size=f["max_group_size"], device=dev)
    policy = pkg.networks.PolicyNet(env.obs_dim, 2, tuple(config["policy"]["hidden"]), device=dev)
    return env, cbf, policy


def program_modules() -> SimpleNamespace:
    from sigmarl_tpu_torch import config
    from sigmarl_tpu_torch.env import env, reset
    from sigmarl_tpu_torch.rl import networks
    from sigmarl_tpu_torch.safety import cbf_qp, wrappers

    return SimpleNamespace(config=config, env=env, cbf_qp=cbf_qp, networks=networks, reset=reset,
                           wrappers=wrappers)


def reference_modules() -> SimpleNamespace:
    from benchmark.reference import config
    from benchmark.reference.env import env, reset, structs
    from benchmark.reference.ops import qp as ops_qp
    from benchmark.reference.rl import networks
    from benchmark.reference.safety import cbf_qp, qp

    return SimpleNamespace(config=config, env=env, cbf_qp=cbf_qp, networks=networks, reset=reset,
                           structs=structs, qp=qp, ops_qp=ops_qp)


class MainPath:
    """The program's filtered rollout at `batch` envs from `seed`: weights
    and draws from one card generator, the all-zero state or `env.reset`
    as the start."""

    def __init__(self, config: dict, batch: int, seed: int, dev: torch.device):
        self.config, self.batch, self.dev = config, batch, dev
        self.mods = program_modules()
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.env, self.cbf, self.policy = build(self.mods, config, batch, dev)
        self.weights = mlp_weights(widths_of(self.policy.layers), self.gen, dev)
        load_mlp(self.policy.layers, self.weights)
        self.lim = self.env.action_limits
        self.slots = self.mods.reset.compact_slots(batch, False)
        self.unsolved = torch.zeros((), dtype=torch.int64, device=dev)
        self.records = []
        self.start = None  # (draws, state, obs) of `start_reset`
        self.state = self.obs = None

    def start_zero(self) -> None:
        """The all-zero state: the first step resets every env."""
        from sigmarl_tpu_torch.env.structs import zero_state

        self.state = zero_state(self.env.cfg, self.dev)
        self.obs = torch.zeros((self.batch, self.env.n_agents, self.env.obs_dim), device=self.dev)

    def start_reset(self) -> None:
        """`env.reset` from the benchmark's draws, kept for the check."""
        draws = D.reset_draws(self.mods.reset.ResetDraws, self.env.cfg, self.gen, self.dev, 0)
        self.state, self.obs = self.env.reset(draws=draws)
        self.start = (draws, D.clone(self.state), self.obs.clone())

    def step(self, record: bool = False):
        """One filtered step; with `record`, its inputs and outputs are kept
        for the check. Returns the done flags."""
        B, N = self.batch, self.env.n_agents
        noise = torch.randn((B, N, 2), generator=self.gen, device=self.dev)
        draws = D.reset_draws(self.mods.reset.ResetDraws, self.env.cfg, self.gen, self.dev,
                              self.slots)
        rec = None
        if record:
            rec = Record(D.clone(self.state), self.obs.clone(), noise, draws)
            self._capture_filter(rec)
        with torch.no_grad():
            loc, scale = self.policy(self.obs)
            act, _ = self.mods.networks.tanh_normal_sample(loc, scale, -self.lim, self.lim,
                                                           noise=noise)
            state, obs, rew, done, info = self.mods.wrappers.cbf_filtered_step(
                self.env, self.cbf, self.state, act, reset_draws=draws)
        self.unsolved += (~info["cbf_solved"]).sum()
        if rec is not None:
            self._release_filter()
            rec.action, rec.state_out, rec.obs_out = act.clone(), D.clone(state), obs.clone()
            rec.reward, rec.done = rew.clone(), done.clone()
            self.records.append(rec)
        self.state, self.obs = state, obs
        return done

    def _capture_filter(self, rec: Record) -> None:
        """Keep a copy of the filter's output of this step in `rec` (the
        instance's method is wrapped for the one step)."""
        self._outer = self.cbf.__dict__.get("filter_actions")
        fn = self.cbf.filter_actions

        def capture(*args, **kw):
            out = fn(*args, **kw)
            rec.finfo = out._replace(**{k: v.clone() for k, v in out._asdict().items()})
            return out

        self.cbf.filter_actions = capture

    def _release_filter(self) -> None:
        if self._outer is None:
            del self.cbf.filter_actions
        else:
            self.cbf.filter_actions = self._outer

    def release(self) -> None:
        """Drop the program's state and objects; the records stay."""
        self.env = self.cbf = self.policy = self.state = self.obs = None


def sampled_steps(seed: int, count: int, below: int) -> set:
    """The step indices of the window whose outputs are checked: `count`
    of range(`below`), drawn from the seed."""
    return set(random.Random(seed).sample(range(below), count))


class Reference:
    """The reference's main path at the program's sizes, with the
    program's weights, on `dev`."""

    def __init__(self, config: dict, batch: int, dev, weights):
        self.mods = reference_modules()
        torch.backends.cuda.matmul.allow_tf32 = False
        self.env, self.cbf, self.policy = build(self.mods, config, batch, dev)
        load_mlp(self.policy.layers, weights)
        self.lim = self.env.action_limits

    def act(self, obs, noise, tf32: bool = False):
        nets = self.mods.networks
        with torch.no_grad():
            loc, scale = policy_out(nets, self.policy.layers, obs, tf32)
            act, _ = nets.tanh_normal_sample(loc, scale, -self.lim, self.lim, noise=noise)
        return act

    def objective(self, cons, u_nom, u) -> torch.Tensor:
        """F(u) [B] of the filter's QP `cons` at controls u [B, N, 2]."""
        c = self.cbf.cfg
        lo, hi = (self.cbf.a_min, self.cbf.rate_min), (self.cbf.a_max, self.cbf.rate_max)
        s, p, _, ui, un, pi, pj = self.mods.qp.kernel_inputs(cons, u_nom, lo, hi, u, c.newton_ws_cap)
        _, F = self.mods.ops_qp.newton_solve_reference(
            s, p, ui, ui, un, pi, pj, (c.w_u_acc, c.w_u_steer), lo, hi, 0,
            soft_iters=0, ws_cap=c.newton_ws_cap)
        return F

    def outputs(self, rec: Record, lower: bool = False):
        """What the reference puts in the program's place at `rec`'s inputs:
        (action, filter info, (state', obs', reward, done)), each stage fed
        the program's own output of the stage before: the filter the
        program's action, the env step the action the reference converts
        from the program's u* (and the nominal action the reference clamps
        from the program's action). With `lower`, the control: the
        policy's products in TF32 and every other float output rounded to
        bfloat16."""
        mods = self.mods
        act = self.act(rec.obs, rec.noise, tf32=lower)
        st = D.convert(rec.state, mods.structs.WorldState)
        with torch.no_grad():
            finfo = self.cbf.filter_actions(st, rec.action, u_init=st.cbf_u_prev)
            u_star = rec.finfo.u_star
            applied = self.cbf.u_to_rl_action(u_star, st.speed, st.steering)
            mid = mods.structs.replace_state(
                st, nominal_action=finfo.nominal_actions, applied_action=applied,
                cbf_u_prev=u_star)
            out = self.env.step(mid, applied,
                                reset_draws=D.convert(rec.draws, mods.reset.ResetDraws))[:4]
        if lower:
            low = lambda x: to_lower(x, torch.bfloat16)  # noqa: E731
            finfo = finfo._replace(**{k: low(v) for k, v in finfo._asdict().items()})
            s, o, r, d = out
            s = type(s)(**{k: low(v) for k, v in vars(s).items()})
            out = (s, low(o), low(r), d)
        return act, finfo, out

    def judge(self, rec: Record, act, finfo, env_out) -> list:
        """The compared numbers of one step: what the program produced in
        `rec` (or, for a control, `act`, `finfo`, `env_out` in its place)
        against what the reference recomputes. The filter's output is
        judged three ways: u* by the QP's objective, the applied action
        against the reference's conversion of that u*, the nominal action
        against the reference's clamp of the program's action."""
        ref_act, ref_finfo, ref_out = self.outputs(rec)
        st = D.convert(rec.state, self.mods.structs.WorldState)
        with torch.no_grad():
            cons, u_nom, _, _ = self.cbf.assemble(st, rec.action)
            F_p = self.objective(cons, u_nom, finfo.u_star)
            F_r = self.objective(cons, u_nom, ref_finfo.u_star)
            safe = self.cbf.u_to_rl_action(finfo.u_star, st.speed, st.steering)
        qp = float(((F_p.double() - F_r.double()).abs() / (F_r.double().abs() + 1.0)).max())
        if not bool(torch.isfinite(F_p).all()):
            qp = math.inf
        margin = max(rel_gap(getattr(finfo, k), getattr(ref_finfo, k)) for k in
                     ("rew_near_left_lane", "rew_near_right_lane", "rew_near_other_agents"))
        s_p, o_p, r_p, d_p = env_out
        s_r, o_r, r_r, d_r = ref_out
        env = max(state_gap(s_p, s_r)[0], rel_gap(o_p, o_r), rel_gap(r_p, r_r),
                  float((d_p != d_r).any()))
        return [("action_gap", rel_gap(act, ref_act)), ("qp_objective_gap", qp),
                ("safe_action_gap", rel_gap(finfo.safe_actions, safe)),
                ("nominal_action_gap", rel_gap(finfo.nominal_actions, ref_finfo.nominal_actions)),
                ("lane_margin_gap", margin), ("env_gap", env)]


def start_gap(ref: Reference, start, lower: bool = False) -> float:
    """The program's `env.reset` (draws, state, obs) against the
    reference's from the same draws; with `lower`, the control's."""
    draws, state, obs = start
    with torch.no_grad():
        s_r, o_r = ref.env.reset(draws=D.convert(draws, ref.mods.reset.ResetDraws))
    if lower:
        state = type(s_r)(**{k: to_lower(v, torch.bfloat16) for k, v in vars(s_r).items()})
        obs = to_lower(o_r, torch.bfloat16)
    return max(state_gap(state, s_r)[0], rel_gap(obs, o_r))


def check(config: dict, batch: int, dev, weights, records, limits: dict,
          control=None, start=None) -> list:
    """The Checks of the recorded steps (the largest of each number over
    them) and of the `start` (`MainPath.start`), which counts under
    `env_gap`; with `control` (True), of the control put in the program's
    place."""
    if control not in (None, False, True):
        raise ValueError(f"the main path has no variant {control!r}")
    ref = Reference(config, batch, dev, weights)
    out = []
    if start is not None:
        out.append(Check("env_gap", start_gap(ref, start, bool(control)), limits["env_gap"]))
    for rec in records:
        if control:
            act, finfo, env_out = ref.outputs(rec, lower=True)
        else:
            env_out = (rec.state_out, rec.obs_out, rec.reward, rec.done)
            act, finfo = rec.action, rec.finfo
        out += [Check(n, v, limits[n]) for n, v in ref.judge(rec, act, finfo, env_out)]
    if not records:
        out = [Check("sampled_steps_reached", 0.0, -1.0)]
    return worst(out)
