"""`main_eval`'s recorded CBF-filter evaluation as the eval cell drives it,
the recording of the steps it checks, and their check against the
reference.

The program is what `sigmarl_tpu_torch/main_eval.py::build` builds from
the configuration (the testing-mode env, the centralized filter with the
CLF nominal controller, the constant (0.5, 0) nominal action), rolled out
by `eval/rollout.py::rollout` from `env.reset`, its records copied to the
host once per chunk. Every draw is the benchmark's: the start's and each
step's reset uniforms come from one card generator, each step's when the
rollout asks for it (`_Draws`). For a step to be checked, the filter's and
the env step's methods of the instance are wrapped for that one step, as
`harness/spans.py` wraps them, keeping the step's input state, the
filter's output and the env step's output; the host's record of the step
is taken from what the rollout returns.

The configuration has to be `main_eval`'s: testing mode, the centralized
filter with the CLF nominal at 2 soft + 15 full Newton steps, windowed
lane distances, no grouping; a configuration that says otherwise, or a
build that differs from it, is refused (ValueError)."""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import torch

from benchmark.harness import draws as D
from benchmark.harness import mainpath
from benchmark.harness.compare import Check, rel_gap, state_gap, to_lower, worst

# What `main_eval` fixes: the configuration must say the same.
PARAMETERS = {"dt": 0.1, "is_testing_mode": True, "is_obs_noise": False,
              "is_use_mtv_distance": False, "is_using_cbf_testing": True,
              "is_using_centralized_cbf": True, "nom_controller_type": "clf"}
FILTER = {"newton_iters": 15, "newton_soft_iters": 2, "nom_controller_type": "clf",
          "use_windowed_pseudo_distance": True, "max_group_size": 0}
# `main_eval`'s record under the filter: `eval/rollout.py`'s keys, then
# the reward and the done flags.
RECORD_KEYS = (
    "pos", "rot", "vel", "distance_ref", "distance_left_b", "distance_right_b",
    "is_collision_with_agents", "is_collision_with_lanelets", "is_reach_goal",
    "path_id", "nominal_action", "applied_action", "rew_progress", "rew_total",
    "cbf_solved", "cbf_infeasible", "cbf_max_violation", "reward", "done",
)


def refuse(config: dict) -> None:
    """Raise ValueError unless `config` is `main_eval`'s evaluation."""
    p, f = config["parameters"], config["filter"]
    wrong = {k: p.get(k) for k, v in PARAMETERS.items() if p.get(k) != v}
    wrong.update({f"filter.{k}": f.get(k) for k, v in FILTER.items() if f.get(k) != v})
    if p.get("n_circles_approximate_vehicle") != f.get("n_circles"):
        wrong["filter.n_circles"] = f.get("n_circles")
    if wrong:
        raise ValueError(f"not main_eval's CLF evaluation: {wrong}")


def main_eval_args(config: dict, batch: int, dev: torch.device):
    """`main_eval`'s parsed arguments for this configuration at `batch`
    envs on `dev`'s kind of device."""
    from sigmarl_tpu_torch import main_eval

    p, f = config["parameters"], config["filter"]
    return main_eval.parse_args([
        "--scenario_type", p["scenario_type"], "--n_agents", str(p["n_agents"]),
        "--num_envs", str(batch), "--max_steps", str(p["max_steps"]),
        "--n_circles", str(f["n_circles"]), "--nom_controller_type", f["nom_controller_type"],
        "--device", dev.type])


def held(config: dict, env, cbf) -> None:
    """Raise ValueError where what `main_eval` built is not `config`."""
    c, f = cbf.cfg, config["filter"]
    built = {"n_circles": c.n_circles, "newton_iters": c.newton_iters,
             "newton_soft_iters": c.newton_soft_iters,
             "nom_controller_type": c.nom_controller_type,
             "use_windowed_pseudo_distance": c.use_windowed_pseudo_distance,
             "max_group_size": cbf.max_group_size}
    wrong = {k: v for k, v in built.items() if f[k] != v}
    if not env.cfg.is_testing_mode or cbf.decentralized:
        wrong["testing mode, centralized"] = (env.cfg.is_testing_mode, not cbf.decentralized)
    if wrong:
        raise ValueError(f"main_eval built another evaluation than the configuration: {wrong}")


@dataclass
class Step(mainpath.Record):
    """A checked step: `mainpath.Record`'s fields, the step's index in its
    rollout and the host's record of it."""

    t: int = -1
    host: dict = None


def _wrap(obj, attr: str, make):
    """Replace the instance's method `attr` by `make(inner)`; returns the
    function that puts the method back."""
    inner, own = getattr(obj, attr), attr in obj.__dict__
    setattr(obj, attr, make(inner))

    def restore():
        if own:
            setattr(obj, attr, inner)
        else:
            delattr(obj, attr)

    return restore


class _Draws:
    """What `rollout` gets as its `draws`: step t's reset uniforms drawn
    from the benchmark's generator when the rollout asks for them, and for
    a step in `sample` (every step with `watch`) its capture armed."""

    def __init__(self, ev: "ClfEval", sample, watch: bool):
        self.ev, self.sample, self.watch = ev, sample, watch

    def __getitem__(self, t: int):
        ev = self.ev
        d = ev.R.StepDraws(reset=D.reset_draws(ev.ResetDraws, ev.env.cfg, ev.gen, ev.dev,
                                               ev.slots))
        if self.watch or t in self.sample:
            ev.arm(Step(None, None, None, d.reset, t=t), keep=t in self.sample)
        return d


class ClfEval:
    """The program's recorded evaluation at `batch` envs from `seed`."""

    def __init__(self, config: dict, batch: int, seed: int, dev: torch.device, chunk: int):
        refuse(config)
        from sigmarl_tpu_torch import main_eval
        from sigmarl_tpu_torch.env.reset import ResetDraws, compact_slots

        # the module (the package `eval` exports its function `rollout`)
        self.R = importlib.import_module("sigmarl_tpu_torch.eval.rollout")
        self.ResetDraws = ResetDraws
        self.config, self.batch, self.dev, self.chunk = config, batch, dev, chunk
        self.env, self.cbf, self.policy = main_eval.build(main_eval_args(config, batch, dev))
        held(config, self.env, self.cbf)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.slots = compact_slots(batch, False)
        self.records = []  # the sampled steps, in their order
        self.single = None  # the first step seen in which an agent reset alone
        self.start = None  # (draws, state, obs) of the first `env.reset`
        self.unsolved = 0  # env-steps whose filter found no finite solution
        self.last = None  # (state, obs) after the latest watched step
        self._kept = []

    def arm(self, rec: Step, keep: bool) -> None:
        """Capture the next filtered step into `rec`: its input state and
        action, the filter's output, the env step's output. A kept step
        joins `records`; any step in which an env reset before its
        episode's end becomes `single` if there is none yet."""
        cbf, env = self.cbf, self.env
        restores = []

        def filter_actions(inner):
            def captured(state, rl_actions, *args, **kw):
                rec.state, rec.action = D.clone(state), rl_actions.clone()
                out = inner(state, rl_actions, *args, **kw)
                rec.finfo = out._replace(**{k: v.clone() for k, v in out._asdict().items()})
                return out
            return captured

        def step(inner):
            def captured(*args, **kw):
                before = env.reset_steps
                out = inner(*args, **kw)
                for restore in restores:
                    restore()
                state, obs, reward, done, _ = out
                rec.state_out, rec.obs_out = D.clone(state), obs.clone()
                rec.reward, rec.done = reward.clone(), done.clone()
                self.last = (state, obs)
                if keep:
                    self.records.append(rec)
                    self._kept.append(rec)
                if (self.single is None and env.reset_steps > before
                        and not bool(done.any())):
                    self.single = rec
                    self._kept.append(rec)
                return out
            return captured

        restores.append(_wrap(cbf, "filter_actions", filter_actions))
        restores.append(_wrap(env, "step", step))

    def run(self, steps: int, sample=(), start=None, watch: bool = False,
            keep_start: bool = False) -> None:
        """One recorded rollout of `steps` steps from `env.reset` (its draws
        the benchmark's) or from `start` (a (state, obs) pair); the steps
        in `sample`, and with `watch` every step, captured (`arm`)."""
        reset = None
        restore = None
        if start is None:
            reset = D.reset_draws(self.ResetDraws, self.env.cfg, self.gen, self.dev, 0)
            if keep_start:
                def kept(inner):
                    def captured(*args, **kw):
                        state, obs = inner(*args, **kw)
                        self.start = (reset, D.clone(state), obs.clone())
                        return state, obs
                    return captured
                restore = _wrap(self.env, "reset", kept)
        try:
            out, _ = self.R.rollout(self.env, self.policy, steps, cbf=self.cbf, state=start,
                                    chunk=self.chunk, draws=_Draws(self, set(sample), watch),
                                    reset_draws=reset)
        finally:
            if restore is not None:
                restore()
        for rec in self._kept:
            rec.host = {k: v[rec.t].copy() for k, v in out.items()}
        self._kept = []
        self.unsolved += int((~out["cbf_solved"]).sum())

    def warm_up(self, chunks: int, search_chunks: int) -> None:
        """`chunks` chunks from `env.reset` (the start kept for the check),
        every step watched, then up to `search_chunks` more on from there
        until an agent has reset alone."""
        self.run(self.chunk * chunks, watch=True, keep_start=True)
        for _ in range(search_chunks):
            if self.single is not None:
                break
            self.run(self.chunk, start=self.last, watch=True)
        self.last = None

    def release(self) -> None:
        """Drop the program's objects (and its graphs); the records stay."""
        self.env = self.cbf = self.policy = self.last = None


class EvalReference(mainpath.Reference):
    """The reference's evaluation at the program's sizes on `dev`: the
    testing-mode env and the filter with the CLF nominal controller."""

    def __init__(self, config: dict, batch: int, dev):
        self.mods = mods = mainpath.reference_modules()
        torch.backends.cuda.matmul.allow_tf32 = False
        p = mainpath.parameters(mods.config, config, batch, dev)
        self.env = mods.env.make_env(p, device=dev)
        f = config["filter"]
        self.cbf = mods.cbf_qp.CBFSafetyFilter(
            mods.cbf_qp.CBFConfig(n_agents=p.n_agents, n_circles=f["n_circles"], dt=p.dt,
                                  newton_iters=f["newton_iters"],
                                  newton_soft_iters=f["newton_soft_iters"],
                                  nom_controller_type=f["nom_controller_type"],
                                  use_windowed_pseudo_distance=f["use_windowed_pseudo_distance"]),
            self.env.cfg, self.env.tables, max_group_size=f["max_group_size"], device=dev)

    def outputs(self, rec: Step, lower: bool = False):
        """What the reference puts in the program's place at `rec`'s inputs:
        (filter info, (state', obs', reward, done), record), the filter fed
        the program's nominal action, the env step the action the
        reference converts from the program's u*; the record is the env
        step's info with the filter's diagnostics, the reward and the done
        flags. With `lower`, the control: every float output rounded to
        bfloat16."""
        mods = self.mods
        st = D.convert(rec.state, mods.structs.WorldState)
        with torch.no_grad():
            finfo = self.cbf.filter_actions(st, rec.action, u_init=st.cbf_u_prev)
            u_star = rec.finfo.u_star
            applied = self.cbf.u_to_rl_action(u_star, st.speed, st.steering)
            mid = mods.structs.replace_state(
                st, nominal_action=finfo.nominal_actions, applied_action=applied,
                cbf_u_prev=u_star)
            s, o, r, d, info = self.env.step(
                mid, applied, reset_draws=D.convert(rec.draws, mods.reset.ResetDraws))
        record = dict(info, cbf_solved=finfo.solved, cbf_infeasible=finfo.infeasible,
                      cbf_max_violation=finfo.max_violation, reward=r, done=d)
        record = {k: record[k] for k in RECORD_KEYS}
        if lower:
            low = lambda x: to_lower(x, torch.bfloat16)  # noqa: E731
            finfo = finfo._replace(**{k: low(v) for k, v in finfo._asdict().items()})
            s = type(s)(**{k: low(v) for k, v in vars(s).items()})
            o, r = low(o), low(r)
            record = {k: low(v) for k, v in record.items()}
        return finfo, (s, o, r, d), {k: v.cpu().numpy() for k, v in record.items()}

    def judge(self, rec: Step, finfo, env_out, record: dict) -> list:
        """The compared numbers of one step: the filter's output, the env
        step's and the host's record (or a control's in their place)
        against what the reference recomputes. u* is judged by the QP's
        objective with the CLF rows, the applied action against the
        reference's conversion of that u*, the nominal action against the
        reference's CLF controller at the step's state."""
        ref_finfo, ref_out, ref_record = self.outputs(rec)
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
        return [("qp_objective_gap", qp),
                ("safe_action_gap", rel_gap(finfo.safe_actions, safe)),
                ("nominal_action_gap", rel_gap(finfo.nominal_actions, ref_finfo.nominal_actions)),
                ("lane_margin_gap", margin), ("env_gap", env),
                ("record_gap", record_gap(record, ref_record))]


def record_gap(host: dict, ref: dict) -> float:
    """The worst `rel_gap` over the record's keys between the host's record
    of a step and the reference's (flags as 0 or 1); inf where the host's
    record lacks a key or holds another."""
    if host is None or set(host) != set(ref):
        return math.inf
    return max(rel_gap(torch.from_numpy(host[k]).double(), torch.from_numpy(ref[k]).double())
               for k in RECORD_KEYS)


def check(config: dict, batch: int, dev, ev: ClfEval, episode_end: int, limits: dict,
          control=None) -> list:
    """The Checks of the recorded steps (the largest of each number over
    them: the sampled steps, the episode's last step and the first step in
    which an agent reset alone) and of the start, which counts under
    `env_gap`; with `control` (True), of the control put in the program's
    place. `single_reset_missing` and `episode_end_missing` are 1 where the
    run recorded no such step."""
    if control not in (None, False, True):
        raise ValueError(f"the eval cell has no variant {control!r}")
    ref = EvalReference(config, batch, dev)
    out = []
    if ev.start is not None:
        out.append(Check("env_gap", mainpath.start_gap(ref, ev.start, bool(control)),
                         limits["env_gap"]))
    steps = ev.records + ([ev.single] if ev.single is not None else [])
    for rec in steps:
        if control:
            finfo, env_out, record = ref.outputs(rec, lower=True)
        else:
            finfo, env_out, record = (rec.finfo, (rec.state_out, rec.obs_out, rec.reward,
                                                  rec.done), rec.host)
        out += [Check(n, v, limits[n]) for n, v in ref.judge(rec, finfo, env_out, record)]
    end = [r for r in ev.records if r.t == episode_end and bool(r.done.all())]
    out += [Check("single_reset_missing", float(ev.single is None),
                  limits["single_reset_missing"]),
            Check("episode_end_missing", float(not end), limits["episode_end_missing"])]
    if not ev.records:
        out.append(Check("sampled_steps_reached", 0.0, -1.0))
    return worst(out)
