"""The training iteration of a configuration (the train cell): the
trainer as the window drives it, the iterations it records, and their
check against the reference.

Set-up builds one `MAPPOCAVs`, loads weights drawn from the seed, and
drives it through its first iteration with the benchmark's draws (the
same call and feed as the window's); the window records one more
iteration, drawn from the seed. A recorded iteration keeps the trainer's
parameters, Adam moments and update count at its start, its draws, a few
of its rollout steps (the env step's inputs and outputs), its frames and
GAE, and its first updates: the moments after the first, the parameters
and the loss statistics after the last checked one. The reference
follows each: the set-up's from the seed's weights and fresh moments
(the start), the window's from the program's state at its start (the
reference does not replay the iterations between); each sampled step
from the program's own state (the reference does not roll out 128 steps
of its own), the acting from the program's observations, GAE from the
program's rollout, and the updates from the frames the program's
`frames` returned and the iteration's minibatch draws."""

from __future__ import annotations

import math
import os
import random
import tempfile

import torch

from benchmark.harness import draws as D
from benchmark.harness.compare import (Check, mlp_forward, policy_out, rel_gap, state_gap,
                                       to_lower, worst)
from benchmark.harness.weights import load_mlp, mlp_weights

STATS = ("loss_objective", "loss_critic", "loss_entropy", "entropy", "ratio_mean")
# Leaves whose first gradient in the reference is under this share of the
# median leaf's are left out of the change's comparison: Adam moves them
# by round-off alone.
ZERO_GRAD_SHARE = 1e-3


def parameters(mod, config: dict, batch: int, dev):
    save = os.path.join(tempfile.gettempdir(), "sigmarl_bench_train") + os.sep
    return mod.Parameters(**config["parameters"], num_vmas_envs=batch, device=str(dev),
                          where_to_save=save, is_save_intermediate_model=False)


def network_widths(config: dict, obs_dim: int, n_agents: int):
    return ([obs_dim, *config["policy"]["hidden"], 4],
            [n_agents * obs_dim, *config["critic"]["hidden"], 1])


def _clones(tensors):
    return [t.detach().clone() for t in tensors]


class Trainer:
    """The program's trainer at `batch` envs from `seed`, and its recorded
    iterations: `records[0]` the set-up's first (with the start,
    `env.reset`), `records[1]` the window's `window_iteration`-th."""

    def __init__(self, config: dict, batch: int, seed: int, dev, sampled: int, updates: int,
                 iterations_below: int):
        from sigmarl_tpu_torch import config as pconfig
        from sigmarl_tpu_torch.env.reset import ResetDraws
        from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws, MAPPOCAVs

        self.ResetDraws, self.IterationDraws = ResetDraws, IterationDraws
        self.config, self.batch, self.dev = config, batch, dev
        p = parameters(pconfig, config, batch, dev)
        self.p = p
        self.trainer = tr = MAPPOCAVs(p, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        cfg = tr.env.cfg
        pol, cri = network_widths(config, tr.policy_obs_dim, cfg.n_agents)
        self.weights = (mlp_weights(pol, self.gen, dev), mlp_weights(cri, self.gen, dev))
        load_mlp(tr.policy_net.layers, self.weights[0])
        load_mlp(tr.critic_net.mlp.layers, self.weights[1])
        first = D.reset_draws(ResetDraws, cfg, self.gen, dev, 0)
        noise = torch.rand((batch, cfg.n_agents, cfg.obs_dim), generator=self.gen, device=dev)
        self.state = tr.initial_state(reset_draws=first, obs_noise=noise)
        rng = random.Random(seed)
        self.sampled = set(rng.sample(range(p.max_steps), sampled))
        self.window_iteration = rng.randrange(iterations_below)
        self.updates = updates
        self.start = (first, noise, D.clone(self.state.env_state), self.state.obs.clone())
        self.records = []

    def iteration_draws(self):
        """Every draw of one iteration, from the card's generator in a few
        calls: action noise [T, B, N, 2], one reset draw per step, the
        epochs' permutations (argsort of uniforms), the entropy noise
        [E, n_mb, mb, N, 2] and the observation noise [T, B, N, obs]."""
        tr, p, g, dev = self.trainer, self.p, self.gen, self.dev
        cfg = tr.env.cfg
        T, B, N = p.max_steps, self.batch, cfg.n_agents
        M, n_mb = T * B, tr.n_minibatches
        return self.IterationDraws(
            action_noise=torch.randn((T, B, N, 2), generator=g, device=dev),
            reset_draws=D.reset_draws(self.ResetDraws, cfg, g, dev, 0, steps=T),
            permutations=torch.rand((p.num_epochs, M), generator=g, device=dev).argsort(-1),
            entropy_noise=torch.randn((p.num_epochs, n_mb, M // n_mb, N, 2), generator=g,
                                      device=dev),
            obs_noise=torch.rand((T, B, N, cfg.obs_dim), generator=g, device=dev),
        )

    def iterate(self):
        self.state, m = self.trainer.train_iteration(self.state, self.iteration_draws())
        return m

    def first_iteration(self) -> None:
        """The set-up's iteration, recorded with the start."""
        self.record_iteration()
        self.records[0]["start"] = self.start

    def record_iteration(self):
        """One iteration through the window's own call and feed, recorded
        (see the module's docstring) in `records`; returns its metrics."""
        tr = self.trainer
        opt = self.state.opt_state
        rec = {"theta0": _clones(tr.parameter_list()), "mu0": _clones(opt.mu),
               "nu0": _clones(opt.nu), "count": opt.count, "steps": {}, "chain": {}}
        draws = self.iteration_draws()
        rec["draws"] = draws
        calls = {"step": 0, "run": 0}
        transition, frames, update_program = tr.env_transition, tr.frames, tr.update_program

        def env_transition(env_state, action, reset_draws=None, cbf_noise=None, obs_noise=None):
            t = calls["step"]
            calls["step"] += 1
            if t - 1 in self.sampled:  # the state a sampled step handed on
                rec["chain"][t - 1] = D.clone(env_state)
            inp = (D.clone(env_state), action.clone()) if t in self.sampled else None
            out = transition(env_state, action, reset_draws, cbf_noise=cbf_noise,
                             obs_noise=obs_noise)
            if inp is not None:
                rec["steps"][t] = (*inp, D.clone(out[0]), out[1].clone(), out[2].clone(),
                                   out[3].clone())
            return out

        def frames_rec(state, batch):
            data, prio = frames(state, batch)
            rec["batch"] = batch
            rec["data"] = {k: v.clone() for k, v in data.items()}
            return data, prio

        def program(state, data):
            prog = update_program(state, data)
            run = prog.run

            def run_rec(*args):
                run(*args)
                calls["run"] += 1
                if calls["run"] == 1:
                    rec["mu1"] = _clones(prog.mu)
                if calls["run"] == self.updates:
                    rec["theta_n"] = _clones(prog.params)
                    rec["stats"] = (prog.keys, prog.stats[:, :self.updates].clone())
                    del prog.run

            prog.run = run_rec
            return prog

        tr.env_transition, tr.frames, tr.update_program = env_transition, frames_rec, program
        try:
            self.state, m = tr.train_iteration(self.state, draws)
        finally:
            del tr.env_transition, tr.frames, tr.update_program
        if not rec["steps"] or "stats" not in rec:
            raise RuntimeError("the iteration did not reach its sampled steps and updates")
        self.records.append(rec)
        return m

    def shapes(self) -> dict:
        tr, p = self.trainer, self.p
        return {"batch": self.batch, "steps": p.max_steps, "n_agents": tr.env.cfg.n_agents,
                "obs_dim": tr.policy_obs_dim, "hidden": self.config["policy"]["hidden"],
                "critic_hidden": self.config["critic"]["hidden"],
                "updates": tr.updates_per_iter,
                "minibatch": p.max_steps * self.batch // tr.n_minibatches}

    def release(self) -> None:
        self.trainer = self.state = None


def _leaf_norms(tensors):
    return torch.stack([t.double().norm() for t in tensors])


def leaf_gap(prog_norms, ref_norms, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    med = float(ref_norms.median())
    gaps = (prog_norms - ref_norms).abs() / torch.clamp(ref_norms, min=med)
    if keep is not None:
        gaps = gaps[keep]
    return float(gaps.max()) if gaps.numel() else 0.0


class TrainReference:
    """The reference's env, networks, GAE, loss and optimizer at the
    program's sizes."""

    def __init__(self, config: dict, batch: int, dev, weights):
        from benchmark.reference import config as rconfig
        from benchmark.reference.env import env as renv, reset, structs
        from benchmark.reference.rl import networks, optim, ppo

        self.reset, self.structs, self.networks, self.optim, self.ppo = (
            reset, structs, networks, optim, ppo)
        torch.backends.cuda.matmul.allow_tf32 = False
        p = parameters(rconfig, config, batch, dev)
        self.env = renv.make_env(p, device=dev)
        cfg = self.env.cfg
        self.policy = networks.PolicyNet(cfg.obs_dim, 2, tuple(config["policy"]["hidden"]),
                                         device=dev)
        self.critic = networks.CentralizedCritic(cfg.obs_dim, cfg.n_agents,
                                                 tuple(config["critic"]["hidden"]), device=dev)
        self.weights = weights
        self.low, self.high = -self.env.action_limits, self.env.action_limits
        self.cfg = ppo.PPOConfig(gamma=p.gamma, lmbda=p.lmbda, clip_epsilon=p.clip_epsilon,
                                 entropy_eps=p.entropy_eps)
        n_mb = max(1, p.frames_per_batch // p.minibatch_size)
        self.opt = optim.ClippedAdam(p.max_grad_norm, p.lr, p.lr_min, p.num_epochs * n_mb,
                                     p.n_iters)

    def policy_out(self, obs, tf32=False):
        return policy_out(self.networks, self.policy.layers, obs, tf32)

    def values(self, obs, tf32=False):
        """[..., N, 1]: the centralized value, broadcast to every agent."""
        v = mlp_forward(self.critic.mlp.layers, obs.reshape(obs.shape[:-2] + (-1,)), tf32)
        return v[..., None, :].expand(obs.shape[:-1] + (1,))

    def params(self):
        return list(self.policy.parameters()) + list(self.critic.parameters())

    def load(self, rec):
        """The networks and optimizer state at the recorded iteration's
        start: for the set-up's (the start) the seed's weights and fresh
        moments, for a later one the program's parameters, moments and
        count."""
        params = self.params()
        if "start" in rec:
            load_mlp(self.policy.layers, self.weights[0])
            load_mlp(self.critic.mlp.layers, self.weights[1])
            return self.opt.init(params)
        if [t.shape for t in params] != [t.shape for t in rec["theta0"]]:
            raise ValueError("the program's parameters are not laid out as the reference's")
        with torch.no_grad():
            for t, v in zip(params, rec["theta0"]):
                t.copy_(v)
        return self.optim.AdamState(rec["count"], _clones(rec["mu0"]), _clones(rec["nu0"]))

    def outputs(self, rec, variant=None):
        """What the reference computes from the record: the start (with
        the set-up's record), per sampled step (action, log_prob) and the
        env step, GAE's (adv, vt), and the updates' statistics [keys, n],
        the moments after the first, the parameters after n. `variant`:
        "lower" (TF32 products, bfloat16 env outputs), "half" (each
        minibatch's loss over its first half), "altered" (the first sampled
        step's reward altered), or None (the reference itself)."""
        tf32 = variant == "lower"
        draws, batch, data = rec["draws"], rec["batch"], rec["data"]
        state = self.load(rec)
        out = {"acting": {}, "env": {}}
        with torch.no_grad():
            if "start" in rec:
                first, noise, _, _ = rec["start"]
                s0, o0 = self.env.reset(draws=D.convert(first, self.reset.ResetDraws),
                                        obs_noise=noise)
                if tf32:
                    s0 = type(s0)(**{k: to_lower(v, torch.bfloat16) for k, v in vars(s0).items()})
                    o0 = to_lower(o0, torch.bfloat16)
                out["start"] = (s0, o0)
            for t, (st, act, *_rest) in rec["steps"].items():
                loc, scale = self.policy_out(batch.obs[t], tf32)
                out["acting"][t] = self.networks.tanh_normal_sample(
                    loc, scale, self.low, self.high, noise=draws.action_noise[t])
                s = D.convert(st, self.structs.WorldState)
                res = self.env.step(s, act, reset_draws=D.convert(draws.reset_draws[t],
                                                                  self.reset.ResetDraws),
                                    obs_noise=draws.obs_noise[t])[:4]
                if tf32:
                    low = lambda x: to_lower(x, torch.bfloat16)  # noqa: E731
                    s2, o, r, d = res
                    res = (type(s2)(**{k: low(v) for k, v in vars(s2).items()}), low(o), low(r), d)
                if variant == "altered" and t == min(rec["steps"]):
                    res = (res[0], res[1], res[2] + 0.5, res[3])
                out["env"][t] = res
            v = self.values(batch.obs, tf32)[..., 0]
            nv = self.values(batch.next_obs, tf32)[..., 0]
            adv, vt = self.ppo.gae(batch.reward, v, nv, batch.done, self.cfg.gamma,
                                   self.cfg.lmbda)
            out["gae"] = (adv.reshape(-1, adv.shape[-1]), vt.reshape(-1, vt.shape[-1]))

        params = self.params()
        n = rec["stats"][1].shape[1]
        n_mb = draws.entropy_noise.shape[1]
        mb_rows = data["action"].shape[0] // n_mb
        stats = []
        for m in range(n):
            e, k = divmod(m, n_mb)  # the m-th update: epoch e, minibatch k
            idx = draws.permutations[e][k * mb_rows:(k + 1) * mb_rows]
            noise = draws.entropy_noise[e, k]
            if variant == "half":
                idx, noise = idx[:mb_rows // 2], noise[:mb_rows // 2]
            mb = {k: x[idx] for k, x in data.items()}
            loc, scale = self.policy_out(mb["obs"], tf32)
            val = self.values(mb["obs"], tf32)[..., 0]
            total, st = self.ppo.ppo_losses(loc, scale, val, mb["action"], mb["log_prob"],
                                            mb["adv"], mb["vt"], self.low, self.high, self.cfg,
                                            noise)
            grads = torch.autograd.grad(total, params)
            stats.append(torch.stack([st[k].detach() for k in STATS]))
            state = self.opt.step(params, grads, state)
            if m == 0:
                out["mu1"] = _clones(state.mu)
        out["stats"] = torch.stack(stats, 1)
        out["theta_n"] = _clones(params)
        return out


def first_gradient(mu1, mu0):
    """The first update's clipped gradient as the optimizer got it, from
    its first moment before and after: (mu1 - b1 mu0) / (1 - b1), in
    float64."""
    from benchmark.reference.rl.optim import B1

    return [(a.double() - B1 * b.double()) / (1 - B1) for a, b in zip(mu1, mu0)]


def judge(ref_out: dict, prog: dict, rec: dict) -> list:
    """The compared numbers of one recorded iteration: `prog` is what the
    program produced (or a control's `outputs` in its place), `ref_out`
    the reference's."""
    acting = max(max(rel_gap(prog["acting"][t][0], a), rel_gap(prog["acting"][t][1], lp))
                 for t, (a, lp) in ref_out["acting"].items())
    env = 0.0
    if "start" in ref_out:
        env = max(state_gap(prog["start"][0], ref_out["start"][0])[0],
                  rel_gap(prog["start"][1], ref_out["start"][1]))
    for t, handed in rec["chain"].items():  # the program against itself
        env = max(env, state_gap(handed, rec["steps"][t][2])[0])
    for t, (s_r, o_r, r_r, d_r) in ref_out["env"].items():
        s_p, o_p, r_p, d_p = prog["env"][t]
        env = max(env, state_gap(s_p, s_r)[0], rel_gap(o_p, o_r), rel_gap(r_p, r_r),
                  float((d_p != d_r).any()))
    gae = max(rel_gap(p, r) for p, r in zip(prog["gae"], ref_out["gae"]))
    ps = prog["stats"]
    rs = ref_out["stats"]
    loss = float(((ps.double() - rs.double()).abs() / torch.clamp(rs.double().abs(), min=1e-2))
                 .max())
    if not bool(torch.isfinite(ps).all()):
        loss = math.inf
    g_ref = _leaf_norms(first_gradient(ref_out["mu1"], rec["mu0"]))
    grad = leaf_gap(_leaf_norms(first_gradient(prog["mu1"], rec["mu0"])), g_ref)
    theta0 = rec["theta0"]
    keep = g_ref >= ZERO_GRAD_SHARE * g_ref.median()
    upd = leaf_gap(_leaf_norms([a - b for a, b in zip(prog["theta_n"], theta0)]),
                   _leaf_norms([a - b for a, b in zip(ref_out["theta_n"], theta0)]), keep)
    return [("action_gap", acting), ("env_gap", env), ("gae_gap", gae), ("loss_gap", loss),
            ("grad_gap", grad), ("update_gap", upd)]


def program_outputs(rec: dict) -> dict:
    """What the program produced, in the shape `judge` reads."""
    batch, data = rec["batch"], rec["data"]
    keys, stats = rec["stats"]
    order = [keys.index(k) for k in STATS]
    out = {
        "acting": {t: (batch.action[t], batch.log_prob[t]) for t in rec["steps"]},
        "env": {t: v[2:] for t, v in rec["steps"].items()},
        "gae": (data["adv"], data["vt"]),
        "stats": stats[order],
        "mu1": rec["mu1"],
        "theta_n": rec["theta_n"],
    }
    if "start" in rec:
        out["start"] = rec["start"][2:]
    return out


def check(config: dict, batch: int, dev, weights, records: list, limits: dict,
          variant: str | None = None) -> list:
    """The Checks of the recorded iterations (the largest of each number
    over them); with `variant`, of that control or fault put in the
    program's place ("unchanged": an update that leaves the parameters and
    moments as they were). A run that recorded fewer than the set-up's and
    the window's iteration fails."""
    ref = TrainReference(config, batch, dev, weights)
    out = []
    for rec in records:
        ref_out = ref.outputs(rec)
        if variant is None:
            prog = program_outputs(rec)
        elif variant == "unchanged":
            prog = dict(ref_out, theta_n=rec["theta0"], mu1=rec["mu0"])
        else:
            prog = ref.outputs(rec, variant)
        out += [Check(n, v, limits[n]) for n, v in judge(ref_out, prog, rec)]
    if len(records) < 2:
        out.append(Check("recorded_iterations", float(len(records)), -1.0))
    return worst(out)
