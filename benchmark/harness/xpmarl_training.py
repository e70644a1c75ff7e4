"""The XP-MARL training iteration of a configuration (the train_xpmarl
cell): the train cell's trainer with learned priority, whose agents act in
priority turns with action propagation, and its check against the
reference.

The trainer, its recorded iterations and most of their check are
`harness/training.py`'s. What XP-MARL adds: the priority actor and critic
(weights from the seed, after the policy's and the critic's), the draws of
the turns (action noise [T, N, B, 2], one block per turn), of the scores
[T, B, N, 1] and of the priority loss's entropy [E, n_mb, mb, N, 1]; and
per sampled step the rank the turns ran in. The check judges each layer
from the program's output of the layer before:

- the scores and their log-probabilities from the program's observation
  (`score_gap`), the rank from the program's scores (`rank_mismatch`, envs
  whose order differs);
- the turns in the program's rank: each agent's acted-on observation from
  the actions the program decided in earlier turns (`obs_tail_gap`), its
  action and log-probability from that observation (`action_gap`);
- the env step from the program's state and action (`env_gap`), GAE of
  both streams from the program's rollout (`gae_gap`), the first updates
  of the four networks from the program's frames (`loss_gap` with
  `loss_priority`, `grad_gap`, `update_gap`)."""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import draws as D
from benchmark.harness import training
from benchmark.harness.compare import Check, mlp_forward, rel_gap, to_lower, worst
from benchmark.harness.weights import load_mlp, mlp_weights

STATS = training.STATS + ("loss_priority",)


def priority_widths(config: dict, obs_dim: int, n_agents: int):
    """The priority actor's and critic's widths: the raw observation in,
    (loc, scale) of one score out; the critic over every agent's."""
    return ([obs_dim, *config["priority_policy"]["hidden"], 2],
            [n_agents * obs_dim, *config["priority_critic"]["hidden"], 1])


class XPMARLTrainer(training.Trainer):
    """`training.Trainer` with learned priority. Set-up refuses a trainer
    that is not learned priority ("marl") without a filter and without
    communication noise, which is what the check replays."""

    def __init__(self, config: dict, batch: int, seed: int, dev, sampled: int, updates: int,
                 iterations_below: int):
        super().__init__(config, batch, seed, dev, sampled, updates, iterations_below)
        from sigmarl_tpu_torch.env.reset import compact_slots

        p, tr = self.p, self.trainer
        if not (p.is_using_prioritized_marl and tr.prio_method == "marl"
                and tr.prio_policy_net is not None):
            raise ValueError("the configuration's trainer does not learn its priority")
        if p.is_using_cbf_training or tr.cbf_filter is not None:
            raise ValueError("the configuration's trainer filters its actions; the check "
                             "replays an unfiltered rollout")
        if tr.communication_noise_level:
            raise ValueError("the configuration's turns carry communication noise; the check "
                             "replays them without")
        cfg = tr.env.cfg
        pol, cri = priority_widths(config, cfg.obs_dim, cfg.n_agents)
        self.weights = (*self.weights, mlp_weights(pol, self.gen, dev),
                        mlp_weights(cri, self.gen, dev))
        load_mlp(tr.prio_policy_net.layers, self.weights[2])
        load_mlp(tr.prio_critic_net.mlp.layers, self.weights[3])
        self.slots = compact_slots(batch, p.is_challenging_initial_state_buffer)

    def iteration_draws(self):
        """Every draw of one iteration: the train cell's, with the action
        noise one block per turn [T, N, B, 2], the compacted spawn's rows
        in each step's reset draws where the batch compacts (B >= 1024),
        the scores' normals [T, B, N, 1] and the priority loss's entropy
        noise [E, n_mb, mb, N, 1]."""
        tr, p, g, dev = self.trainer, self.p, self.gen, self.dev
        cfg = tr.env.cfg
        T, B, N, E = p.max_steps, self.batch, cfg.n_agents, p.num_epochs
        M, n_mb = T * B, tr.n_minibatches
        return self.IterationDraws(
            action_noise=torch.randn((T, N, B, 2), generator=g, device=dev),
            reset_draws=D.reset_draws(self.ResetDraws, cfg, g, dev, self.slots, steps=T),
            permutations=torch.rand((E, M), generator=g, device=dev).argsort(-1),
            entropy_noise=torch.randn((E, n_mb, M // n_mb, N, 2), generator=g, device=dev),
            obs_noise=torch.rand((T, B, N, cfg.obs_dim), generator=g, device=dev),
            priority_noise=torch.randn((T, B, N, 1), generator=g, device=dev),
            priority_entropy_noise=torch.randn((E, n_mb, M // n_mb, N, 1), generator=g,
                                               device=dev),
        )

    def record_iteration(self):
        """`training.Trainer.record_iteration`, with the rank each sampled
        step's turns ran in kept in the record's `ranks` (the trainer's
        module's `prioritized_action_propagation` is wrapped for the
        iteration; `act` calls it once a step)."""
        mappo_cavs = importlib.import_module("sigmarl_tpu_torch.rl.mappo_cavs")
        fn, ranks, step = mappo_cavs.prioritized_action_propagation, {}, 0

        def capture(policy, base_obs, rank, *args, **kw):
            nonlocal step
            if step in self.sampled:
                ranks[step] = rank.clone()
            step += 1
            return fn(policy, base_obs, rank, *args, **kw)

        mappo_cavs.prioritized_action_propagation = capture
        try:
            m = super().record_iteration()
        finally:
            mappo_cavs.prioritized_action_propagation = fn
        self.records[-1]["ranks"] = ranks
        return m

    def shapes(self) -> dict:
        """The train cell's shapes and the priority networks'."""
        return {**super().shapes(), "prio_obs_dim": self.trainer.env.cfg.obs_dim,
                "prio_hidden": self.config["priority_policy"]["hidden"],
                "prio_critic_hidden": self.config["priority_critic"]["hidden"]}


def _head(out, act_dim: int, networks):
    """(loc, scale) of a policy's raw output, as the reference's
    `networks.PolicyNet` splits it."""
    scale = torch.clamp(torch.nn.functional.softplus(out[..., act_dim:]
                                                     + networks._SOFTPLUS_BIAS_1),
                        min=networks._SCALE_LB)
    return out[..., :act_dim], scale


class XPMARLReference(training.TrainReference):
    """The train cell's reference (env, GAE, optimizer) with the padded
    policy and critic, the priority actor and critic, the turns and the
    priority loss."""

    def __init__(self, config: dict, batch: int, dev, weights):
        super().__init__(config, batch, dev, weights)
        from benchmark.reference.rl import priority

        self.priority = priority
        cfg, nets = self.env.cfg, self.networks
        self.k = cfg.n_nearing_agents_observed
        obs_pad = cfg.obs_dim + 2 * self.k
        self.policy = nets.PolicyNet(obs_pad, 2, tuple(config["policy"]["hidden"]), device=dev)
        self.critic = nets.CentralizedCritic(obs_pad, cfg.n_agents,
                                             tuple(config["critic"]["hidden"]), device=dev)
        self.prio_policy = nets.PolicyNet(cfg.obs_dim, 1,
                                          tuple(config["priority_policy"]["hidden"]), device=dev)
        self.prio_critic = nets.CentralizedCritic(
            cfg.obs_dim, cfg.n_agents, tuple(config["priority_critic"]["hidden"]), device=dev)

    def params(self):
        return [t for net in (self.policy, self.critic, self.prio_policy, self.prio_critic)
                for t in net.parameters()]

    def load(self, rec):
        if "start" in rec:
            for layers, w in zip((self.policy.layers, self.critic.mlp.layers,
                                  self.prio_policy.layers, self.prio_critic.mlp.layers),
                                 self.weights):
                load_mlp(layers, w)
            return self.opt.init(self.params())
        return super().load(rec)

    def scores_out(self, obs, tf32=False):
        """(loc, scale) [..., N, 1] of the priority actor."""
        return _head(mlp_forward(self.prio_policy.layers, obs, tf32), 1, self.networks)

    def prio_values(self, obs, tf32=False):
        """[..., N, 1]: the priority critic's value, broadcast to every
        agent."""
        v = mlp_forward(self.prio_critic.mlp.layers, obs.reshape(obs.shape[:-2] + (-1,)), tf32)
        return v[..., None, :].expand(obs.shape[:-1] + (1,))

    def turn_policy(self, tf32=False):
        """The policy on one row per env [B, obs + 2k] -> (loc, scale)."""
        return lambda x: self.policy_out(x, tf32)

    @torch.no_grad()
    def acting(self, rec, t, scores, rank, actions):
        """What the reference computes at sampled step `t` from what the
        program (or a control) produced there: the scores and their
        log-probabilities from the step's observation, the rank of the
        given `scores`, and the turns in the given `rank` with the given
        decided `actions` (each agent's action, log-probability and acted-on
        observation)."""
        pr = self.priority
        obs = rec["batch"].prio_obs[t]
        draws = rec["draws"]
        loc, scale = self.scores_out(obs)
        s_r, slp_r = pr.score_sample(loc, scale, draws.priority_noise[t])
        state = rec["steps"][t][0]
        nbrs = pr.neighbours(state.d_agents, self.k)
        a_r, lp_r, used_r = pr.propagate(self.turn_policy(), pr.pad(obs, self.k), rank, nbrs,
                                         self.low, self.high, draws.action_noise[t], actions)
        return {"scores": (s_r, slp_r), "rank": pr.rank_agents(scores), "action": (a_r, lp_r),
                "obs_used": used_r}

    @torch.no_grad()
    def control_acting(self, rec, t):
        """The control's own acting at sampled step `t` (its scores, its
        rank and its turns in TF32 products, the outputs rounded to
        bfloat16), in the shape `program_outputs` gives the program's."""
        pr = self.priority
        obs = rec["batch"].prio_obs[t]
        draws = rec["draws"]
        loc, scale = self.scores_out(obs, tf32=True)
        s, slp = pr.score_sample(loc, scale, draws.priority_noise[t])
        rank = pr.rank_agents(s)
        nbrs = pr.neighbours(rec["steps"][t][0].d_agents, self.k)
        a, lp, used = pr.propagate(self.turn_policy(tf32=True), pr.pad(obs, self.k), rank, nbrs,
                                   self.low, self.high, draws.action_noise[t])
        low = lambda x: to_lower(x, torch.bfloat16)  # noqa: E731
        return {"scores": (low(s), low(slp)), "rank": rank, "action": (low(a), low(lp)),
                "obs_used": low(used)}

    def outputs(self, rec, variant=None):
        """What the reference computes from the record, as
        `training.TrainReference.outputs` has it: the start, the env step of
        each sampled step, GAE of both streams (adv, vt, prio_adv, prio_vt)
        and the first updates of the four networks; with `variant` "lower"
        also its own acting at each sampled step (`own`)."""
        tf32 = variant == "lower"
        draws, batch, data = rec["draws"], rec["batch"], rec["data"]
        state = self.load(rec)
        out = {"env": {}}
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
            if tf32:
                out["own"] = {t: self.control_acting(rec, t) for t in rec["steps"]}
            pr, g, lm = self.priority, self.cfg.gamma, self.cfg.lmbda
            v = self.values(batch.obs, tf32)[..., 0]
            nv = self.values(pr.pad(batch.next_obs, self.k), tf32)[..., 0]
            adv, vt = self.ppo.gae(batch.reward, v, nv, batch.done, g, lm)
            pv = self.prio_values(batch.prio_obs, tf32)[..., 0]
            pnv = self.prio_values(batch.next_obs, tf32)[..., 0]
            padv, pvt = pr.priority_gae(batch.reward, pv, pnv, batch.done, g, lm)
            out["gae"] = tuple(x.reshape(-1, x.shape[-1]) for x in (adv, vt, padv, pvt))

        params = self.params()
        n = rec["stats"][1].shape[1]
        n_mb = draws.entropy_noise.shape[1]
        mb_rows = data["action"].shape[0] // n_mb
        stats = []
        for m in range(n):
            e, k = divmod(m, n_mb)  # the m-th update: epoch e, minibatch k
            idx = draws.permutations[e][k * mb_rows:(k + 1) * mb_rows]
            noise, p_noise = draws.entropy_noise[e, k], draws.priority_entropy_noise[e, k]
            if variant == "half":
                idx, noise, p_noise = (idx[:mb_rows // 2], noise[:mb_rows // 2],
                                       p_noise[:mb_rows // 2])
            mb = {k: x[idx] for k, x in data.items()}
            loc, scale = self.policy_out(mb["obs"], tf32)
            val = self.values(mb["obs"], tf32)[..., 0]
            total, st = self.ppo.ppo_losses(loc, scale, val, mb["action"], mb["log_prob"],
                                            mb["adv"], mb["vt"], self.low, self.high, self.cfg,
                                            noise)
            p_loc, p_scale = self.scores_out(mb["prio_obs"], tf32)
            p_val = self.prio_values(mb["prio_obs"], tf32)[..., 0]
            p_total, _ = self.priority.priority_loss(
                p_loc, p_scale, p_val, mb["prio_scores"], mb["prio_log_prob"], mb["prio_adv"],
                mb["prio_vt"], self.cfg, p_noise)
            grads = torch.autograd.grad(total + p_total, params)
            stats.append(torch.stack([*(st[k].detach() for k in training.STATS),
                                      p_total.detach()]))
            state = self.opt.step(params, grads, state)
            if m == 0:
                out["mu1"] = training._clones(state.mu)
        out["stats"] = torch.stack(stats, 1)
        out["theta_n"] = training._clones(params)
        return out


def program_outputs(rec: dict) -> dict:
    """What the program produced, in the shape `judge` reads; a statistic
    the program did not report reads NaN (and fails `loss_gap`)."""
    batch, data = rec["batch"], rec["data"]
    keys, stats = rec["stats"]
    rows = [stats[keys.index(k)] if k in keys else torch.full_like(stats[0], float("nan"))
            for k in STATS]
    out = {
        "own": {t: {"scores": (batch.prio_scores[t], batch.prio_log_prob[t]),
                    "rank": rec["ranks"][t], "action": (batch.action[t], batch.log_prob[t]),
                    "obs_used": batch.obs[t]} for t in rec["steps"]},
        "env": {t: v[2:] for t, v in rec["steps"].items()},
        "gae": (data["adv"], data["vt"], data["prio_adv"], data["prio_vt"]),
        "stats": torch.stack(rows),
        "mu1": rec["mu1"],
        "theta_n": rec["theta_n"],
    }
    if "start" in rec:
        out["start"] = rec["start"][2:]
    return out


def judge(ref: XPMARLReference, ref_out: dict, prog: dict, rec: dict) -> list:
    """The compared numbers of one recorded iteration: the acting of each
    sampled step judged from `prog`'s own scores, rank and actions, then
    `training.judge`'s numbers."""
    score = tail = 0.0
    ranks = 0.0
    acting = {}
    for t, own in prog["own"].items():
        r = ref.acting(rec, t, own["scores"][0], own["rank"], own["action"][0])
        score = max(score, rel_gap(own["scores"][0], r["scores"][0]),
                    rel_gap(own["scores"][1], r["scores"][1]))
        ranks = max(ranks, float((own["rank"].long() != r["rank"]).any(-1).sum()))
        tail = max(tail, rel_gap(own["obs_used"], r["obs_used"]))
        acting[t] = r["action"]
    progs = dict(prog, acting={t: own["action"] for t, own in prog["own"].items()})
    return [("score_gap", score), ("rank_mismatch", ranks), ("obs_tail_gap", tail),
            *training.judge(dict(ref_out, acting=acting), progs, rec)]


def check(config: dict, batch: int, dev, weights, records: list, limits: dict,
          variant: str | None = None) -> list:
    """The Checks of the recorded iterations (the largest of each number
    over them); with `variant`, of that control or fault put in the
    program's place: "lower" (the reference in TF32 products and bfloat16
    outputs throughout, its own scores, rank and turns), "half" (each
    minibatch's two losses over half its rows), "altered" (the first
    sampled step's reward altered), "unchanged" (an update that leaves the
    parameters and moments as they were). A run that recorded fewer than
    the set-up's and the window's iteration fails."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = XPMARLReference(config, batch, dev, weights)
    out = []
    for rec in records:
        ref_out = ref.outputs(rec)
        prog = program_outputs(rec)
        if variant == "unchanged":
            prog = dict(prog, theta_n=rec["theta0"], mu1=rec["mu0"])
        elif variant is not None:
            prog = dict(prog, **ref.outputs(rec, variant))
        ref.load(rec)  # the acting is judged at the iteration's start
        out += [Check(n, v, limits[n]) for n, v in judge(ref, ref_out, prog, rec)]
    if len(records) < 2:
        out.append(Check("recorded_iterations", float(len(records)), -1.0))
    return worst(out)
