"""The CBF-filtered training iteration of a configuration (the
train_filtered cell): the train cell's trainer with the filter between the
policy and the env step, and its check against the reference.

The trainer, its draws and its recorded iterations are
`harness/training.py`'s, with two additions: the reset draws carry the
compacted spawn's uniforms where the batch compacts (B >= 1024), and each
sampled step also keeps the filter's output. The check follows each
sampled step from the program's own input state, as the rollout cell
does (`harness/mainpath.py`): the acting from the program's observation,
the filter from the program's action and warm start (the QP's objective,
the lane margins, the safe and the nominal action), the env step, with
the "cbf" reward's penalty on the filter's correction, from the action
the reference converts from the program's u*. GAE and the first updates
are judged as the train cell judges them (`training.check`), with each
sampled step's env step replayed from that same filtered input."""

from __future__ import annotations

import torch

from benchmark.harness import draws as D
from benchmark.harness import mainpath, training
from benchmark.harness.compare import Check, worst
from benchmark.harness.weights import load_mlp


def filter_budget(filt) -> dict:
    """The budget a filter (the port's or the reference's) solves at, in
    the configuration file's keys."""
    c = filt.cfg
    return {"n_circles": c.n_circles, "newton_iters": c.newton_iters,
            "newton_soft_iters": c.newton_soft_iters}


class FilteredTrainer(training.Trainer):
    """`training.Trainer` whose rollout filters every action. Set-up
    refuses a trainer that would not: the flags of a filtered rollout, the
    centralized and ungrouped filter, its budget equal to the
    configuration's `filter`, the filter's input without noise (the check
    replays it without). `unsolved` counts the env-steps whose filter fell
    back to the nominal action (on the device; read once per window)."""

    def __init__(self, config: dict, batch: int, seed: int, dev, sampled: int, updates: int,
                 iterations_below: int):
        super().__init__(config, batch, seed, dev, sampled, updates, iterations_below)
        from sigmarl_tpu_torch.env.reset import compact_slots

        p, filt = self.p, self.trainer.cbf_filter
        if not (p.is_using_cbf_training and p.is_solve_qp and p.is_apply_cbf_action
                and p.is_using_centralized_cbf and filt is not None):
            raise ValueError("the configuration's trainer does not filter its rollout's actions")
        if filt.decentralized or filt.grouped or filt.cfg.is_obs_noise:
            raise ValueError("the trainer's filter is not the centralized, ungrouped, "
                             "noise-free filter the check replays")
        if filter_budget(filt) != config["filter"]:
            raise ValueError(f"the trainer's filter solves at {filter_budget(filt)}, "
                             f"the configuration states {config['filter']}")
        self.slots = compact_slots(batch, p.is_challenging_initial_state_buffer)
        self.unsolved = torch.zeros((), device=dev)

    def iteration_draws(self):
        """`training.Trainer.iteration_draws` with the compacted spawn's
        rows in each step's reset draws."""
        draws = super().iteration_draws()
        if self.slots:
            cfg = self.trainer.env.cfg
            draws.reset_draws = D.reset_draws(self.ResetDraws, cfg, self.gen, self.dev,
                                              self.slots, steps=self.p.max_steps)
        return draws

    def _count(self, m: dict) -> dict:
        self.unsolved += (1.0 - m["cbf_solved_share"]) * (self.batch * self.p.max_steps)
        return m

    def iterate(self):
        return self._count(super().iterate())

    def record_iteration(self):
        """`training.Trainer.record_iteration`, with the filter's output of
        each sampled step kept in the record's `finfo` (the instance's
        `filter_actions` is wrapped for the iteration)."""
        filt = self.trainer.cbf_filter
        fn, finfo, step = filt.filter_actions, {}, 0

        def capture(*args, **kw):
            nonlocal step
            out = fn(*args, **kw)
            if step in self.sampled:
                finfo[step] = out._replace(**{k: v.clone() for k, v in out._asdict().items()})
            step += 1
            return out

        filt.filter_actions = capture
        try:
            m = super().record_iteration()
        finally:
            del filt.filter_actions
        self.records[-1]["finfo"] = finfo
        return self._count(m)

    def shapes(self) -> dict:
        """The train cell's shapes and the filter's: K1's budget and K2's
        chunks and segment table."""
        filt, env = self.trainer.cbf_filter, self.trainer.env
        budget = filter_budget(filt)
        return {**super().shapes(), "n_circles": budget["n_circles"],
                "newton_iters": budget["newton_iters"],
                "soft_iters": budget["newton_soft_iters"],
                "pd_chunks": filt.cfg.pd_topk_chunks,
                "segment_table": list(env.tables.left_seg.shape)}


class FilterReference(mainpath.Reference):
    """The rollout cell's reference (`mainpath.Reference`) with the
    trainer's filter, centralized and ungrouped at the configuration's
    budget; its policy takes a recorded iteration's weights (`load`)."""

    def __init__(self, config: dict, batch: int, dev, policy_weights):
        super().__init__(dict(config, filter={**config["filter"], "max_group_size": 0}), batch,
                         dev, policy_weights)

    def load(self, theta0) -> None:
        """The policy's layers from the trainer's parameters at an
        iteration's start (the policy's weights and biases come first)."""
        layers = self.policy.layers
        load_mlp(layers, [(theta0[2 * i], theta0[2 * i + 1]) for i in range(len(layers))])

    def step_input(self, state, action, u_star):
        """The env step's input of a filtered step, from the program's
        input state, action and u*: the state with the reference's clamp of
        the action as nominal, the reference's conversion of u* as applied,
        u* as the next warm start; and that applied action."""
        cbf = self.cbf
        st = D.convert(state, self.mods.structs.WorldState)
        nominal = cbf.rl_action_to_u(action, st.speed, st.steering)[0]
        applied = cbf.u_to_rl_action(u_star, st.speed, st.steering)
        return (self.mods.structs.replace_state(st, nominal_action=nominal,
                                                applied_action=applied, cbf_u_prev=u_star),
                applied)


def step_record(rec: dict, t: int) -> mainpath.Record:
    """Sampled step `t` of a recorded iteration as the rollout cell's
    `Record`: its input state, observation, action noise and reset draws,
    and what the program produced."""
    state, action, state_out, obs_out, reward, done = rec["steps"][t]
    draws = rec["draws"]
    return mainpath.Record(state, rec["batch"].obs[t], draws.action_noise[t],
                           draws.reset_draws[t], action, rec["finfo"][t], state_out, obs_out,
                           reward, done)


def check(config: dict, batch: int, dev, weights, records: list, limits: dict,
          variant: str | None = None) -> list:
    """The Checks of the recorded iterations (the largest of each number
    over them): each sampled step's acting, filter and env step as
    `mainpath.Reference.judge` has them, then `training.check` of the
    records whose sampled steps hold the reference's filtered input to the
    env step. `variant` as in `training.check`; under "lower" the filter's
    and the env step's control too (`mainpath.Reference.outputs`), under the
    others the program's filter output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = FilterReference(config, batch, dev, weights[0])
    out, replayed = [], []
    for rec in records:
        ref.load(rec["theta0"])
        steps = {}
        for t in rec["steps"]:
            r = step_record(rec, t)
            if variant == "lower":
                act, finfo, env_out = ref.outputs(r, lower=True)
            else:
                act, finfo, env_out = r.action, r.finfo, (r.state_out, r.obs_out, r.reward,
                                                          r.done)
            out += [Check(n, v, limits[n]) for n, v in ref.judge(r, act, finfo, env_out)]
            steps[t] = (*ref.step_input(r.state, r.action, r.finfo.u_star), *rec["steps"][t][2:])
        replayed.append(dict(rec, steps=steps))
    del ref
    return worst(out + training.check(config, batch, dev, weights, replayed, limits, variant))
