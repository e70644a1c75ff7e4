"""Closed loop of grouped CBF-filtered rollout steps at a fixed batch: the
main path with upstream's grouped filter (agents grouped by position into
groups of at most `max_group_size`; a pair inside a group keeps its
coupled rows, a pair across groups is split into one row per side).

The rollout cell's driver (`drivers/rollout.py`) with the configuration's
`filter` taking the traffic's `max_group_size`, so that the program and
the reference both build the grouped filter. The check is the rollout
cell's, with each step's QP objective judged on the grouped QP the filter
solved (the agents grouped from the step's input state)."""

from __future__ import annotations

from benchmark.drivers import rollout
from benchmark.harness import mainpath
from benchmark.harness.compare import Check, worst


class GroupedReference(mainpath.Reference):
    """The rollout cell's reference whose `assemble`, called without the
    groups (as the judge of the QP objective calls it), groups the agents
    of the given state as its filter does."""

    def __init__(self, config: dict, batch: int, dev, weights):
        super().__init__(config, batch, dev, weights)
        from benchmark.reference.safety.grouping import group_agents_k_nearest

        cbf = self.cbf
        assemble, size = cbf.assemble, cbf.max_group_size

        def grouped(state, rl_actions, group_id=None, *args, **kw):
            if group_id is None:
                group_id = group_agents_k_nearest(state.pos, size)
            return assemble(state, rl_actions, group_id, *args, **kw)

        cbf.assemble = grouped


def check(config: dict, batch: int, dev, weights, records, limits: dict, control=None,
          start=None) -> list:
    """`mainpath.check` with the grouped reference."""
    if control not in (None, False, True):
        raise ValueError(f"the main path has no variant {control!r}")
    ref = GroupedReference(config, batch, dev, weights)
    out = []
    if start is not None:
        out.append(Check("env_gap", mainpath.start_gap(ref, start, bool(control)),
                         limits["env_gap"]))
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


class Driver(rollout.Driver):

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        config = dict(config, filter={**config["filter"],
                                      "max_group_size": traffic["max_group_size"]})
        super().__init__(config, traffic, limits, seed, dev)

    def check(self, control: bool = False) -> list:
        return check(self.config, self.batch, self.dev, self.weights, self.mp.records,
                     self.limits, control, self.mp.start)
