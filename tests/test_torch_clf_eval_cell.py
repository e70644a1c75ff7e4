"""`main_eval`'s recorded CBF-filter evaluation as the benchmark runs it
(`cpm_entire_n15_clf_eval.eval_recorded`, `benchmark/configs/
cpm_entire_n15_clf_eval.json`) on the CPU at N=4, B=8: what `main_eval.build`
builds is the configuration's evaluation; its recorded rollout (CLF
nominal, testing mode, two chunks of 4 steps, every draw from a seeded
generator) is the benchmark's plain reference step by step and record by
record, an episode's end and agents reset alone included; each chunk's
record opens `eval.record` once with the one counted sync, and
`env_step.reset.envs` counts the resetting envs."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import clf_eval
from benchmark.harness import draws as D
from sigmarl_tpu_torch import main_eval, trace
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.eval.rollout import StepDraws, rollout

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, STEPS, CHUNK = 8, 4, 8, 4
# an episode of 6 steps: every env ends it at the rollout's step 4
MAX_STEPS = 6


def config(**parameters):
    with open(os.path.join(ROOT, "benchmark", "configs", "cpm_entire_n15_clf_eval.json")) as f:
        cfg = json.load(f)
    cfg["parameters"].update(n_agents=N, max_steps=MAX_STEPS, **parameters)
    return cfg


def program(cfg):
    env, cbf, policy = main_eval.build(clf_eval.main_eval_args(cfg, B, torch.device("cpu")))
    clf_eval.held(cfg, env, cbf)
    return env, cbf, policy


def seeded_draws(cfg_env, seed=2):
    gen = torch.Generator().manual_seed(seed)
    start = D.reset_draws(ResetDraws, cfg_env, gen, torch.device("cpu"), 0)
    steps = [StepDraws(reset=d) for d in
             D.reset_draws(ResetDraws, cfg_env, gen, torch.device("cpu"), 0, steps=STEPS)]
    return start, steps


@pytest.fixture(scope="module")
def recorded():
    """The program's recorded evaluation, and the counts it made."""
    cfg = config()
    env, cbf, policy = program(cfg)
    start, steps = seeded_draws(env.cfg)
    trace.reset()
    trace.enable()
    real = trace.count_sync
    trace.count_sync = lambda device, n=1: trace.count(trace.SYNCS, n)  # count the CPU's too
    try:
        record, _ = rollout(env, policy, STEPS, cbf=cbf, chunk=CHUNK, draws=steps,
                            reset_draws=start)
    finally:
        trace.count_sync = real
        trace.disable()
    return cfg, start, steps, record, trace.snapshot()


def test_main_eval_builds_the_configurations_evaluation():
    cfg = config()
    clf_eval.refuse(cfg)
    env, cbf, _ = program(cfg)
    assert env.cfg.is_testing_mode and cbf.cfg.nom_controller_type == "clf"
    assert (cbf.cfg.newton_soft_iters, cbf.cfg.newton_iters) == (2, 15)
    for bad in ({"parameters": {"nom_controller_type": "rl"}},
                {"parameters": {"is_testing_mode": False}},
                {"filter": {"newton_iters": 5}}, {"filter": {"max_group_size": 4}}):
        wrong = config()
        for part, values in bad.items():
            wrong[part].update(values)
        with pytest.raises(ValueError):
            clf_eval.refuse(wrong)


def test_the_recorded_evaluation_is_the_references_step_by_step(recorded):
    """The reference's testing-mode env and CLF filter from the same start
    and draws, stepped on their own: every step's record is the program's,
    bit for bit. The run holds agents reset alone and an episode's end."""
    cfg, start, steps, record, _ = recorded
    assert set(record) == set(clf_eval.RECORD_KEYS)
    ref = clf_eval.EvalReference(cfg, B, torch.device("cpu"))
    mods = ref.mods
    state, _ = ref.env.reset(draws=D.convert(start, mods.reset.ResetDraws))
    act = torch.zeros((B, N, 2))
    act[..., 0] = 0.5
    for t in range(STEPS):
        finfo = ref.cbf.filter_actions(state, act, u_init=state.cbf_u_prev)
        mid = mods.structs.replace_state(state, nominal_action=finfo.nominal_actions,
                                         applied_action=finfo.safe_actions,
                                         cbf_u_prev=finfo.u_star)
        state, _, reward, done, info = ref.env.step(
            mid, finfo.safe_actions, reset_draws=D.convert(steps[t].reset, mods.reset.ResetDraws))
        want = dict(info, cbf_solved=finfo.solved, cbf_infeasible=finfo.infeasible,
                    cbf_max_violation=finfo.max_violation, reward=reward, done=done)
        for k in clf_eval.RECORD_KEYS:
            np.testing.assert_array_equal(record[k][t], want[k].numpy(), err_msg=f"{k} at {t}")
    done = record["done"]
    assert done[MAX_STEPS - 2].all() and not np.delete(done, MAX_STEPS - 2, axis=0).any()
    alone = (record["is_collision_with_agents"] | record["is_collision_with_lanelets"]).any(-1)
    assert (alone & ~done).any()


def test_each_chunk_records_once_with_one_counted_sync(recorded):
    """`eval.record` opens once per chunk and holds one sync (its
    synchronise) and the chunk's bytes; the env steps hold one sync each
    (the read of the resetting envs), and `env_step.reset.envs` adds up
    the envs that reset: those with an agent that collided, every env at
    the episode's end."""
    _, _, _, record, snap = recorded
    spans = snap["spans"]
    rec = spans["eval.record"]
    assert rec["calls"] == STEPS // CHUNK and rec["counts"]["syncs"] == STEPS // CHUNK
    assert rec["counts"]["eval.record.bytes"] == sum(v.nbytes for v in record.values())
    assert spans["eval.rollout"]["calls"] == 1
    assert spans["env_step.done"]["counts"]["syncs"] == STEPS
    collided = (record["is_collision_with_agents"] | record["is_collision_with_lanelets"]
                | record["is_reach_goal"]).any(-1)
    resetting = int((collided | record["done"]).sum())
    assert resetting > 0
    assert spans["env_step.done"]["counts"]["env_step.reset.envs"] == resetting
    assert snap["counts"]["env_step.reset.envs"] == resetting
