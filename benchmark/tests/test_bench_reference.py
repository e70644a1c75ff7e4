"""The reference agrees with the port at a small size on the CPU, where
the port runs its kernels' plain versions: the policy, the filter, the
env step with resets, GAE and the first updates."""

from __future__ import annotations

import json
import os

import torch

from benchmark.harness import draws as D
from benchmark.harness import mainpath, training
from benchmark.harness.compare import state_gap
from benchmark.run import HERE


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_main_path_reference_follows_the_port_step_for_step():
    cfg = config("cpm_entire_n15")
    cfg["parameters"]["n_agents"] = 4
    dev = torch.device("cpu")
    mp = mainpath.MainPath(cfg, 4, 11, dev)
    mp.start_zero()
    for _ in range(6):  # the first resets every env, later ones some
        mp.step(record=True)
    ref = mainpath.Reference(cfg, 4, dev, mp.weights)
    for rec in mp.records:
        act, finfo, (s, o, r, d) = ref.outputs(rec)
        assert torch.equal(act, rec.action)
        assert torch.equal(finfo.u_star, rec.finfo.u_star)
        assert torch.equal(finfo.safe_actions, rec.finfo.safe_actions)
        assert torch.equal(finfo.nominal_actions, rec.finfo.nominal_actions)
        assert torch.equal(finfo.rew_near_left_lane, rec.finfo.rew_near_left_lane)
        assert state_gap(rec.state_out, s)[0] == 0.0
        assert torch.equal(o, rec.obs_out) and torch.equal(r, rec.reward)
        assert torch.equal(d, rec.done)


def test_training_reference_follows_the_port():
    """The set-up's iteration from the seed's weights, and a later one
    from the program's parameters, moments and update count."""
    cfg = config("cpm_mixed_n4")
    cfg["parameters"].update(max_steps=8, num_epochs=2, minibatch_size=16)
    dev = torch.device("cpu")
    tr = training.Trainer(cfg, 4, 12, dev, sampled=3, updates=3, iterations_below=1)
    tr.first_iteration()
    tr.iterate()
    tr.record_iteration()
    assert tr.records[1]["count"] == 2 * tr.trainer.updates_per_iter
    ref = training.TrainReference(cfg, 4, dev, tr.weights)
    for rec in tr.records:
        out = ref.outputs(rec)
        prog = training.program_outputs(rec)
        for t, (a, lp) in out["acting"].items():
            assert torch.equal(a, prog["acting"][t][0]) and torch.equal(lp, prog["acting"][t][1])
        for p, r in zip(prog["gae"], out["gae"]):
            assert torch.equal(p, r)
        assert torch.allclose(prog["stats"], out["stats"], rtol=1e-6, atol=1e-7)
        for p, r in zip(prog["theta_n"], out["theta_n"]):
            assert torch.allclose(p, r, rtol=1e-6, atol=1e-8)
        checks = {n: v for n, v in training.judge(out, prog, rec)}
        assert max(checks.values()) < 1e-6


def test_draws_cover_both_reset_branches():
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import EnvConfig
    from sigmarl_tpu_torch.config import Parameters

    cfg = EnvConfig.from_parameters(Parameters(scenario_type="cpm_mixed", n_agents=4,
                                               num_vmas_envs=8))
    g = torch.Generator().manual_seed(1)
    d = D.reset_draws(ResetDraws, cfg, g, torch.device("cpu"), 3)
    assert d.path_u.shape == (8, 4, cfg.max_spawn_tries)
    assert d.path_u_c.shape == (3, 4, cfg.max_spawn_tries)
    assert d.scenario_gumbel.shape == (8, 3) and d.speed_u.shape == (8, 4)
    steps = D.reset_draws(ResetDraws, cfg, g, torch.device("cpu"), 0, steps=5)
    assert len(steps) == 5 and steps[0].path_u_c is None
