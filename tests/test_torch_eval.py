"""The port's evaluation layer against the JAX package: the scripted
controllers, the goal-reaching state, the metrics, a recorded rollout from
the same weights and draws, `Evaluation` and `main_testing` on a model
directory written by the JAX package, and the `main_eval`,
`main_eval_parallel`, `at25` and `td_tools` entry points on the CPU
(`--save_video` included, read back with OpenCV).

Tolerances: controllers and goal-reaching state to atol 1e-6 (the same
float32 formulas); metrics exactly (the port's numpy copy on the same
record); the rollout's records as the env step's (positions 2e-5,
rewards 2e-5, actions 1e-5), flags and path ids exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu.config as jcfg
from sigmarl_tpu.core import controllers as JC
from sigmarl_tpu.env import goal_reaching as JG
from sigmarl_tpu.eval import metrics as JM
from sigmarl_tpu.eval.rollout import rollout as jax_rollout
from sigmarl_tpu.rl.checkpoint import RewardKeyedCheckpointer
from sigmarl_tpu.rl.networks import PolicyNet as JPolicyNet
from sigmarl_tpu.rl.networks import tanh_normal_sample as jax_sample
from sigmarl_tpu_torch import main_eval, main_eval_parallel, main_testing
from sigmarl_tpu_torch.core import controllers as TC
from sigmarl_tpu_torch.env import goal_reaching as TG
from sigmarl_tpu_torch.eval import at25, td_tools
from sigmarl_tpu_torch.eval import metrics as TM
from sigmarl_tpu_torch.eval.evaluation_base import Evaluation
from sigmarl_tpu_torch.eval.rollout import _RECORD_KEYS, StepDraws, checkpoint_policy, rollout
from tests.torch_parity import env_reset_draws, envs, params, step_reset_draws

torch.set_num_threads(1)
B, N = 4, 4


def t(x):
    return torch.from_numpy(np.array(x))


def test_controllers_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 4, (B, N, 2)).astype(np.float32)
    rot = rng.uniform(-3, 3, (B, N)).astype(np.float32)
    target = rng.uniform(0, 4, (B, N, 2)).astype(np.float32)
    short = rng.uniform(0, 4, (B, N, 5, 2)).astype(np.float32)
    err = rng.normal(size=(B, N)).astype(np.float32)
    np.testing.assert_allclose(TC.target_following(t(pos), t(rot), t(target), 0.7, 0.5).numpy(),
                               np.asarray(JC.target_following(pos, rot, target, 0.7, 0.5)), atol=1e-6)
    np.testing.assert_allclose(
        TC.pure_pursuit_on_short_term(t(pos), t(rot), t(short), 0.7, 0.5, 2).numpy(),
        np.asarray(JC.pure_pursuit_on_short_term(pos, rot, short, 0.7, 0.5, 2)), atol=1e-6)
    np.testing.assert_array_equal(TC.constant_controller((B, N), 0.5, 0.1).numpy(),
                                  np.asarray(JC.constant_controller((B, N), 0.5, 0.1)))
    js, ts = JC.pid_init((B, N)), TC.pid_init((B, N))
    for k in range(3):
        jo, js = JC.pid_step(js, err * (k + 1), 1.0, 0.5, 0.1, 0.1)
        to, ts = TC.pid_step(ts, t(err * (k + 1)), 1.0, 0.5, 0.1, 0.1)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)


def test_goal_reaching_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 4, (B, 1, 2)).astype(np.float32)
    rot = rng.uniform(-3, 3, (B, 1)).astype(np.float32)
    goal = rng.uniform(0, 4, (B, 1, 2)).astype(np.float32)
    js, ts = JG.init_goal_reaching(pos, rot, goal), TG.init_goal_reaching(t(pos), t(rot), t(goal))
    pos2 = pos + 0.3
    js, ts = JG.update_goal_reaching(js, pos2, rot + 0.1), TG.update_goal_reaching(ts, t(pos2), t(rot + 0.1))
    for f in JG.GoalReachingState._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(TG.goal_reached(ts, 1.0).numpy(),
                                  np.asarray(JG.goal_reached(js, 1.0)))


def _record(rng, T=40):
    return {
        "pos": np.cumsum(rng.uniform(0, 0.05, (T, B, N, 2)), 0).astype(np.float32),
        "vel": rng.normal(size=(T, B, N, 2)).astype(np.float32),
        "distance_ref": rng.uniform(0, 0.1, (T, B, N)).astype(np.float32),
        "is_collision_with_agents": rng.uniform(size=(T, B, N)) < 0.3,
        "is_collision_with_lanelets": rng.uniform(size=(T, B, N)) < 0.2,
        "cbf_infeasible": rng.uniform(size=(T, B)) < 0.1,
        "cbf_solved": rng.uniform(size=(T, B)) < 0.95,
    }


def test_metrics_match_jax():
    rec = _record(np.random.default_rng(2))
    assert TM.basic_metrics(rec) == JM.basic_metrics(rec)
    coll = rec["is_collision_with_agents"]
    np.testing.assert_array_equal(TM.debounced_collision_events(coll, 2, 4),
                                  JM.debounced_collision_events(coll, 2, 4))
    assert TM.collisions_per_100m(rec) == JM.collisions_per_100m(rec)
    x = np.random.default_rng(3).normal(size=17)
    assert TM.iqm(x) == JM.iqm(x) and TM.ci95(x) == JM.ci95(x)


@pytest.fixture(scope="module")
def jax_policy_params():
    net = JPolicyNet()
    obs_dim = envs(**params("cpm_mixed", N, B, is_testing_mode=True))[0].obs_dim
    return jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(0), jnp.zeros((1, N, obs_dim))))


def test_recorded_rollout_matches_jax(jax_policy_params):
    """8 testing-mode steps in chunks of 4 with the same policy weights and
    every random number of JAX's key schedule (reset, action noise, the env
    steps' resets): the same record keys and shapes, the same values."""
    jenv, tenv = envs(**params("cpm_mixed", N, B, is_testing_mode=True))
    net = JPolicyNet()
    low, high = -jenv.action_limits, jenv.action_limits

    def jpolicy(obs, key):
        loc, scale = net.apply(jax_policy_params, obs)
        return jax_sample(key, loc, scale, low, high)[0]

    key = jax.random.PRNGKey(7)
    T, chunk = 8, 4
    jrec, jtimes = jax_rollout(jenv, jpolicy, T, key, chunk=chunk)

    k_reset, key2 = jax.random.split(key)
    draws = []
    for c0 in range(0, T, chunk):
        for k in jax.random.split(jax.random.fold_in(key2, T - c0), chunk):
            k_act, _, k_env = jax.random.split(k, 3)
            draws.append(StepDraws(action_noise=t(jax.random.normal(k_act, (B, N, 2))),
                                   reset=step_reset_draws(k_env, jenv.cfg)))
    trec, ttimes = rollout(tenv, checkpoint_policy(jax_policy_params, tenv), T, chunk=chunk,
                           draws=draws,
                           reset_draws=env_reset_draws(k_reset, jenv.cfg))
    assert set(trec) == set(jrec) and set(ttimes) == set(jtimes)
    for k, v in jrec.items():
        assert trec[k].shape == v.shape and trec[k].dtype == v.dtype, k
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(trec[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(trec[k], v, atol=2e-5, rtol=1e-5, err_msg=k)
    assert TM.basic_metrics(trec).keys() == JM.basic_metrics(jrec).keys()


def test_filtered_rollout_records_the_filter():
    """A CLF-filtered rollout (`main_eval`'s setting) records every key of
    `_RECORD_KEYS` with [T, B, ...] shapes, and its metrics carry the QP
    rates."""
    args = main_eval.parse_args(["--device", "cpu", "--num_envs", str(B), "--max_steps", "6"])
    result, rec, env, cbf = main_eval.evaluate(args)
    assert set(rec) == set(_RECORD_KEYS) | {"reward", "done"}
    assert rec["pos"].shape == (6, B, N, 2) and rec["cbf_solved"].shape == (6, B)
    assert rec["cbf_solved"].all() and np.isfinite(rec["reward"]).all()
    assert {"qp_infeasibility_rate", "qp_unsolved_rate", "collisions_per_100m"} <= set(result)
    assert cbf.cfg.nom_controller_type == "clf" and cbf.cfg.use_windowed_pseudo_distance


@pytest.fixture
def jax_model_dir(tmp_path, jax_policy_params):
    """A model directory as the JAX package's trainer writes it."""
    p = jcfg.Parameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B, dt=0.1,
                        is_use_mtv_distance=False, where_to_save=str(tmp_path) + "/",
                        model_name="jax_model")
    ck = RewardKeyedCheckpointer(p)
    assert ck.maybe_save(1.5, {"policy": jax_policy_params, "critic": jax_policy_params}, [1.5])
    return os.path.join(str(tmp_path), "jax_model")


def _video_frames(path):
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def _expected_keys(record):
    return set(JM.basic_metrics(record)) | {"collisions_per_100m"} | {
        "timing_steps_per_s", "timing_wall_time_s", "timing_time_per_step_ms"}


def test_main_testing_on_a_jax_checkpoint(jax_model_dir, capsys):
    result = main_testing.main([jax_model_dir, "--device", "cpu", "--max_steps", "6",
                                "--num_envs", str(B), "--deterministic"])
    rec = dict(np.load(os.path.join(jax_model_dir, "out_td_seed0.npz")))
    assert set(result) == _expected_keys(rec)
    assert result["collision_rate_total"] == JM.basic_metrics(rec)["collision_rate_total"]
    assert rec["pos"].shape == (6, B, N, 2)
    assert json.loads(capsys.readouterr().out.split("\nrollout record")[0]) == result
    # --save_video renders env 0 of the record (one frame per step).
    main_testing.main([jax_model_dir, "--device", "cpu", "--max_steps", "3", "--num_envs", "2",
                       "--save_video"])
    assert _video_frames(os.path.join(jax_model_dir, "video_seed0.mp4")) == 3


def test_evaluation_on_a_jax_checkpoint(jax_model_dir, tmp_path):
    """Two seeds of a JAX-written model: mean, IQM and CI95 of every metric;
    a second evaluation reads the cached records."""
    ev = Evaluation([jax_model_dir], n_sims=B, max_steps=5, device="cpu",
                    where_to_save_eva_results=str(tmp_path / "eva"))
    res = ev.run_evaluation(seeds=[0, 1])[jax_model_dir]
    rec = dict(np.load(tmp_path / "eva" / "jax_model_seed0.npz"))
    base = _expected_keys(rec) | {"episode_reward_final"}
    assert set(res) == base | {k + s for k in base for s in ("_iqm", "_ci95")}
    assert res["episode_reward_final"] == 1.5
    again = Evaluation([jax_model_dir], n_sims=B, max_steps=5, device="cpu",
                       where_to_save_eva_results=str(tmp_path / "eva")).evaluate_model(jax_model_dir)
    assert again["collision_rate_total"] == TM.basic_metrics(rec)["collision_rate_total"]


def test_main_eval_and_td_tools(tmp_path):
    out = str(tmp_path / "ev")
    result = main_eval.main(["--device", "cpu", "--num_envs", "2", "--max_steps", "4",
                             "--n_agents", "1", "--n_circles", "2", "--out_dir", out])
    files = sorted(os.listdir(out))
    assert files == ["computation_t_cpm_mixed_n1_c2_clf_cbf_s0.json",
                     "out_td_cpm_mixed_n1_c2_clf_cbf_s0.npz"]
    (res,) = td_tools.analyze_dir(out)
    assert res["n_agents"] == "1" and res["nom"] == "clf" and res["cbf"] == "cbf"
    assert res["timing_steps_per_s"] == result["timing_steps_per_s"]
    assert td_tools.parse_tag("x/out_td_intersection_1_n4_c3_rl_nocbf_s2.npz")["scenario"] == \
        "intersection_1"
    # --save_video renders env 0 of the record, action arrows included.
    main_eval.main(["--device", "cpu", "--num_envs", "2", "--max_steps", "3", "--n_agents", "1",
                    "--n_circles", "2", "--out_dir", out, "--save_video"])
    assert _video_frames(os.path.join(out, "video_cpm_mixed_n1_c2_clf_cbf_s0.mp4")) == 3


def test_main_eval_parallel_runs_the_grid(tmp_path):
    """The launcher runs `python -m sigmarl_tpu_torch.main_eval` once per
    cell (here one seed, CBF on and off) and succeeds."""
    out = str(tmp_path / "par")
    args = ["--n_seeds", "1", "--sweep_cbf", "--num_envs", "2", "--max_steps", "3",
            "--out_dir", out, "--device", "cpu"]
    grid = main_eval_parallel.build_grid(main_eval_parallel.argparse.Namespace(
        n_seeds=1, scenarios=["cpm_mixed"], n_agents=4, num_envs=2, max_steps=3, sweep_cbf=True,
        jobs=1, out_dir=out, device="cpu"))
    assert [c[1:3] for c in grid] == [["-m", "sigmarl_tpu_torch.main_eval"]] * 2
    assert "--no_cbf" in grid[0] and "--no_cbf" not in grid[1]
    assert main_eval_parallel.main(args) == 0
    assert len([f for f in os.listdir(out) if f.startswith("out_td_")]) == 2


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_main_eval_parallel_keeps_the_device(device):
    """With --jobs 2 every run of the grid goes to the device the caller
    gave (the card's processes share it); the CPU only when asked for."""
    grid = main_eval_parallel.build_grid(main_eval_parallel.argparse.Namespace(
        n_seeds=2, scenarios=["cpm_mixed"], n_agents=4, num_envs=2, max_steps=3, sweep_cbf=True,
        jobs=2, out_dir="unused", device=device))
    assert len(grid) == 4
    assert all(c[c.index("--device") + 1] == device for c in grid)


def test_at25_from_predefined_poses():
    """The scripted AT25 run from `default_poses` through `reset_predefined`
    (16 steps, 4 agents): the JAX function's result keys, finite values."""
    res = at25.run_model(None, n_agents=4, max_steps=16, device="cpu")
    rec_keys = set(JM.basic_metrics({"is_collision_with_agents": np.zeros((2, 1, 4), bool),
                                     "is_collision_with_lanelets": np.zeros((2, 1, 4), bool),
                                     "vel": np.zeros((2, 1, 4, 2)),
                                     "distance_ref": np.zeros((2, 1, 4))}))
    assert set(res) == rec_keys | {
        "agent_collision_events_per_100m", "boundary_collision_events_per_100m",
        "distance_driven_m", "timing_steps_per_s", "timing_wall_time_s", "timing_time_per_step_ms"}
    assert all(np.isfinite(v) for v in res.values()) and res["distance_driven_m"] > 0
    agg = at25.aggregate([res, res])
    assert agg["average_speed"]["mean"] == res["average_speed"]
