"""The port's paper drivers against the JAX package's, and the ITSC'24
observation switches, which no other test sets.

- The statistics helpers (`robust_stats`, `sobol_from_grid`) to 1e-12.
- The `Parameters` that each of the four training drivers builds (every
  training run, and the ITSC'24 ablation's testing env), equal key for key
  to JAX's (all but `device`). The trainers, the env and the rollout are
  replaced inside the test by stand-ins that record the parameters, in
  both packages, so that nothing trains here; the JAX package's files stay
  as they are. The ITSC'25, ECC'25 and LCSS'25 drivers' own runs are
  checked on the card by `chip_smoke.py`, and every driver's by the quick
  CLI runs on the CPU.
- The ITSC'24 observation switches, each off alone and M1 with M4:
  `observe_core` to atol 1e-5 (float32 features of the same state).
  (The CBF-filtered trainer iteration is held in
  `test_torch_filtered_training.py`.)"""

import dataclasses
import importlib
import json
import types

import numpy as np
import pytest
import torch

import jax

import sigmarl_tpu.config as jcfg
import sigmarl_tpu.env as jenv_mod
import sigmarl_tpu.rl as jrl
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.env.observations import observe_core as jax_observe_core
from sigmarl_tpu.env.structs import EnvConfig as JEnvConfig
from sigmarl_tpu.eval import papers as JP
from sigmarl_tpu_torch.env.observations import observe_core
from sigmarl_tpu_torch.env.structs import EnvConfig as TEnvConfig
from sigmarl_tpu_torch.eval import papers as TP
from tests.test_torch_training import BASE
from tests.torch_parity import envs, to_torch_state

torch.set_num_threads(1)
# The module, not the function that `sigmarl_tpu.eval` exports under its name.
jrollout_mod = importlib.import_module("sigmarl_tpu.eval.rollout")


def test_robust_stats_and_sobol_match_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(4, 5))
    z[1, 2] = np.nan
    for a, b in ((TP.robust_stats(z), JP.robust_stats(z)),
                 (TP.sobol_from_grid(z), JP.sobol_from_grid(z)),
                 (TP.sobol_from_grid(np.ones((2, 2))), JP.sobol_from_grid(np.ones((2, 2))))):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], rtol=1e-12)
    assert all(np.isnan(v) for v in TP.robust_stats(np.full(3, np.nan)).values())
    assert all(np.isnan(v) for v in TP.sobol_from_grid(np.full((2, 2), np.nan)).values())


def _record(T=2, B=1, N=4):
    return {"is_collision_with_agents": np.zeros((T, B, N), bool),
            "is_collision_with_lanelets": np.zeros((T, B, N), bool),
            "vel": np.ones((T, B, N, 2), np.float32), "distance_ref": np.zeros((T, B, N))}


@pytest.fixture
def captured(monkeypatch):
    """Stand-ins for the trainer, make_env and rollout of both packages;
    returns the lists the parameters go to: {"jax": [...], "port": [...]}."""
    seen = {"jax": [], "port": []}

    class Trainer:
        def __init__(self, p, *a, **k):
            seen[self.side].append(("train", p))
            self.policy_net = self.policy = None
            self._final_state = types.SimpleNamespace(policy_params=None)

        def train(self, progress_callback=None):
            if progress_callback:
                progress_callback(0, {"episode_reward_mean": 0.0})
            dm = types.SimpleNamespace(net=None, low=None, high=None)
            return None, dm, None, None, None, None

    def env_for(side):
        def make_env(p):
            seen[side].append(("test env", p))
            return types.SimpleNamespace(obs_dim=1, action_limits=np.ones(2), device="cpu")
        return make_env

    monkeypatch.setattr(jrl, "MAPPOCAVs", type("J", (Trainer,), {"side": "jax"}))
    monkeypatch.setattr(TP, "MAPPOCAVs", type("T", (Trainer,), {"side": "port"}))
    monkeypatch.setattr(jenv_mod, "make_env", env_for("jax"))
    monkeypatch.setattr(TP, "make_env", env_for("port"))
    monkeypatch.setattr(jrollout_mod, "rollout", lambda *a, **k: (_record(), {}))
    monkeypatch.setattr(TP, "rollout", lambda *a, **k: (_record(), {}))
    return seen


@pytest.mark.parametrize("name", ["itsc24", "icra25", "itsc26", "itsc26_robustness"])
@pytest.mark.parametrize("quick", [True, False])
def test_training_drivers_build_jax_parameters(name, quick, captured, tmp_path):
    out = str(tmp_path / name)
    JP.EXPERIMENTS[name](quick=quick, out_dir=out)
    TP.EXPERIMENTS[name](quick=quick, out_dir=out, device="cpu")
    jax_runs, port_runs = captured["jax"], captured["port"]
    assert len(port_runs) == len(jax_runs) > 0
    for (jwhat, jp), (twhat, tp) in zip(jax_runs, port_runs):
        assert jwhat == twhat and tp.device == "cpu"
        a, b = dataclasses.asdict(jp), dataclasses.asdict(tp)
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k != "device"} == \
               {k: v for k, v in b.items() if k != "device"}, name


def test_cli_writes_results(tmp_path, capsys):
    """`python -m sigmarl_tpu_torch.eval.papers lcss25 --quick --no_figures`
    on the CPU: results.json and one .npz record per grid, no figure."""
    out = tmp_path / "lcss"
    res = TP.main(["lcss25", "--quick", "--device", "cpu", "--no_figures", "--out_dir", str(out)])
    assert set(res) == {"deg1/taylor", "deg1/hocbf", "deg2/taylor", "deg2/hocbf"}
    assert json.loads((out / "results.json").read_text()).keys() == res.keys()
    assert len(list(out.glob("*.npz"))) == 4 and not list(out.glob("*.png"))
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(res))


SWITCHES = {
    "M1_bird_view": {"is_ego_view": False},
    "M2_no_vertices": {"is_observe_vertices": False},
    "M3_no_distances_agents": {"is_observe_distance_to_agents": False},
    "M4_boundary_points": {"is_observe_distance_to_boundaries": False},
    "M5_no_center_line_distance": {"is_observe_distance_to_center_line": False},
    "full_observation": {"is_partial_observation": False},
    "no_mask": {"is_apply_mask": False},
    "M1_and_M4": {"is_ego_view": False, "is_observe_distance_to_boundaries": False},
}


@pytest.fixture(scope="module")
def pair():
    """Both envs on cpm_mixed (N=4, B=4) and a JAX reset state."""
    jenv, tenv = envs(**{**BASE, "where_to_save": "unused/"})
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(2))
    return jenv, tenv, state


@pytest.mark.parametrize("design", list(SWITCHES))
def test_itsc24_observation_switches_match_jax(design, pair):
    jenv, tenv, state = pair
    kw = {**BASE, **SWITCHES[design], "where_to_save": "unused/"}
    derived = dict(has_lanelet_neighbors=tenv.cfg.has_lanelet_neighbors,
                   all_paths_loop=tenv.cfg.all_paths_loop)
    jc = dataclasses.replace(JEnvConfig.from_parameters(jcfg.Parameters(**kw)), **derived)
    tc = dataclasses.replace(TEnvConfig.from_parameters(tcfg.Parameters(**kw)), **derived)
    assert tc.obs_core_dim == jc.obs_core_dim
    ref = jax.jit(lambda s: jax_observe_core(jc, jenv.tables, s, jax.random.PRNGKey(0)))(state)
    ours = observe_core(tc, tenv.tables, to_torch_state(state))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)

