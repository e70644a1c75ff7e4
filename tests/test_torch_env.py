"""The port's environment (reset and step) against the JAX package from
identical states with the JAX package's random draws, plus the port's
package rules: it imports nothing of JAX, and its entry points refuse to
run on the CPU unless asked to.

Tolerances: float32 state fields that come from the same formulas agree to
atol 2e-5 (reassociated sums, trigonometric library differences of an ulp
or two); observations to 1e-4 (normalised features built from those
fields); integer fields and flags exactly."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu_torch.env.structs import WorldState
from tests.torch_parity import env_reset_draws, envs, params, step_reset_draws, to_numpy, to_torch_state

torch.set_num_threads(1)
B, N = 4, 15
# Env options that once raised and are ported now.
PORTED_ENV_OPTIONS = {
    "n_observed_steps", "is_use_mtv_distance", "is_obs_noise", "is_using_opponent_modeling",
    "is_using_prioritized_marl", "is_testing_mode", "experiment_type",
    "is_challenging_initial_state_buffer",
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_state_close(ts: WorldState, js, atol=2e-5, skip=()):
    for f in dataclasses.fields(WorldState):
        if f.name in skip:
            continue
        a, b = to_numpy(getattr(ts, f.name)), np.asarray(getattr(js, f.name))
        assert a.shape == b.shape, f.name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.fixture(scope="module")
def pair():
    return envs(**params("cpm_entire", N, B))


def test_reset_matches_jax(pair):
    jenv, tenv = pair
    key = jax.random.PRNGKey(3)
    js, jobs = jax.jit(jenv.reset)(key)
    ts, tobs = tenv.reset(draws=env_reset_draws(key, jenv.cfg))
    assert_state_close(ts, js)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize(
    "rew_method, with_reset", [("distance", False), ("distance", True), ("ttc", False)]
)
def test_step_matches_jax(pair, rew_method, with_reset):
    """From a live state (reset, then 3 random steps in JAX), one step in
    both with the same actions and reset draws: state, obs, reward, done.
    Envs that collide end and reset; `with_reset` also lowers max_steps so
    that the oldest envs surely end at this step and the masked reset runs
    on the JAX draws. "ttc" swaps the distance penalty for the
    time-to-collision one."""
    jenv, tenv = pair
    key = jax.random.PRNGKey(7)
    state, _ = jax.jit(jenv.reset)(key)
    jstep = jax.jit(jenv.step)
    for t in range(3):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, t))
        act = jax.random.uniform(k_act, (B, N, 2), minval=-0.2, maxval=0.8)
        state, *_ = jstep(state, act, k_step)
    if with_reset or rew_method != "distance":
        max_steps = int(np.asarray(state.step).max()) + 2 if with_reset else 1_000_000
        jenv, tenv = envs(**params("cpm_entire", N, B, max_steps=max_steps, rew_method=rew_method))
        jstep = jax.jit(jenv.step)
    act = jax.random.uniform(jax.random.PRNGKey(11), (B, N, 2), minval=-0.2, maxval=0.8)
    k_step = jax.random.PRNGKey(12)
    ts0 = to_torch_state(state)
    js, jobs, jrew, jdone, _ = jstep(state, act, k_step)
    ts, tobs, trew, tdone, _ = tenv.step(
        ts0, torch.from_numpy(np.asarray(act)), reset_draws=step_reset_draws(k_step, jenv.cfg)
    )
    assert bool(np.asarray(jdone).any()) or not with_reset
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    assert_state_close(ts, js)


def test_package_imports_no_jax():
    """Importing every module of the port leaves no JAX, flax or optax and
    no module of the JAX package in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sigmarl_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'optax') or n.startswith(('jax.', 'jaxlib', 'flax', 'optax.'))\n"
        "             or n == 'sigmarl_tpu' or n.startswith('sigmarl_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('sigmarl_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 20


def _imported_roots(path: str) -> set:
    """The top-level names of every module a file imports, in functions
    too (relative imports stay inside the package and count as none)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_imports_neither_the_card_runner_nor_the_benchmark():
    """The arrows point one way: no module of the port imports the root
    script `chip_smoke.py` or `benchmark/`, and no script or port test
    imports `chip_smoke.py` (a runner, not a library)."""
    pkg = os.path.join(REPO, "sigmarl_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    users = sorted(glob.glob(os.path.join(REPO, "scripts", "*.py"))
                   + glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    assert len(files) > 20 and len(users) > 20
    bad = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & names)
           for names, group in (({"chip_smoke", "benchmark"}, files), ({"chip_smoke"}, users))
           for f in group}
    assert not {f: n for f, n in bad.items() if n}


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, PolicyNet, make_env
    from sigmarl_tpu_torch.rl.networks import policy_from_jax_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tcfg.Parameters(**params("cpm_entire", N, B))
    assert p.device == "cuda"
    shipped = os.path.join(REPO, "sigmarl_tpu_torch", "config.json")
    assert tcfg.Parameters.from_json(shipped).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env(p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyNet(32)
    tenv = make_env(p, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CBFSafetyFilter(CBFConfig(n_agents=N), tenv.cfg, tenv.tables)
    params_np = {"params": {"MLP_0": {
        f"Dense_{i}": {"kernel": np.zeros((a, b), np.float32), "bias": np.zeros(b, np.float32)}
        for i, (a, b) in enumerate([(32, 8), (8, 4)])}}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_from_jax_params(params_np)
    assert policy_from_jax_params(params_np, device="cpu").layers[0].weight.shape == (8, 32)


@pytest.mark.parametrize(
    "flag",
    [
        dict(is_challenging_initial_state_buffer=True),
        dict(is_testing_mode=True),
        dict(n_observed_steps=2),
        dict(is_use_mtv_distance=True),
        dict(is_obs_noise=True),
        dict(is_using_opponent_modeling=True),
        dict(is_using_prioritized_marl=True),
        dict(experiment_type="lab"),
    ],
)
def test_unported_env_options_raise(flag):
    """Every env option that once raised is ported (the challenge buffer,
    history, MTV, noise, the opponent-modeling pad, XP-MARL's env config,
    testing mode, the lab experiment type): each builds, resets and steps
    with finite outputs."""
    from sigmarl_tpu_torch import make_env

    assert set(flag) <= PORTED_ENV_OPTIONS
    p = tcfg.Parameters(**{**params("cpm_entire", N, B), **flag})
    env = make_env(p, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(generator=g)
    state, obs, rew, done, _ = env.step(state, torch.zeros((B, N, 2)), generator=g)
    assert obs.shape == (B, N, env.obs_dim)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())


@pytest.mark.parametrize(
    "cbf_kw, filter_kw",
    [
        (dict(is_obs_noise=True), dict(decentralized=True)),
        (dict(fp16_parity=True), dict(max_group_size=4)),
        (dict(nom_controller_type="clf"), {}),
        (dict(fp16_parity=True), {}),
        (dict(use_windowed_pseudo_distance=True), {}),
        (dict(is_obs_noise=True), {}),
    ],
)
def test_unported_filter_options_raise(pair, cbf_kw, filter_kw):
    """Every filter option the JAX filter runs is ported now: each of these
    (observation noise, fp16 parity, the CLF nominal controller, the
    windowed flag) builds and filters one step with finite outputs; an
    unknown nominal controller raises."""
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter

    _, tenv = pair
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, obs_noise_level=0.05, **cbf_kw), tenv.cfg,
                          tenv.tables, device="cpu", **filter_kw)
    g = torch.Generator().manual_seed(1)
    state, _ = tenv.reset(generator=g)
    info = cbf.filter_actions(state, torch.full((B, N, 2), 0.3), generator=g)
    assert bool(info.solved.all()) and bool(torch.isfinite(info.safe_actions).all())
    if cbf_kw == dict(is_obs_noise=True):
        assert not bool((info.nominal_actions[..., 0] == 0.3).any())  # the noise moved them
    with pytest.raises(ValueError):
        CBFSafetyFilter(CBFConfig(n_agents=N, nom_controller_type="mpc"), tenv.cfg, tenv.tables,
                        device="cpu", **filter_kw)


def test_unported_resets_raise(pair):
    """Both resets from given poses are ported: each gives a finite first
    observation and sets the given paths or poses; wrong shapes raise."""
    _, tenv = pair
    init = torch.zeros((N, 3))
    init[:, :2] = tenv.tables.long_term[:N, 5]
    init[:, 2] = tenv.tables.center_line_yaw[:N, 5]
    state, obs = tenv.reset_predefined(init, torch.arange(N))
    assert torch.equal(state.path_id[0], torch.arange(N, dtype=torch.int32))
    assert bool(torch.isfinite(obs).all())
    state, obs = tenv.reset_from_poses(state.pos, state.rot)
    assert float(state.d_ref.max()) < 1e-4  # each pose lies on its chosen path
    assert bool(torch.isfinite(obs).all())
    with pytest.raises(RuntimeError):
        tenv.reset_from_poses(state.pos[:, :2], state.rot)
