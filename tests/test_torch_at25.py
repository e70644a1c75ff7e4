"""AT25 in the port against the JAX package: the scripted run (N=4, 64
steps from `default_poses`, testing mode, constant (0.5, 0) actions) with
the JAX run's reset draws of every step passed through the rollout's
`StepDraws`, so that the agents that collide respawn alike in both.

Every metric equals JAX's: the collision rates (shares of the same
flags) exactly, the speed, center-line deviation, distance driven and
the events per 100 m (float32 sums over the same steps) to a relative
1e-5; the timing keys are wall clock and are only checked to be
there."""

import jax
import numpy as np
import pytest
import torch

from sigmarl_tpu.eval import at25 as jax_at25
from sigmarl_tpu_torch.eval import at25
from sigmarl_tpu_torch.eval.rollout import StepDraws
from tests.torch_parity import envs, params, step_reset_draws

torch.set_num_threads(1)
N, STEPS, SEED, CHUNK = 4, 64, 0, 32
EXACT = ("collision_rate_agents", "collision_rate_lanelets", "collision_rate_total")


def jax_step_draws(cfg, max_steps: int, seed: int):
    """The reset draws of each step of the JAX package's `rollout(...,
    PRNGKey(seed))`: per chunk of 32 steps the keys split from
    fold_in(key, steps remaining), each step's env key the third of its
    key's split."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    out, remaining = [], max_steps
    while remaining > 0:
        ks = jax.random.split(jax.random.fold_in(key, remaining), CHUNK)
        for k in ks[:min(CHUNK, remaining)]:
            k_env = jax.random.split(k, 3)[2]
            out.append(StepDraws(reset=step_reset_draws(k_env, cfg)))
        remaining -= CHUNK
    return out


@pytest.fixture(scope="module")
def results():
    jenv, _ = envs(**params("cpm_entire", N, 1, max_steps=STEPS + 1, is_testing_mode=True,
                            is_using_cbf_testing=False))
    want = jax_at25.run_model(None, n_agents=N, max_steps=STEPS, seed=SEED)
    got = at25.run_model(None, n_agents=N, max_steps=STEPS, seed=SEED, device="cpu",
                         draws=jax_step_draws(jenv.cfg, STEPS, SEED))
    return got, want


def test_at25_metric_keys_match_jax(results):
    got, want = results
    assert set(got) == set(want)


@pytest.mark.parametrize("key", [
    "collision_rate_agents", "collision_rate_lanelets", "collision_rate_total",
    "center_line_deviation_mean", "average_speed", "agent_collision_events_per_100m",
    "boundary_collision_events_per_100m", "distance_driven_m"])
def test_at25_values_match_jax(results, key):
    got, want = results
    if key in EXACT:
        assert got[key] == want[key]
    else:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=0)


def test_at25_run_is_decided_by_the_reset_draws(results):
    """Agents collide and respawn, so the reset draws are taken: the same
    run with the port's own draws drives elsewhere."""
    got, _ = results
    assert got["collision_rate_total"] > 0
    own = at25.run_model(None, n_agents=N, max_steps=STEPS, seed=SEED, device="cpu")
    assert own["distance_driven_m"] != got["distance_driven_m"]
