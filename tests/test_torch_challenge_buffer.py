"""The challenging initial-state buffer in the port against the JAX
package: the record of colliding envs into the ring (more recording envs
than slots, so that the later env wins, and a wrap of the ring) and the
replay of a record at a full-env reset with the geometry recomputed. (One
training iteration with the buffer on is held in `test_torch_training.py`.)

Tolerances as in `test_torch_env.py` (float32 state fields to atol 2e-5,
observations to 1e-4, integer fields, flags and the buffer's pointers
exactly; the recorded rows are copies, so the buffer is compared exactly
too). A replay recomputes the boundary indices from the pose, and on a
spawn point two boundary segments can lie at the same float32 distance:
there `idx_left`/`idx_right` may name the other of the two
(`torch_parity.assert_idx_close`), as `test_torch_maps.py` allows for the
spawn tables (the distances agree)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.env.structs import replace_state as jreplace
from sigmarl_tpu_torch.env.env import record_challenging_states
from sigmarl_tpu_torch.env.structs import EnvConfig, zero_state
from tests.test_torch_env import assert_state_close
from tests.test_torch_training import BASE
from tests.torch_parity import (
    IDX, assert_idx_close, env_variant, envs, step_reset_draws, to_torch_state,
)

torch.set_num_threads(1)
C = 3
B, N = BASE["num_vmas_envs"], BASE["n_agents"]


@pytest.fixture(scope="module")
def pair():
    """Both envs (cpm_mixed, N=4, B=4) with the buffer on; the tests change
    the env settings that `Parameters` does not carry (ring size,
    probabilities) with `env_variant`."""
    return envs(**BASE, is_challenging_initial_state_buffer=True, where_to_save="unused/")


def _collide(state, envs_):
    """Put agent 1 on agent 0 in the given envs (a JAX state)."""
    pos = np.array(state.pos)
    pos[envs_, 1] = pos[envs_, 0] + np.array([0.02, 0.0], np.float32)
    return jreplace(state, pos=jnp.asarray(pos))


def test_record_and_replay_match_jax(pair):
    """Six steps from a JAX reset whose state buffer holds the reset poses,
    with agent 1 put on agent 0 in every env before the first two steps,
    into a ring of three slots: the port's state, including the buffer,
    its pointer and valid count, equals JAX's after every step. Four
    recording envs into three slots keep the last three, in env order; the
    second round wraps the ring; full-env resets replay records (with
    probability 0.5 here)."""
    jenv, tenv = env_variant(*pair, max_steps=1_000_000, challenge_buffer_size=C,
                             probability_use_recording=0.5)
    key = jax.random.PRNGKey(5)
    state, _ = jax.jit(jenv.reset)(key)
    latest = state.state_buffer[(int(state.sb_pointer) - 1) % jenv.cfg.n_steps_stored]
    state = jreplace(state, state_buffer=jnp.broadcast_to(latest, state.state_buffer.shape))
    jstep = jax.jit(jenv.step)
    recording, replayed = [], 0
    for t in range(6):
        if t < 2:
            state = _collide(state, list(range(B)))
        k_act, k_step = jax.random.split(jax.random.fold_in(key, t))
        act = jax.random.uniform(k_act, (B, N, 2), minval=0.0, maxval=0.6)
        js, jobs, jrew, jdone, jinfo = jstep(state, act, k_step)
        draws = step_reset_draws(k_step, jenv.cfg)
        ts, tobs, trew, tdone, _ = tenv.step(
            to_torch_state(state), torch.from_numpy(np.asarray(act)), reset_draws=draws)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"step {t}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
        assert_state_close(ts, js, skip=IDX)
        assert_idx_close(ts, js, tenv.tables)
        np.testing.assert_array_equal(ts.challenge_buffer.numpy(), np.asarray(js.challenge_buffer))
        # Every env with an agent-agent collision records (probability 1).
        n_rec = int(np.asarray(jinfo["is_collision_with_agents"]).any(-1).sum())
        assert int(js.cb_pointer) == (int(state.cb_pointer) + n_rec) % C
        recording.append(n_rec)
        use = (draws.use_u.numpy() < 0.5) & np.asarray(jdone) & (int(js.cb_valid) >= 1)
        replayed += int(use.sum())
        state = js
    assert recording[0] == recording[1] == B > C and replayed > 0, (recording, replayed)
    # The env's device-side counts of records and replays.
    assert tenv.challenge_counts.tolist() == [sum(recording), replayed]


def test_record_keeps_the_later_env_per_slot():
    """More recording envs than slots: slot s holds the row of the last env
    that the sequential scan wrote there, and envs that did not collide
    or a record draw above `probability_record` write nothing."""
    cfg = EnvConfig(scenario_type="cpm_entire", dt=0.1, max_steps=8, n_agents=2, batch_dim=7,
                    challenge_buffer_size=3, n_steps_stored=4,
                    probability_record=0.5)
    st = zero_state(cfg, "cpu")
    rows = torch.arange(4 * 7 * 2 * 8, dtype=torch.float32).reshape(4, 7, 2, 8)
    coll = torch.zeros((7, 2, 2), dtype=torch.bool)
    coll[[0, 1, 3, 4, 6], 0, 1] = True
    st = dataclasses.replace(st, state_buffer=rows, sb_pointer=torch.tensor(6, dtype=torch.int32),
                             coll_agents=coll, cb_pointer=torch.tensor(1, dtype=torch.int32),
                             cb_valid=torch.tensor(1, dtype=torch.int32))
    out, n = record_challenging_states(cfg, st, torch.tensor(0.5))
    oldest = rows[6 % 4]
    # Writers in order 0, 1, 3, 4, 6 at slots 1, 2, 0, 1, 2: the last
    # three (3, 4, 6) win slots 0, 1, 2.
    torch.testing.assert_close(out.challenge_buffer, oldest[[3, 4, 6]], rtol=0, atol=0)
    assert int(n) == 5 and int(out.cb_pointer) == (1 + 5) % 3 and int(out.cb_valid) == 3
    same, n = record_challenging_states(cfg, st, torch.tensor(0.51))
    assert bool((same.challenge_buffer == 0).all()) and int(same.cb_valid) == 1 and int(n) == 0
