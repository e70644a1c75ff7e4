"""The spawn placement's wrapper (`ops/spawn.py`) on the CPU: CPU inputs
take the plain version, each resetting env of a compacted spawn takes the
row `first` + its rank among the resetting envs, the kernel's argument
checks refuse what it does not take before any launch, and the launch
counts carry the kernel. The kernel itself runs in `test_torch_gpu.py`.
"""

import dataclasses

import pytest
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.reset import spawn_positions
from sigmarl_tpu_torch.ops import launch_counts
from sigmarl_tpu_torch.ops.spawn import (
    check_kernel_inputs,
    spawn_place,
    spawn_place_reference,
)

B, N = 8, 4


@pytest.fixture(scope="module")
def env():
    p = Parameters(scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
                   is_use_mtv_distance=False, is_obs_noise=False)
    return make_env(p, device="cpu")


def _inputs(env, rows, seed=0):
    """Candidate uniforms [rows, N, T], scenario ids, previous positions
    (an env reset from the seed) and a partial mask with envs 1, 4 and 6
    resetting."""
    g = torch.Generator().manual_seed(seed)
    T = env.cfg.max_spawn_tries
    path_u, point_u = torch.rand((rows, N, T), generator=g), torch.rand((rows, N, T), generator=g)
    state, _ = env.reset(generator=g)
    mask = torch.zeros((B, N), dtype=torch.bool)
    mask[1] = True
    mask[4, 2] = True
    mask[6, ::2] = True
    return path_u, point_u, state.scenario_id[:, 0].contiguous(), state.pos, mask


def test_cpu_inputs_take_the_plain_version(env):
    """At full width and compacted, spawn_place on CPU tensors returns what
    the plain version returns, and launches nothing."""
    path_u, point_u, sid, pos, mask = _inputs(env, B)
    before = launch_counts()
    for compact in (None, (0, 3)):
        got = spawn_place(env.cfg, env.tables, path_u, point_u, sid, pos, mask, compact)
        want = spawn_place_reference(env.cfg, env.tables, path_u, point_u, sid, pos, mask, compact)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    full = spawn_positions(env.cfg, env.tables, path_u, point_u, sid, pos, mask)
    assert all(torch.equal(a, b) for a, b in zip(spawn_place(
        env.cfg, env.tables, path_u, point_u, sid, pos, mask), full))
    assert launch_counts(since=before)["spawn_place"] == 0


@pytest.mark.parametrize("first", [0, 2, 5])
def test_each_resetting_env_takes_row_first_plus_its_rank(env, first):
    """Compacted, the s-th resetting env (1, 4, 6 in env order) spawns as
    the full-width spawn of that env alone from row first + s; the envs
    without a reset keep their positions with zero yaw and ids."""
    path_u, point_u, sid, pos, mask = _inputs(env, 8, seed=first)
    out = spawn_place(env.cfg, env.tables, path_u, point_u, sid, pos, mask, (first, 3))
    for s, b in enumerate((1, 4, 6)):
        row = slice(first + s, first + s + 1)
        one = spawn_positions(env.cfg, env.tables, path_u[row], point_u[row], sid[b:b + 1],
                              pos[b:b + 1], mask[b:b + 1])
        assert all(torch.equal(o[b:b + 1], w) for o, w in zip(out, one)), (s, b)
    still = torch.tensor([b not in (1, 4, 6) for b in range(B)])
    assert torch.equal(out[0][still], pos[still])
    assert all(not o[still].any() for o in out[1:])


def test_compacted_rows_beyond_the_draws_raise(env):
    path_u, point_u, sid, pos, mask = _inputs(env, 4)
    with pytest.raises(ValueError, match="exceed the 4 compacted draws"):
        spawn_place(env.cfg, env.tables, path_u, point_u, sid, pos, mask, (2, 3))


def _bad(env, case):
    """(cfg, tables, inputs, compact) with one thing the kernel refuses."""
    cfg, tables = env.cfg, env.tables
    path_u, point_u, sid, pos, mask = _inputs(env, B)
    compact = None
    if case == "tries":
        cfg = dataclasses.replace(cfg, max_spawn_tries=33)
        path_u, point_u = torch.rand((B, N, 33)), torch.rand((B, N, 33))
    elif case == "agents":
        n = 33
        path_u, point_u = torch.rand((B, n, 12)), torch.rand((B, n, 12))
        pos, mask = torch.zeros((B, n, 2)), torch.ones((B, n), dtype=torch.bool)
    elif case == "paths":
        K = 129
        tables = dataclasses.replace(
            tables, group_mask=torch.ones((1, K), dtype=torch.bool),
            n_points_long_term=torch.full((K,), 8, dtype=torch.int32),
            long_term=torch.zeros((K, 8, 2)), center_line_yaw=torch.zeros((K, 8)))
    elif case == "dtype":
        path_u = path_u.double()
    elif case == "ids":
        sid = sid.long()
    elif case == "shape":
        point_u = point_u[:, :, :-1]
    elif case == "compacted shape":
        compact = (0, 3)
        path_u = path_u[:, :2]
    elif case == "layout":
        path_u = path_u.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "positions":
        pos = pos.half()
    elif case == "mask":
        mask = mask.to(torch.uint8)
    return cfg, tables, (path_u, point_u, sid, pos, mask), compact


@pytest.mark.parametrize("case, error, match", [
    ("tries", ValueError, "1 to 32 spawn tries"),
    ("agents", ValueError, "1 to 32 agents"),
    ("paths", ValueError, "1 to 128 paths"),
    ("dtype", TypeError, "path_u must be torch.float32"),
    ("ids", TypeError, "scenario_id must be torch.int32"),
    ("shape", ValueError, "point_u must have shape"),
    ("compacted shape", ValueError, "path_u must have shape"),
    ("layout", ValueError, "path_u must be contiguous"),
    ("positions", TypeError, "prev_pos must be torch.float32 of shape"),
    ("mask", TypeError, "reset_mask must be torch.bool of shape"),
])
def test_the_kernels_argument_checks_refuse_what_it_does_not_take(env, case, error, match):
    cfg, tables, inputs, compact = _bad(env, case)
    with pytest.raises(error, match=match):
        check_kernel_inputs(cfg, tables, *inputs, compact)


def test_the_kernels_argument_checks_take_the_main_paths_inputs(env):
    """A mask broadcast over the agents (as whole-env resets make it) and
    positions sliced from a wider tensor are taken as they are, by their
    strides; testing mode's 20 tries too."""
    path_u, point_u, sid, pos, mask = _inputs(env, B)
    whole = mask.any(-1)[:, None].expand(B, N)
    pos = torch.cat([pos, pos], -1)[..., 1:3]
    assert check_kernel_inputs(env.cfg, env.tables, path_u, point_u, sid, pos, whole) == dict(
        B=B, N=N, T=12, G=4, K=40, P=env.tables.long_term.shape[1])
    cfg = dataclasses.replace(env.cfg, max_spawn_tries=20)
    u = torch.rand((3, N, 20))
    assert check_kernel_inputs(cfg, env.tables, u, u, sid, pos, mask, (0, 3))["T"] == 20


def test_launch_counts_carry_the_spawn_kernel():
    """`k3.launches` reads as `spawn_place`, since an earlier reading too."""
    before = launch_counts()
    assert set(before) == {"qp_newton", "boundary_stencil", "spawn_place"}
    trace.count("k3.launches", 2)
    assert launch_counts(since=before) == {"qp_newton": 0, "boundary_stencil": 0,
                                           "spawn_place": 2}
    assert launch_counts()["spawn_place"] == before["spawn_place"] + 2
