"""Spawn placement: the CUDA kernel K3 and its plain version.

`spawn_place` draws every agent's spawn candidates (path by the scenario
group's inverse CDF, point id, pose) and places the agents of each env in
turn, each at its first candidate far enough from the agents already
placed (`env/reset.py::spawn_positions`). At full width env b takes row b
of the draws; with `compact` = (first, count) only the `count` envs with a
reset are spawned, the s-th of them in env order from row first + s. CUDA
tensors launch the kernel (`csrc/spawn_place.cu`) once for the whole batch,
which writes every env's outputs in place of the compaction's gather and
scatter; CPU tensors run the plain version (`spawn_positions`, or
`_spawn_positions_compact` with `compact`).
"""

from __future__ import annotations

import ctypes

import torch

from sigmarl_tpu_torch import trace

Tensor = torch.Tensor

# The kernel's limits (csrc/spawn_place.cu): a lane per candidate, the
# placed agents as the bits of one word, a group's valid paths in four.
MAX_TRIES, MAX_AGENTS, MAX_PATHS = 32, 32, 128


def _check(t: Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_kernel_inputs(cfg, tables, path_u: Tensor, point_u: Tensor, scenario_id: Tensor,
                        prev_pos: Tensor, reset_mask: Tensor, compact=None) -> dict:
    """Check that the kernel takes these inputs, whatever their device, and
    return its sizes; raises ValueError or TypeError before any launch."""
    B, N = prev_pos.shape[:2]
    T = cfg.max_spawn_tries
    G, K = tables.group_mask.shape
    P = tables.long_term.shape[1]
    if not 1 <= T <= MAX_TRIES:
        raise ValueError(f"the kernel takes 1 to {MAX_TRIES} spawn tries, got {T}")
    if not 1 <= N <= MAX_AGENTS:
        raise ValueError(f"the kernel takes 1 to {MAX_AGENTS} agents, got {N}")
    if not 1 <= K <= MAX_PATHS:
        raise ValueError(f"the kernel takes 1 to {MAX_PATHS} paths, got {K}")
    rows = B if compact is None else path_u.shape[0]
    _check(path_u, "path_u", torch.float32, (rows, N, T))
    _check(point_u, "point_u", torch.float32, (rows, N, T))
    _check(scenario_id, "scenario_id", torch.int32, (B,))
    for t, name, dtype, shape in ((prev_pos, "prev_pos", torch.float32, (B, N, 2)),
                                  (reset_mask, "reset_mask", torch.bool, (B, N))):
        if t.dtype != dtype or tuple(t.shape) != shape:  # any strides
            raise TypeError(f"{name} must be {dtype} of shape {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    _check(tables.group_mask, "group_mask", torch.bool, (G, K))
    _check(tables.n_points_long_term, "n_points_long_term", torch.int32, (K,))
    _check(tables.long_term, "long_term", torch.float32, (K, P, 2))
    _check(tables.center_line_yaw, "center_line_yaw", torch.float32, (K, P))
    if tables.long_term.data_ptr() % 8:
        raise ValueError("long_term must be 8-byte aligned (the kernel reads float2)")
    return dict(B=B, N=N, T=T, G=G, K=K, P=P)


def spawn_place_reference(cfg, tables, path_u: Tensor, point_u: Tensor, scenario_id: Tensor,
                          prev_pos: Tensor, reset_mask: Tensor,
                          compact: tuple[int, int] | None = None):
    """Plain PyTorch version on any device: `spawn_positions` at full
    width, `_spawn_positions_compact` with `compact` = (first, count)."""
    from sigmarl_tpu_torch.env.reset import _spawn_positions_compact, spawn_positions

    if compact is None:
        return spawn_positions(cfg, tables, path_u, point_u, scenario_id, prev_pos, reset_mask)
    return _spawn_positions_compact(cfg, tables, path_u, point_u, scenario_id, prev_pos,
                                    reset_mask, *compact)


def spawn_place(cfg, tables, path_u: Tensor, point_u: Tensor, scenario_id: Tensor,
                prev_pos: Tensor, reset_mask: Tensor, compact: tuple[int, int] | None = None):
    """Spawn the masked agents of every env: (pos [B, N, 2], rot [B, N],
    path_id [B, N], point_id [B, N]), as `env/reset.py::spawn_positions`
    returns them. path_u, point_u: [B, N, T] candidate uniforms, or with
    `compact` = (first, count) the compacted draws [S, N, T], rows [first,
    first + count) serving the resetting envs in env order (the envs
    without a reset then pass `prev_pos` through, with zeros elsewhere).
    scenario_id [B] int32; prev_pos [B, N, 2] float32 and reset_mask [B, N]
    bool, both with any strides."""
    if compact is not None:
        first, count = compact
        if first + count > path_u.shape[0]:
            raise ValueError(f"rows [{first}, {first + count}) exceed the "
                             f"{path_u.shape[0]} compacted draws")
    if not prev_pos.is_cuda:
        return spawn_place_reference(cfg, tables, path_u, point_u, scenario_id, prev_pos,
                                     reset_mask, compact)
    sz = check_kernel_inputs(cfg, tables, path_u, point_u, scenario_id, prev_pos, reset_mask,
                             compact)
    B, N = sz["B"], sz["N"]
    dev = prev_pos.device
    pos = torch.empty((B, N, 2), dtype=torch.float32, device=dev)
    rot = torch.empty((B, N), dtype=torch.float32, device=dev)
    path_id = torch.empty((B, N), dtype=torch.int32, device=dev)
    point_id = torch.empty((B, N), dtype=torch.int32, device=dev)
    from sigmarl_tpu_torch.ops.build import library

    fn = library("spawn_place").spawn_place_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    first, count = (-1, 0) if compact is None else compact
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = fn(
        ptr(path_u), ptr(point_u), ptr(scenario_id), ptr(prev_pos), *prev_pos.stride(),
        ptr(reset_mask), *reset_mask.stride(), ptr(tables.group_mask),
        ptr(tables.n_points_long_term), ptr(tables.long_term), ptr(tables.center_line_yaw),
        ptr(pos), ptr(rot), ptr(path_id), ptr(point_id),
        B, N, sz["T"], sz["G"], sz["K"], sz["P"], first, count, int(cfg.is_testing_mode),
        cfg.reset_agent_min_distance**2, stream,
    )
    if err != 0:
        raise RuntimeError(f"spawn placement kernel launch failed: CUDA error {err}")
    trace.count("k3.launches")
    return pos, rot, path_id, point_id
