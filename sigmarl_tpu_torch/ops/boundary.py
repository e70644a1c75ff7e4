"""Pseudo-distance stencil: the CUDA kernel K2 and its plain version.

`pseudo_distance_stencil` takes query points per row and each row's path
id, and returns the pseudo distance of every query to the left and right
boundary of that path (`csrc/boundary_stencil.cu`). With selected chunk
indices per row and side it sweeps only those chunks' segments; without,
every segment of the path. CUDA tensors launch the kernel; CPU tensors
run `pseudo_distance_stencil_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.safety.pseudo_distance import PD_CHUNK, chunk_rows, pseudo_distance_seg

Tensor = torch.Tensor


def pseudo_distance_stencil_reference(
    q: Tensor,
    path_id: Tensor,
    left_seg: Tensor,
    right_seg: Tensor,
    left_chunks: Tensor | None = None,
    right_chunks: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version: gather each row's segment rows, then
    `pseudo_distance_seg`. Returns (d_left [R, Q], d_right [R, Q])."""
    pid = path_id.long()

    def side(seg, chunks):
        rows = seg[pid] if chunks is None else chunk_rows(seg, path_id, chunks)
        return pseudo_distance_seg(q, rows)

    return side(left_seg, left_chunks), side(right_seg, right_chunks)


def _check(t: Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t: Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def pseudo_distance_stencil(
    q: Tensor,  # [R, Q, 2] float32 query points
    path_id: Tensor,  # [R] int32
    left_seg: Tensor,  # [K, S, 8] float32 segment tables (segment_table layout)
    right_seg: Tensor,  # [K, S, 8]
    left_chunks: Tensor | None = None,  # [R, k] int32 selected chunks, left side
    right_chunks: Tensor | None = None,  # [R, k] int32, right side
) -> tuple[Tensor, Tensor]:
    """Pseudo distances of all queries to both boundaries: (d_left [R, Q],
    d_right [R, Q]). CPU tensors take the plain version; CUDA tensors launch
    the kernel (one launch for both sides)."""
    if not q.is_cuda:
        return pseudo_distance_stencil_reference(
            q, path_id, left_seg, right_seg, left_chunks, right_chunks
        )
    R, Q = q.shape[0], q.shape[1]
    K, S = left_seg.shape[0], left_seg.shape[1]
    if Q > 128:
        raise ValueError(f"the kernel takes at most 128 queries per row, got {Q}")
    _check(q, "q", torch.float32, (R, Q, 2))
    _check(path_id, "path_id", torch.int32, (R,))
    _check(left_seg, "left_seg", torch.float32, (K, S, 8))
    _check(right_seg, "right_seg", torch.float32, (K, S, 8))
    if (left_chunks is None) != (right_chunks is None):
        raise ValueError("pass chunk indices for both sides or for neither")
    k = 0
    if left_chunks is not None:
        if S % PD_CHUNK:
            raise ValueError(f"segment axis {S} is not a multiple of {PD_CHUNK}")
        k = left_chunks.shape[-1]
        if 2 * k > 32:
            raise ValueError(f"the kernel takes at most 16 chunks per row and side, got {k}")
        _check(left_chunks, "left_chunks", torch.int32, (R, k))
        _check(right_chunks, "right_chunks", torch.int32, (R, k))
    d_left = torch.empty((R, Q), dtype=torch.float32, device=q.device)
    d_right = torch.empty((R, Q), dtype=torch.float32, device=q.device)
    from sigmarl_tpu_torch.ops.build import library

    fn = library("boundary_stencil").pd_stencil_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    err = fn(
        _ptr(q), _ptr(path_id), _ptr(left_seg), _ptr(right_seg),
        _ptr(left_chunks), _ptr(right_chunks), _ptr(d_left), _ptr(d_right),
        R, Q, K, S, k, PD_CHUNK, stream,
    )
    if err != 0:
        raise RuntimeError(f"pseudo-distance stencil kernel launch failed: CUDA error {err}")
    trace.count("k2.launches")
    return d_left, d_right
