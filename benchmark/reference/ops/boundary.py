"""Pseudo-distance stencil: the CUDA kernel K2 and its plain version.

`pseudo_distance_stencil` takes query points per row and each row's path
id, and returns the pseudo distance of every query to the left and right
boundary of that path (`csrc/boundary_stencil.cu`). With selected chunk
indices per row and side it sweeps only those chunks' segments; without,
every segment of the path. CUDA tensors launch the kernel; CPU tensors
run `pseudo_distance_stencil_reference`.
"""

from __future__ import annotations

import torch

from benchmark.reference.safety.pseudo_distance import PD_CHUNK, chunk_rows, pseudo_distance_seg

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


def pseudo_distance_stencil(q, path_id, left_seg, right_seg, left_chunks=None,
                            right_chunks=None) -> tuple[Tensor, Tensor]:
    """Pseudo distances of all queries to both boundaries: the plain
    version on every device (the benchmark's reference launches no
    kernel)."""
    return pseudo_distance_stencil_reference(q, path_id, left_seg, right_seg, left_chunks,
                                             right_chunks)
