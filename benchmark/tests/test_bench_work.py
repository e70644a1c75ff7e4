"""The work counts on small shapes worked by hand."""

from __future__ import annotations

import pytest

from benchmark.work import k1_newton, k2_stencil, mlp
from benchmark.work.peaks import least_seconds, roofline_pct


def test_k1_one_agent_one_circle_by_hand():
    # N=1, C=1: d=2, two lane rows of two coefficients, no pairs.
    # Per row: residual 4, phi 48, gradient 4, Hessian 3*3=9, line search
    # 4 + 6*53 + 6 = 328, three objectives 3*(4+39)=129: 522.
    # Per iteration: 2*522 + 32*2 + 8/3 + 8; outside: 5 objectives of
    # 2*43 + 8 = 94 each (two starts, two after the ladder, the last).
    per_iter = 2 * 522 + 64 + 8 / 3 + 8
    assert k1_newton.flops(1, 1, 1, 5, 3) == pytest.approx(8 * per_iter + 5 * 94)
    assert k1_newton.flops(1, 1, 1, 5, 0) == pytest.approx(5 * per_iter + 3 * 94)
    # Bytes: singles 6*1*4 floats, no pair rows, three starts of 2, out 2 + 1.
    assert k1_newton.bytes_moved(1, 1, 1) == (6 * 4 + 3 * 2) * 4 + 3 * 4


def test_k1_pairs_by_hand():
    # N=2, C=1: one pair of one row of four coefficients: residual 8,
    # phi 48, gradient 8, Hessian 3*10=30, line search 8+318+6=332,
    # objectives 3*(8+39)=141: 567; four lane rows at 522; d=4.
    per_iter = 4 * 522 + 567 + 32 * 4 + 64 / 3 + 2 * 16
    outside = 3 * (4 * 43 + 47 + 16)
    assert k1_newton.flops(3, 2, 1, 2, 0) == pytest.approx(3 * (2 * per_iter + outside))


def test_k2_by_hand():
    shapes = dict(batch=2, n_agents=1, n_circles=1, pd_chunks=1, segment_table=[3, 16, 8])
    flops, nbytes = k2_stencil.count(shapes)
    # R=2 rows of 9 queries, two sides, 21 operations each.
    assert flops == 2 * 9 * 2 * 21
    # queries 2*9*2 floats, path ids 2, chunks 2*2*1, tables 2*3*16*8,
    # outputs 2*2*9.
    assert nbytes == (36 + 2 + 4 + 768 + 36) * 4


def test_mlp_by_hand():
    # 3 -> 2 -> 1: (2*3*2 + 2*2) + (2*2*1 + 2*1) = 16 + 6 per row.
    assert mlp.forward_flops([3, 2, 1], 5) == 5 * 22
    assert mlp.train_flops([3, 2, 1], 1) == (6 * 6 + 4) + (6 * 2 + 2)


def test_roofline_takes_the_larger_bound():
    t, by = least_seconds(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = least_seconds(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
    assert roofline_pct(67e12, 0.0, 4.0) == pytest.approx(25.0)
