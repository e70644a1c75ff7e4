"""K1, the batched CBF-QP solve: the operations and bytes that the
projected-Newton solve at a fixed budget needs, counted from the
algorithm's equations on the input's shapes (`csrc/qp_newton.cu` and its
plain version `ops/qp.py::newton_solve_reference` implement them).

Per env the QP has d = 2N controls, N * 2C valid lane rows of two
coefficients (the two CLF rows per agent are invalid under the RL
nominal and need nothing) and P * Kp pair rows of four coefficients
(P = N (N-1) / 2 pairs, Kp = C^2). Per row of a coefficients:

- residual r = a . u + b: 2a;
- the eliminated penalty phi and its two derivatives: the breakpoint
  (1 division), the stationary gain (6), the penalty at the four
  candidate gains (7 each), the choice (3), the slack, first and second
  derivative (10): 48; phi's value alone (an objective): 38;
- gradient accumulation: 2a; the Hessian's a (a + 1) / 2 entries: 3 each;
- the line search: the direction's change of the row (2a), six
  derivative evaluations (three bisections, two Newton polishes and the
  step cap): the shifted residual (2), phi's derivatives (48), the
  product and sum (3), and 3 more in the two second-derivative ones;
- the three candidate objectives (the line-search point, two arc
  points): residual and phi's value and the sum (2a + 39 each).

Per control and iteration: the tracking term, its gradient, the bounds'
tests and the step's clip, 20; the three objectives' tracking, 12. The
d x d Cholesky factorisation, d^3 / 3, and its two substitutions, 2 d^2.
Outside the iterations: two objectives choose the start, two more close
the stiffness ladder, and one ends the solve.

Bytes: each input read once (the packed rows [B, 6, N Ks] and
[B, 8, P Kp] in float32, the three starts [B, d], the pair lists [P]
int32) and each output written once (u [B, d], F [B])."""

from __future__ import annotations


def _row(a: int) -> int:
    hess = 3 * a * (a + 1) // 2
    line = 2 * a + 6 * (2 + 48 + 3) + 2 * 3
    return 2 * a + 48 + 2 * a + hess + line + 3 * (2 * a + 39)


def _objective(a_rows: list, d: int) -> int:
    return sum(n * (2 * a + 39) for a, n in a_rows) + 4 * d


def flops(batch: int, n_agents: int, n_circles: int, newton_iters: int, soft_iters: int) -> float:
    N, C = n_agents, n_circles
    d, P = 2 * N, N * (N - 1) // 2
    rows = [(2, N * 2 * C), (4, P * C * C)]
    per_iter = sum(n * _row(a) for a, n in rows) + 32 * d + d ** 3 / 3 + 2 * d * d
    outside = (2 + (2 if soft_iters else 0) + 1) * _objective(rows, d)
    return batch * ((newton_iters + soft_iters) * per_iter + outside)


def bytes_moved(batch: int, n_agents: int, n_circles: int) -> float:
    N, C = n_agents, n_circles
    d, P = 2 * N, N * (N - 1) // 2
    Ks, Kp = 2 * C + 2, C * C
    inputs = batch * (6 * N * Ks + 8 * P * Kp + 3 * d) * 4 + 2 * P * 4
    return inputs + batch * (d + 1) * 4


def count(shapes: dict) -> tuple:
    """(flops, bytes) of one solve at the cell's shapes."""
    args = (shapes["batch"], shapes["n_agents"], shapes["n_circles"])
    return (flops(*args, shapes["newton_iters"], shapes["soft_iters"]), bytes_moved(*args))
