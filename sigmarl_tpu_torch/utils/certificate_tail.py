"""Why the warm-start certificate's failing instances fail.

    python -m sigmarl_tpu_torch.utils.certificate_tail [--batch 4] [--n_agents 4]
        [--warm-iters 6] [--soft-iters 0] [--steps 10] [--out FILE.npz]
        [--device cuda]

Runs the stress rollout of `sigmarl_tpu_torch.check_warm_start` (same
flags and defaults, same states) and, at every step, takes the instances
whose relative objective gap is above 1e-3 (the warm solve above the cold
oracle). For each it reports, all objectives evaluated on the warm
filter's constraint set as the certificate evaluates them:

- F of the warm solve and of the cold oracle, and the gap;
- F of the solve's plain PyTorch version at the warm budget on the same
  rows (on the card: whether K1 gives what its plain version gives);
- F after 60 more full-stiffness iterations from the same
  warm start (the ladder as in the warm solve): at or below the oracle,
  the warm budget stopped short on a slow descent; above it, the
  iteration sits at a point it does not leave;
- F at the float64 dense oracle's solution (`solve_boxed_penalty_qp`, 200
  iterations from the clipped nominal input, on the CPU).

Prints one JSON line: each instance, and the counts of instances where
K1 and its plain version agree (relative 1e-3) and where the long solve
reaches the oracle. With `--out`, saves the instances (the warm filter's
constraint rows, u_nom, the warm start, both solutions) to an .npz, for a
comparison with another solver.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from sigmarl_tpu_torch.check_warm_start import (
    GAP_LIMIT,
    both_solves,
    evaluate,
    parser,
    setup_args,
    stress_setup,
)
from sigmarl_tpu_torch.device import device_line, resolve_device
from sigmarl_tpu_torch.ops.qp import newton_solve_reference
from sigmarl_tpu_torch.safety.qp import (
    StructuredConstraintSet,
    kernel_inputs,
    solve_boxed_penalty_qp,
    solve_structured_qp,
)
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

DENSE_ITERS, LONG_ITERS = 200, 60


def select_envs(cons: StructuredConstraintSet, envs: torch.Tensor, dtype=None, device=None):
    """The rows of the envs `envs`, optionally cast and moved."""

    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x[envs].to(device or x.device)
        return x.to(dtype) if dtype is not None and x.is_floating_point() else x

    return dataclasses.replace(cons, **{f.name: take(getattr(cons, f.name))
                                        for f in dataclasses.fields(cons)})


def explain_step(warm, cold, state, act):
    """The certificate's gap at `state` [B], and its failing instances
    (one dict each, with their arrays)."""
    cfg = warm.cfg
    w_u = (cfg.w_u_acc, cfg.w_u_steer)
    lo, hi = (warm.a_min, warm.rate_min), (warm.a_max, warm.rate_max)
    u_w, u_c, F_w, F_c, cons, u_nom = both_solves(warm, cold, state, act)
    gap = (F_w - F_c) / (1.0 + F_c.abs())
    envs = (gap > GAP_LIMIT).nonzero()[:, 0]
    if envs.numel() == 0:
        return gap, []
    sub, un_sub, ui_sub = select_envs(cons, envs), u_nom[envs], state.cbf_u_prev[envs]
    args = kernel_inputs(sub, un_sub, lo, hi, ui_sub, cfg.newton_ws_cap)
    u_plain, _ = newton_solve_reference(*args, w_u, lo, hi, cfg.newton_iters,
                                        soft_iters=cfg.newton_soft_iters,
                                        soft_cap=cfg.newton_soft_cap, ws_cap=cfg.newton_ws_cap)
    N = u_nom.shape[1]
    u_plain = torch.stack([u_plain[:, :N], u_plain[:, N:]], dim=-1)
    u_long, _ = solve_structured_qp(sub, un_sub, w_u, lo, hi, n_iters=cfg.newton_iters + LONG_ITERS,
                                    u_init=ui_sub, ws_cap=cfg.newton_ws_cap,
                                    soft_iters=cfg.newton_soft_iters, soft_cap=cfg.newton_soft_cap)
    F_plain, F_long = evaluate(warm, u_plain, sub, un_sub), evaluate(warm, u_long, sub, un_sub)

    sub64 = select_envs(cons, envs, torch.float64, "cpu")
    un64 = un_sub.double().cpu()
    w_d = torch.tensor(w_u, dtype=torch.float64).repeat(N)
    lo_d, hi_d = (torch.tensor(x, dtype=torch.float64).repeat(N) for x in (lo, hi))
    u64, _ = solve_boxed_penalty_qp(warm.to_dense(sub64), un64.reshape(-1, 2 * N), w_d, lo_d,
                                    hi_d, n_iters=DENSE_ITERS)
    F_dense = evaluate(warm, u64.reshape(-1, N, 2), sub64, un64)

    rows = []
    for k, e in enumerate(envs.tolist()):
        fc = float(F_c[e])
        rel = lambda f: (float(f) - fc) / (1.0 + abs(fc))  # noqa: E731
        rows.append(dict(env=e, F_warm=float(F_w[e]), F_cold=fc, gap=rel(F_w[e]),
                         gap_plain=rel(F_plain[k]), gap_long=rel(F_long[k]),
                         gap_dense64=rel(F_dense[k]),
                         arrays=dict(u_nom=un_sub[k], u_init=ui_sub[k], u_warm=u_w[e],
                                     u_cold=u_c[e], cons=select_envs(cons, envs[k:k + 1]))))
    return gap, rows


def explain(batch: int = 4, n_agents: int = 4, warm_iters: int = 6, soft_iters: int = 0,
            soft_cap: float = 10.0, cold_iters: int = 30, steps: int = 10,
            scenario: str = "cpm_entire", device=None) -> list:
    """The failing instances of the certificate's stress rollout (the
    arguments of `check_warm_start.certificate`), one dict each with its
    step and arrays."""
    env, warm, cold, state, act, gen = stress_setup(batch, n_agents, warm_iters, soft_iters,
                                                    soft_cap, cold_iters, scenario, device)
    rows = []
    for step in range(steps):
        rows += [dict(step=step, **r) for r in explain_step(warm, cold, state, act)[1]]
        state, *_ = cbf_filtered_step(env, warm, state, act, generator=gen)
    return rows


def save_instances(rows: list, path: str) -> None:
    save = {}
    for i, r in enumerate(rows):
        a = r["arrays"]
        for k in ("u_nom", "u_init", "u_warm", "u_cold"):
            save[f"{i}/{k}"] = a[k].cpu().numpy()
        for f in dataclasses.fields(a["cons"]):
            v = getattr(a["cons"], f.name)
            save[f"{i}/cons/{f.name}"] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                          else np.asarray(v))
        save[f"{i}/where"] = np.asarray([r["step"], r["env"]])
    np.savez(path, **save)


def plain_agrees(r: dict) -> bool:
    """K1's warm solve ends where its plain version does (relative 1e-3)."""
    return abs(r["gap_plain"] - r["gap"]) <= 1e-3 * (1.0 + abs(r["gap"]))


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="save the failing instances to this .npz")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = explain(*setup_args(args)[:-1], dev)
    if args.out:
        save_instances(rows, args.out)
    for r in rows:
        del r["arrays"]
    print(json.dumps(dict(
        diagnosis="warm_start_certificate_tail", device=device_line(dev), batch=args.batch,
        n_agents=args.n_agents, newton_iters=args.warm_iters, soft_iters=args.soft_iters,
        steps=args.steps, long_iters=LONG_ITERS, n_failing=len(rows),
        plain_agrees=sum(map(plain_agrees, rows)),
        long_reaches_oracle=sum(r["gap_long"] <= GAP_LIMIT for r in rows), instances=rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
