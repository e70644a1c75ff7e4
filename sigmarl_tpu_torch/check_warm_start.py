"""The warm-start certificate of the filter's fixed-budget solve: its
objective against a cold, long solve along a stress rollout.

    python -m sigmarl_tpu_torch.check_warm_start [--batch 4] [--n_agents 4]
        [--warm-iters 6] [--soft-iters 0] [--soft-cap 10] [--cold-iters 30]
        [--steps 10] [--scenario cpm_entire] [--device cuda]

The counterpart of the JAX package's `scripts/check_warm_start_tpu.py`,
with its flags and defaults. The default replays the small N=4, B=4
fixture; the production 3+5 solve that `python -m sigmarl_tpu_torch.bench`
runs is certified at its own scale:

    python -m sigmarl_tpu_torch.check_warm_start --batch 1024 --n_agents 15 \\
        --warm-iters 5 --soft-iters 3 --steps 20

The stress rollout: `env.reset` from a generator seeded 0, then every
agent's action fixed at (0.5, 0), each step filtered by the warm filter
(warm-started from the previous step's solution). Every random number of
the rollout (the reset, the later resets' spawns) is drawn from that
generator on the host and moved to the device: torch's CPU and CUDA
generators draw different numbers from one seed, so a card and the CPU
certify the same instances, as JAX's PRNG does on every backend. The
reset itself also runs on the host: from the same draws the card's
reset places the same poses but rounds the geometry derived from them
(velocities, vertices, distances) an ulp apart, so the card starts from
the CPU's reset state, bit for bit. At every step, before
the step, both filters solve the same state: the warm one from the
previous solution, the cold oracle (2 ladder iterations at cap 10, then
`--cold-iters` full-stiffness ones) from the nominal input. Both
solutions' objectives are evaluated on the warm filter's constraint set
(`solve_structured_qp` with no iteration: the better of the clipped
nominal input and the solution, as the solve's own start), and the gap is
(F_warm - F_cold) / (1 + |F_cold|) per env.

The check is ok when the p99 of the gap is below 1e-3 over at least 10,000
instances (env x step); on fewer, when the largest gap is below 1e-3 and
the largest control difference below 2e-2. Prints one JSON line and exits
1 when the check is not ok. Without a card and without `--device cpu` the
program raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch import Tensor

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.device import device_line, resolve_device
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import state_to
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.qp import solve_structured_qp
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

GAP_LIMIT, U_DEV_LIMIT, MIN_INSTANCES = 1e-3, 2e-2, 10_000
STRESS_ACTION = (0.5, 0.0)
# Instances the result line lists, worst gap first.
N_WORST = 8


def stress_setup(batch: int, n_agents: int, warm_iters: int, soft_iters: int, soft_cap: float,
                 cold_iters: int, scenario: str = "cpm_entire", device=None):
    """(env, warm filter, cold filter, reset state, the fixed action,
    generator) of the stress rollout. The generator is on the host, seeded
    0; the reset runs on the host from its draws and moves to the
    device."""
    dev = resolve_device(device)
    p = Parameters(
        scenario_type=scenario, n_agents=n_agents, num_vmas_envs=batch, dt=0.1,
        max_steps=1000, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    env = make_env(p, device=dev)
    warm = CBFSafetyFilter(
        CBFConfig(n_agents=n_agents, dt=0.1, newton_iters=warm_iters,
                  newton_soft_iters=soft_iters, newton_soft_cap=soft_cap),
        env.cfg, env.tables, device=dev,
    )
    # The cold oracle always starts with a 2-iteration ladder: a pure
    # full-stiffness iteration creeps on heavily infeasible pile-ups, so
    # without it the oracle could be the unconverged side.
    cold = CBFSafetyFilter(
        CBFConfig(n_agents=n_agents, dt=0.1, newton_iters=cold_iters,
                  newton_soft_iters=2, newton_soft_cap=10.0),
        env.cfg, env.tables, device=dev,
    )
    gen = torch.Generator().manual_seed(0)
    host = env if dev.type == "cpu" else make_env(p, device="cpu")
    state, _ = host.reset(draws=ResetDraws.sample(host.cfg, gen, "cpu"))
    state = state_to(state, dev)
    act = torch.zeros((batch, n_agents, 2), device=dev)
    act[..., 0], act[..., 1] = STRESS_ACTION
    return env, warm, cold, state, act, gen


def evaluate(warm: CBFSafetyFilter, u: Tensor, cons, u_nom: Tensor) -> Tensor:
    """F of `u` on `cons` as the certificate evaluates it: the solve with
    no iteration, from the better of clip(u_nom) and clip(u) [B]."""
    bounds = ((warm.cfg.w_u_acc, warm.cfg.w_u_steer), (warm.a_min, warm.rate_min),
              (warm.a_max, warm.rate_max))
    return solve_structured_qp(cons, u_nom, *bounds, n_iters=0, u_init=u)[1]


def both_solves(warm: CBFSafetyFilter, cold: CBFSafetyFilter, state, act):
    """At `state`: the warm solution (from the previous one), the cold
    oracle's, both objectives on the warm filter's constraint set, and
    that set with its nominal input: (u_w, u_c, F_w, F_c, cons, u_nom)."""
    u_c = cold.filter_actions(state, act).u_star
    u_w = warm.filter_actions(state, act, u_init=state.cbf_u_prev).u_star
    cons, u_nom, _, _ = warm.assemble(state, act)
    return (u_w, u_c, evaluate(warm, u_w, cons, u_nom), evaluate(warm, u_c, cons, u_nom),
            cons, u_nom)


def objective_gap(warm: CBFSafetyFilter, cold: CBFSafetyFilter, state, act):
    """(gap per env [B], largest |u_warm - u_cold|) at `state`."""
    u_w, u_c, F_w, F_c, _, _ = both_solves(warm, cold, state, act)
    return (F_w - F_c) / (1.0 + F_c.abs()), (u_w - u_c).abs().max()


def certify(gaps: np.ndarray, max_err: float) -> dict:
    """The certificate's statistics and verdict from the gaps [steps, B]."""
    g = gaps.reshape(-1)
    quantiles = {
        "p50": float(np.quantile(g, 0.5)),
        "p99": float(np.quantile(g, 0.99)),
        "p999": float(np.quantile(g, 0.999)),
        "frac_above_1e3": float((g > GAP_LIMIT).mean()),
    }
    if g.size >= MIN_INSTANCES:
        ok = quantiles["p99"] < GAP_LIMIT
    else:
        ok = float(g.max()) < GAP_LIMIT and max_err < U_DEV_LIMIT
    order = np.argsort(gaps, axis=None)[::-1][:N_WORST]
    worst = [dict(step=int(s), env=int(e), gap=float(gaps[s, e]))
             for s, e in zip(*np.unravel_index(order, gaps.shape))]
    return dict(max_objective_gap=float(g.max()), gap_quantiles=quantiles,
                n_instances=int(g.size), max_u_dev=max_err, worst=worst, ok=bool(ok))


def run(env, warm, cold, state, act, gen, steps: int):
    """The stress rollout with the gap at every step, the steps' draws
    from `gen` (a host generator: each step draws what its reset needs on
    the host and moves it to the device). Returns (gaps [steps, B] as
    numpy, largest control difference, final state)."""
    gaps, errs = [], []
    for _ in range(steps):
        gap, err = objective_gap(warm, cold, state, act)
        gaps.append(gap)
        errs.append(err)
        state, *_ = cbf_filtered_step(env, warm, state, act, generator=gen)
    return torch.stack(gaps).double().cpu().numpy(), float(torch.stack(errs).max()), state


def certificate(batch: int = 4, n_agents: int = 4, warm_iters: int = 6, soft_iters: int = 0,
                soft_cap: float = 10.0, cold_iters: int = 30, steps: int = 10,
                scenario: str = "cpm_entire", device=None):
    """The certificate's result line, and (env, warm filter, cold filter,
    final state, action) of its stress rollout."""
    dev = resolve_device(device)
    env, warm, cold, state, act, gen = stress_setup(batch, n_agents, warm_iters, soft_iters,
                                                    soft_cap, cold_iters, scenario, dev)
    gaps, max_err, state = run(env, warm, cold, state, act, gen, steps)
    line = {
        "check": "warm_start_certificate",
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "device": device_line(dev),
        "batch": batch,
        "n_agents": n_agents,
        "newton_iters": warm_iters,
        "soft_iters": soft_iters,
        "soft_cap": soft_cap,
        "cold_iters": cold_iters,
        "steps": steps,
        **certify(gaps, max_err),
    }
    return line, (env, warm, cold, state, act)


def parser(description: str) -> argparse.ArgumentParser:
    """The certificate's flags (JAX's, and `--device`)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n_agents", type=int, default=4)
    ap.add_argument("--warm-iters", type=int, default=6)
    ap.add_argument("--cold-iters", type=int, default=30)
    ap.add_argument("--soft-iters", type=int, default=0)
    ap.add_argument("--soft-cap", type=float, default=10.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scenario", default="cpm_entire")
    ap.add_argument("--device", default="cuda")
    return ap


def setup_args(args) -> tuple:
    """`certificate`'s (and `stress_setup`'s) arguments from the flags."""
    return (args.batch, args.n_agents, args.warm_iters, args.soft_iters, args.soft_cap,
            args.cold_iters, args.steps, args.scenario, args.device)


def main(argv=None) -> int:
    args = parser(__doc__.split("\n\n")[0]).parse_args(argv)
    line, _ = certificate(*setup_args(args))
    print(json.dumps(line))
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
