"""The port's CBF filter against the control-parity goldens of the
original SigmaRL filter (`tests/golden/control_parity_n1.npz` and
`_n4.npz`: recorded states and the original filter's controls from a
float64 QP), held to the bounds `tests/test_control_deviation.py` holds
the JAX package to."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sigmarl_tpu_torch.env.structs import replace_state
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.qp import solve_structured_qp
from tests.torch_parity import envs, params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fixture", ["control_parity_n1.npz", "control_parity_n4.npz"])
def test_control_parity_goldens(fixture):
    """The original SigmaRL filter's controls (float64 QP) on its recorded
    trajectories, against the port's filter with fp16 parity and the lambda
    cost, computed as `scripts/control_deviation_check.py` computes the JAX
    package's two numbers that `tests/test_control_deviation.py` bounds:

    - parity mode, assembly and a 100-iteration solve in float64 with the
      slack stiffness uncapped: within 1e-3;
    - the production filter, its rows assembled in float32, solved at the
      production budget (2 + 8 iterations, stiffness cap 3e6, warm-started
      from the previous step's solution) in float64, as the JAX check's
      float64 bounds make its solve: within 5e-2."""
    z = np.load(os.path.join(ROOT, "tests", "golden", fixture))
    N, scenario = int(z["n_agents"]), str(z["scenario"])
    T, Bz = z["pos"].shape[:2]
    _, tenv = envs(**params(scenario, N, Bz, max_steps=10_000))
    cfg = dict(n_agents=N, dt=0.1, adaptive_lambda_cost=True, fp16_parity=True)
    prod = CBFSafetyFilter(CBFConfig(newton_iters=8, **cfg), tenv.cfg, tenv.tables, device="cpu")
    f64 = CBFSafetyFilter(CBFConfig(newton_iters=100, **cfg), tenv.cfg, tenv.tables, device="cpu")
    state0, _ = tenv.reset(generator=torch.Generator().manual_seed(0))
    w_u = (f64.cfg.w_u_acc, f64.cfg.w_u_steer)
    lo, hi = (f64.a_min, f64.rate_min), (f64.a_max, f64.rate_max)

    def as64(cons):
        return dataclasses.replace(cons, **{
            f.name: getattr(cons, f.name).double() for f in dataclasses.fields(cons)
            if isinstance(getattr(cons, f.name), torch.Tensor)
            and getattr(cons, f.name).is_floating_point()})

    dev_prod, dev64, u_prev = [], [], None
    for t in range(T):
        fields = {k: torch.from_numpy(z[k][t]) for k in ("pos", "rot", "speed", "steering",
                                                         "path_id")}
        state = replace_state(state0, **fields)
        act = torch.from_numpy(z["act"][t])
        cons, u_nom, _, _ = prod.assemble(state, act)
        u_prev, _ = solve_structured_qp(
            as64(cons), u_nom.double(), w_u, lo, hi, n_iters=8, u_init=u_prev,
            soft_iters=prod.cfg.newton_soft_iters, soft_cap=prod.cfg.newton_soft_cap)
        s64 = replace_state(state, **{k: v.double() for k, v in fields.items() if k != "path_id"})
        cons, u_nom, _, _ = f64.assemble(s64, act.double())
        u64, _ = solve_structured_qp(cons, u_nom, w_u, lo, hi, n_iters=100, ws_cap=1e12)
        dev_prod.append(np.abs(u_prev.numpy() - z["u_ref"][t]).max())
        dev64.append(np.abs(u64.numpy() - z["u_ref"][t]).max())
    assert max(dev64) <= 1e-3, max(dev64)
    assert max(dev_prod) <= 5e-2, max(dev_prod)
