"""The ECC'25 two-agent CBF demo of the port (`safety/cbf_demo.py`)
against the JAX package's, at small sizes on the CPU: every scenario and
safety margin of the paper's grid and the RL nominal controller, and the
nominal's fit.

Tolerances:
- demo (60 steps, the interaction): collided equal, h_min to 1e-6, the
  states to 1e-3 and the inputs to 1e-2 (the steering rate saturates and
  switches, which amplifies float32 differences);
- the nominal fit: 3 Adam steps from the same weights and states, the loss
  to a relative 1e-4 (a mean over 512 float32 terms after tanh and atanh);
  at least 99 % of the weights within 1e-5 and all within 2 * lr * steps,
  as `test_torch_training.py` holds Adam's first steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.rl.networks import PolicyNet as JPolicyNet
from sigmarl_tpu.safety import cbf_demo as JD
from sigmarl_tpu.safety.sm_predictor import DistancePredictor as JNet
from sigmarl_tpu.safety.sm_predictor import SafetyMarginEstimatorModule as JSM
from sigmarl_tpu_torch.rl.networks import policy_from_jax_params
from sigmarl_tpu_torch.rl.networks import to_jax_params as policy_to_jax
from sigmarl_tpu_torch.safety import cbf_demo as TD
from sigmarl_tpu_torch.safety.sm_predictor import SafetyMarginEstimatorModule as TSM
from sigmarl_tpu_torch.safety.sm_predictor import sm_predictor_from_jax_params

torch.set_num_threads(1)
np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731


@pytest.fixture(scope="module")
def predictors():
    """The same random predictor weights in both packages (the demo's "mtv"
    margin needs a trained module only for meaningful margins)."""
    params = np_tree(JNet().init(jax.random.PRNGKey(1), jnp.zeros((1, 3))))
    jsm = JSM()
    jsm.params = params
    tsm = TSM(device="cpu")
    tsm.net = sm_predictor_from_jax_params(params, device="cpu")
    return jsm, tsm


@pytest.fixture(scope="module")
def rl_nominal():
    """JAX's RL nominal fit (3 steps) and the port's from the same weights
    and states."""
    key = jax.random.PRNGKey(0)
    cfg = JD.CBFDemoConfig(nominal="rl")
    j_params, j_loss = JD.fit_rl_nominal(cfg, key, n_steps=3)
    init = np_tree(JPolicyNet(act_dim=2).init(key, jnp.zeros((1, 9))))
    states = []
    for i in range(3):
        ks = jax.random.split(jax.random.fold_in(key, i), 5)
        states.append(torch.from_numpy(np.asarray(jnp.stack([
            jax.random.uniform(ks[0], (256,)) * 3.0,
            jax.random.uniform(ks[1], (256,), minval=-0.3, maxval=0.3),
            jax.random.uniform(ks[2], (256,), minval=-jnp.pi, maxval=jnp.pi),
            jax.random.uniform(ks[3], (256,), minval=-0.5, maxval=1.0),
            jax.random.uniform(ks[4], (256,), minval=-2.5, maxval=2.5),
        ], axis=-1))))
    t_policy, t_loss = TD.fit_rl_nominal(
        TD.CBFDemoConfig(nominal="rl"), n_steps=3, device="cpu",
        init_policy=policy_from_jax_params(init, device="cpu"), states=states)
    return np_tree(j_params), j_loss, t_policy, t_loss


def test_fit_rl_nominal_matches_jax(rl_nominal):
    j_params, j_loss, t_policy, t_loss = rl_nominal
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    diffs = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(policy_to_jax(t_policy)), jax.tree_util.tree_leaves(j_params))])
    assert (diffs <= 1e-5).mean() >= 0.99 and diffs.max() <= 2 * 3e-3 * 3
    s = torch.tensor([[0.5, 0.1, 0.2, 0.6, -0.1]])
    np.testing.assert_allclose(
        TD.rl_observation(TD.CBFDemoConfig(), s)[0].numpy(),
        np.asarray(JD.rl_observation(JD.CBFDemoConfig(), jnp.asarray(s[0].numpy()))), atol=1e-6)


@pytest.mark.parametrize("scenario, sm_type, nominal", [
    ("overtaking", "c2c", "scripted"), ("overtaking", "mtv", "scripted"),
    ("overtaking", "grid", "scripted"), ("bypassing", "c2c", "scripted"),
    ("bypassing", "mtv", "scripted"), ("bypassing", "grid", "scripted"),
    ("bypassing", "c2c", "rl"),
])
def test_run_demo_matches_jax(scenario, sm_type, nominal, predictors, rl_nominal):
    """Each scenario and margin of the ECC'25 grid, and the RL nominal
    (bypassing, which filters the other agent too)."""
    jsm, tsm = predictors
    j_params, _, t_policy, _ = rl_nominal
    kw = dict(scenario=scenario, sm_type=sm_type, nominal=nominal, num_steps=60)
    rl = nominal == "rl"
    ref = JD.run_demo(JD.CBFDemoConfig(**kw), sm_module=jsm,
                      rl_policy_params=j_params if rl else None)
    ours = TD.run_demo(TD.CBFDemoConfig(**kw), sm_module=tsm,
                       rl_policy_params=t_policy if rl else None, device="cpu")
    assert ours["collided"] == ref["collided"]
    np.testing.assert_allclose(ours["h_min"], ref["h_min"], atol=1e-6)
    for k in ("ego", "other"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-3, err_msg=k)
    for k in ("u", "u_nom"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-2, err_msg=k)
    np.testing.assert_allclose(ours["h"], ref["h"], atol=1e-4)
