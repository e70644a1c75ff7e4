"""The standalone CBF studies of the port against the JAX package: the
LCSS'25 TTCBF/HOCBF sweep (`safety/hocbf_taylor.py`) and the ECC'25 MTV
safety-margin predictor (`safety/sm_predictor.py`), at small sizes on the
CPU. (The ECC'25 two-agent demo is held in `test_torch_cbf_demo.py`.)

Tolerances:
- sweep: min h per cell to 1e-4 relative (float32 over 150 steps); the
  collision flags equal on every cell whose min h lies farther than 1e-5
  from 0. Closer than that the agent rides the barrier (h = |r|^2 - 9,
  whose float32 resolution is 1e-6), and the flag follows the last bit of
  the two packages' rounding;
- predictor: value, gradient and Hessian from carried weights to 1e-5,
  1e-5 and 1e-4; two epochs from the same weights and permutations:
  losses to a relative 1e-5, weights to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.safety import hocbf_taylor as JH
from sigmarl_tpu.safety.sm_predictor import DistancePredictor as JNet
from sigmarl_tpu.safety.sm_predictor import SafetyMarginEstimatorModule as JSM
from sigmarl_tpu_torch.safety import hocbf_taylor as TH
from sigmarl_tpu_torch.safety.sm_predictor import SafetyMarginEstimatorModule as TSM
from sigmarl_tpu_torch.safety.sm_predictor import sm_predictor_from_jax_params, to_jax_params

torch.set_num_threads(1)
np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731


def _leaves_close(a, b, atol):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0)


@pytest.mark.parametrize("deg, approach", [(1, "taylor"), (1, "hocbf"), (2, "taylor"),
                                           (2, "hocbf"), (3, "taylor"), (3, "hocbf")])
def test_hocbf_sweep_matches_jax(deg, approach):
    """The LCSS'25 driver's grids (quick: 5 x 5, 150 steps), as one batched
    simulation against JAX's `vmap` over the grid."""
    kw = dict(relative_degree=deg, approach=approach, num_steps=150, lambda_2=3.0,
              lambda_1=0.5 if approach == "taylor" else 3.0)
    l1 = np.linspace(0.1, 1.0 if approach == "taylor" else 5.0, 5)
    dts = np.linspace(0.005, 0.05, 5)
    ref = JH.run_experiment_multi_parameters(JH.HOCBFConfig(**kw), l1, dts)
    ours = TH.run_experiment_multi_parameters(TH.HOCBFConfig(**kw), l1, dts, device="cpu")
    np.testing.assert_allclose(ours["lambda_1"], ref["lambda_1"], rtol=1e-6)
    h, h_ref = ours["h_min"], ref["h_min"]
    assert np.isfinite(h).all()
    np.testing.assert_allclose(h, h_ref, rtol=1e-4, atol=1e-4 * np.abs(h_ref).max())
    clear = np.abs(h_ref) > 1e-5
    np.testing.assert_array_equal(ours["collided"][clear], ref["collided"][clear])
    assert TH.check_initial_conditions(TH.HOCBFConfig(**kw)) == \
        JH.check_initial_conditions(JH.HOCBFConfig(**kw))


def test_sm_predictor_value_grad_hess_from_jax_weights():
    params = np_tree(JNet().init(jax.random.PRNGKey(1), jnp.zeros((1, 3))))
    jsm = JSM()
    jsm.params = params
    tsm = TSM(device="cpu")
    tsm.net = sm_predictor_from_jax_params(params, device="cpu")
    _leaves_close(to_jax_params(tsm.net), params, 0.0)
    rel = np.random.default_rng(0).uniform(-0.3, 0.3, (6, 3)).astype(np.float32)
    m, g, h = tsm.margin_grad_hess(torch.from_numpy(rel))
    mj, gj, hj = jax.jit(jsm.margin_grad_hess)(jnp.asarray(rel))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(gj), atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj), atol=1e-4)
    m1, g1, h1 = tsm.margin_grad_hess(torch.from_numpy(rel[0]))
    assert g1.shape == (3,) and h1.shape == (3, 3)
    np.testing.assert_allclose(h1.detach().numpy(), h[0].detach().numpy(), atol=1e-6)
    feats = torch.from_numpy(rel)
    np.testing.assert_allclose(tsm.exact_mtv(feats).numpy(),
                               np.asarray(jax.jit(jsm.exact_mtv)(jnp.asarray(rel))), atol=1e-6)


def test_sm_predictor_training_matches_jax():
    """Two epochs (15^3 grid, batches of 1024) from JAX's initial weights,
    split and epoch permutations (rebuilt from its key schedule)."""
    nv, bs, epochs = 15, 1024, 2
    jsm = JSM()
    j_err = jsm.train(num_values=nv, epochs=epochs, batch_size=bs)
    n = nv**3
    n_tr = n - int(n * 0.1)
    key = jax.random.PRNGKey(0)
    key, k_perm, k_init = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(k_perm, n))
    feats, _ = jsm.generate_training_data(nv)
    init = np_tree(JNet().init(k_init, feats[perm][int(n * 0.1):][:1]))
    epoch_perms = []
    for _ in range(epochs):
        key, k_e = jax.random.split(key)
        epoch_perms.append(torch.from_numpy(np.asarray(jax.random.permutation(k_e, n_tr))).long())
    tsm = TSM(device="cpu")
    t_err = tsm.train(num_values=nv, epochs=epochs, batch_size=bs,
                      init_net=sm_predictor_from_jax_params(init, device="cpu"),
                      perm=torch.from_numpy(perm).long(), epoch_perms=epoch_perms)
    np.testing.assert_allclose(tsm.train_losses_history, jsm.train_losses_history, rtol=1e-5)
    np.testing.assert_allclose(tsm.val_losses_history, jsm.val_losses_history, rtol=1e-5)
    np.testing.assert_allclose(t_err, j_err, rtol=1e-5)
    _leaves_close(to_jax_params(tsm.net), jsm.params, 1e-5)
