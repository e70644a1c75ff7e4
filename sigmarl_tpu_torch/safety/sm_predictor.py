"""MTV safety-margin neural predictor (ECC'25).

A small twice-differentiable MLP (3 -> 64 -> 64 -> 1, Tanh) predicts the
SAT/MTV-based distance between two rectangles from their relative pose
(x_rel, y_rel, psi_rel), trained on a grid of exact MTV distances, as the
original SigmaRL's `mtv_based_sm_predictor.py` does. The ECC'25 two-agent
CBF demo (`safety/cbf_demo.py`) needs first and second derivatives of the
margin: `margin_grad_hess` takes them with `torch.func` (grad and hessian
under vmap).

`sm_predictor_from_jax_params` carries the weights of the JAX package's
flax predictor over (flax `Dense.kernel` is [in, out], the transpose of
`nn.Linear.weight`); `to_jax_params` gives them back in that layout.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sigmarl_tpu_torch.core.geometry import mtv_distances, rectangle_vertices
from sigmarl_tpu_torch.device import resolve_device
from sigmarl_tpu_torch.rl.networks import MLP
from sigmarl_tpu_torch.rl.optim import Adam

Tensor = torch.Tensor
HIDDEN = (64, 64)


class DistancePredictor(nn.Module):
    """3 -> 64 -> 64 -> 1 Tanh MLP (second-order differentiable), flax's
    `Dense` initialization drawn from `seed`."""

    def __init__(self, hidden: Sequence[int] = HIDDEN, device=None, seed: int = 0):
        super().__init__()
        self.mlp = MLP([3, *hidden, 1], resolve_device(device), seed)

    def forward(self, x: Tensor) -> Tensor:
        return self.mlp(x)


def sm_predictor_from_jax_params(params_np: Mapping, device=None) -> DistancePredictor:
    """A `DistancePredictor` holding the weights of the JAX package's flax
    predictor tree {"params": {"Dense_k": {"kernel", "bias"}}} (numpy)."""
    tree = params_np.get("params", params_np)
    names = sorted(tree, key=lambda s: int(s.split("_")[-1]))
    kernels = [np.asarray(tree[n]["kernel"], np.float32) for n in names]
    net = DistancePredictor([k.shape[1] for k in kernels[:-1]], device=device)
    with torch.no_grad():
        for layer, n, k in zip(net.mlp.layers, names, kernels):
            layer.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(tree[n]["bias"], np.float32)))
    return net


def to_jax_params(net: DistancePredictor) -> dict:
    """The flax parameter tree of `net`, as numpy arrays."""
    return {"params": {
        f"Dense_{k}": {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                       "bias": layer.bias.detach().cpu().numpy().copy()}
        for k, layer in enumerate(net.mlp.layers)
    }}


@dataclass
class SafetyMarginEstimatorModule:
    """Train and evaluate the rectangle safety-margin predictor on `device`
    (`cuda` unless the caller passes `device="cpu"`).

    Features are normalized as the original's are: positions by the
    rectangle length, heading by pi; samples cover a square of side
    2 (2 r + l / 2) around the ego rectangle.
    """

    length: float = 0.16
    width: float = 0.08
    path_nn: str = "checkpoints/sm_predictor.pkl"
    device: Optional[str] = None
    net: Optional[DistancePredictor] = None
    error_upper_bound: Optional[float] = None
    train_losses_history: list = field(default_factory=list)
    val_losses_history: list = field(default_factory=list)

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        self.radius = float(np.sqrt(self.length**2 + self.width**2) / 2)
        offset = 0.5 * self.length
        self.x_max = 2 * self.radius + offset
        self.y_max = 2 * self.radius + offset
        self.feature_normalizer = torch.tensor(
            [self.length, self.length, np.pi], dtype=torch.float32, device=self.dev)
        self.label_normalizer = self.length

    # ------------------------------------------------------------------ data
    def exact_mtv(self, features: Tensor) -> Tensor:
        """Exact MTV distance for relative poses [..., 3] = (x, y, psi)."""
        zeros = torch.zeros(features.shape[:-1], dtype=features.dtype, device=features.device)
        v1 = rectangle_vertices(torch.zeros(features.shape[:-1] + (2,), dtype=features.dtype,
                                            device=features.device),
                                zeros, self.width, self.length, True)
        v2 = rectangle_vertices(features[..., 0:2], features[..., 2], self.width, self.length, True)
        return mtv_distances(torch.stack([v1, v2], dim=-3))[..., 0, 1]

    def generate_training_data(self, num_values: int = 41) -> Tuple[Tensor, Tensor]:
        """Grid of relative poses with exact MTV labels, normalized:
        (features [num_values^3, 3], labels [num_values^3, 1])."""
        xs = np.linspace(-self.x_max, self.x_max, num_values)
        ys = np.linspace(-self.y_max, self.y_max, num_values)
        hs = np.linspace(-np.pi, np.pi, num_values)
        X, Y, H = np.meshgrid(xs, ys, hs, indexing="ij")
        features = torch.as_tensor(np.column_stack([X.ravel(), Y.ravel(), H.ravel()]),
                                   dtype=torch.float32, device=self.dev)
        labels = self.exact_mtv(features)[..., None]
        return features / self.feature_normalizer, labels / self.label_normalizer

    # ----------------------------------------------------------------- train
    def train(
        self,
        num_values: int = 41,
        epochs: int = 200,
        batch_size: int = 4096,
        lr: float = 1e-3,
        val_fraction: float = 0.1,
        seed: int = 0,
        verbose: bool = False,
        generator: Optional[torch.Generator] = None,
        init_net: Optional[DistancePredictor] = None,
        perm: Optional[Tensor] = None,
        epoch_perms: Optional[List[Tensor]] = None,
    ) -> float:
        """Adam on the MSE of normalized distances over minibatches of the
        training split; returns the validation set's largest error [m]
        (the margin the ECC'25 controller subtracts).

        The split's permutation `perm`, each epoch's permutation of the
        training rows (`epoch_perms`) and the initial weights (`init_net`)
        may be given; otherwise they come from `generator` (seeded with
        `seed` when absent) and `DistancePredictor(seed=seed)`."""
        features, labels = self.generate_training_data(num_values)
        n = features.shape[0]
        gen = generator or torch.Generator(device=self.dev).manual_seed(seed)
        if perm is None:
            perm = torch.randperm(n, generator=gen, device=self.dev)
        perm = perm.to(self.dev)
        features, labels = features[perm], labels[perm]
        n_val = int(n * val_fraction)
        f_val, l_val = features[:n_val], labels[:n_val]
        f_tr, l_tr = features[n_val:], labels[n_val:]

        net = init_net.to(self.dev) if init_net is not None else DistancePredictor(
            device=self.dev, seed=seed)
        params = list(net.parameters())
        opt = Adam(lr)
        state = opt.init(params)
        n_tr = f_tr.shape[0]
        steps_per_epoch = max(1, n_tr // batch_size)
        for epoch in range(epochs):
            if epoch_perms is not None:
                p_e = epoch_perms[epoch].to(self.dev)
            else:
                p_e = torch.randperm(n_tr, generator=gen, device=self.dev)
            losses = []
            for i in range(steps_per_epoch):
                idx = p_e[i * batch_size:(i + 1) * batch_size]
                loss = torch.mean((net(f_tr[idx]) - l_tr[idx]) ** 2)
                grads = torch.autograd.grad(loss, params)
                state = opt.step(params, grads, state)
                losses.append(loss.detach())
            with torch.no_grad():
                val_loss = torch.mean((net(f_val) - l_val) ** 2)
            # One host read per epoch.
            ep, vl = torch.stack([torch.stack(losses).mean(), val_loss]).tolist()
            self.train_losses_history.append(ep)
            self.val_losses_history.append(vl)
            if verbose and epoch % 20 == 0:
                print(f"epoch {epoch}: train {ep:.6f} val {vl:.6f}")
        self.net = net
        with torch.no_grad():
            err = torch.abs(net(f_val) - l_val) * self.label_normalizer
        self.error_upper_bound = float(err.max())
        return self.error_upper_bound

    # ------------------------------------------------------------- inference
    def predict(self, rel_pose: Tensor) -> Tensor:
        """Predicted safety margin [m] for relative poses [..., 3]."""
        return self.net(rel_pose / self.feature_normalizer)[..., 0] * self.label_normalizer

    def margin_grad_hess(self, rel_pose: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(margin, gradient [3], Hessian [3, 3]) with respect to the
        relative pose, for one pose [3] or a batch [M, 3]."""
        f, grad, hess = self.predict, torch.func.grad(self.predict), torch.func.hessian(self.predict)
        if rel_pose.dim() == 1:
            return f(rel_pose), grad(rel_pose), hess(rel_pose)
        return f(rel_pose), torch.func.vmap(grad)(rel_pose), torch.func.vmap(hess)(rel_pose)

    # ----------------------------------------------------------------- io
    def save(self, path: Optional[str] = None):
        """Pickle the weights as a flax tree of numpy arrays (the layout the
        JAX package saves), with the error bound and the rectangle."""
        path = path or self.path_nn
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump({"params": to_jax_params(self.net),
                         "error_upper_bound": self.error_upper_bound,
                         "length": self.length, "width": self.width}, fh)

    def load(self, path: Optional[str] = None) -> bool:
        path = path or self.path_nn
        if not os.path.exists(path):
            return False
        with open(path, "rb") as fh:
            data = pickle.load(fh)
        self.net = sm_predictor_from_jax_params(data["params"], device=self.dev)
        self.error_upper_bound = data["error_upper_bound"]
        return True
