"""The optimizers: the trainer's global-norm clipping, then Adam with a
linearly decaying learning rate (`ClippedAdam`), and plain Adam at a
constant rate (`Adam`, optax's `adam(lr)`).

`ClippedAdam` reproduces the JAX package's optax chain
`chain(clip_by_global_norm(max_grad_norm), adam(lr_schedule))` step for
step:

- one global norm over all parameters given together (policy, critic and,
  under XP-MARL, the priority networks form one tree there); gradients
  are kept as they are when the norm is below `max_grad_norm` and scaled
  by `max_grad_norm / norm` otherwise (`g / norm * max`, with no epsilon);
- Adam with b1=0.9, b2=0.999, eps=1e-8, eps_root=0 and optax's bias
  correction, `m / (1 - b1^k)` and `v / (1 - b2^k)` at step k;
- the learning rate `lr_min + (lr - lr_min) * (1 - (count //
  updates_per_iter) / n_iters)`, read at the update count before it is
  incremented.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

Tensor = torch.Tensor
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, as the JAX chain uses them


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: List[Tensor]
    nu: List[Tensor]


class Adam:
    """optax's `adam(lr)` at a constant learning rate, with no clipping (the
    learned-CBF module's optimizer)."""

    def __init__(self, lr: float):
        self.lr = lr

    def learning_rate(self, count: int) -> float:
        return self.lr

    def init(self, params: Sequence[Tensor]) -> AdamState:
        """Fresh moments (zeros) for `params`."""
        return AdamState(
            0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
        )

    @torch.no_grad()
    def step(self, params: Sequence[Tensor], grads: Sequence[Tensor], state: AdamState) -> AdamState:
        """Apply one Adam update to `params` in place; returns the new
        state. Runs on the parameters' device without a host sync."""
        k = state.count + 1
        bc1, bc2 = 1 - B1**k, 1 - B2**k
        step_size = -self.learning_rate(state.count)
        mu, nu = [], []
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m = (1 - B1) * g + B1 * m
            v = (1 - B2) * (g * g) + B2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            p.add_(step_size * u)
            mu.append(m)
            nu.append(v)
        return AdamState(k, mu, nu)


class ClippedAdam(Adam):
    """The trainer's chain: global-norm clipping, then Adam at the linear
    schedule."""

    def __init__(
        self,
        max_grad_norm: float,
        lr: float,
        lr_min: float,
        updates_per_iter: int,
        n_iters: int,
    ):
        super().__init__(lr)
        self.max_grad_norm = max_grad_norm
        self.lr_min = lr_min
        self.updates_per_iter, self.n_iters = updates_per_iter, n_iters

    def learning_rate(self, count: int) -> float:
        frac = 1.0 - (count // self.updates_per_iter) / self.n_iters
        return self.lr_min + (self.lr - self.lr_min) * frac

    @torch.no_grad()
    def step(self, params: Sequence[Tensor], grads: Sequence[Tensor], state: AdamState) -> AdamState:
        """Clip the gradients by their global norm, then one Adam update."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.max_grad_norm
        grads = [torch.where(keep, g, g / norm * self.max_grad_norm) for g in grads]
        return super().step(params, grads, state)
