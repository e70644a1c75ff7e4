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

Both run in PyTorch's multi-tensor idiom (`torch._foreach_*` over the
parameter list) and update the parameters and the moments in place, so
their addresses stay fixed and a captured CUDA graph can replay the step
(`rl/update_program.py`). The arithmetic is that of one parameter at a
time, in the same order: `m = (1 - b1) g + b1 m` as two products and a
sum, the global norm as Python's left-to-right sum of the per-tensor sums
of squares. The step's three scalars (the step size `-lr(count)` and the
two bias corrections) are host floats in `step`, or 0-dim tensors of a
device table (`schedule`) in a captured step, which reads them at run
time.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

Tensor = torch.Tensor
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, as the JAX chain uses them


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: List[Tensor]  # updated in place by `step`
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

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """(step size, 1 - b1^k, 1 - b2^k) of the update at `count`, k =
        count + 1, as host floats."""
        k = count + 1
        return -self.learning_rate(count), 1 - B1**k, 1 - B2**k

    def schedule(self, first: int, n: int, dtype=torch.float32) -> Tensor:
        """The scalars of the updates at counts first .. first + n - 1 as an
        [n, 3] host tensor of `dtype`, each computed as `scalars` computes
        it and then rounded once: the table a captured step reads its row
        of."""
        return torch.tensor([self.scalars(c) for c in range(first, first + n)], dtype=dtype)

    @torch.no_grad()
    def step(self, params: Sequence[Tensor], grads: Sequence[Tensor], state: AdamState) -> AdamState:
        """Apply one update to `params` and the moments in place; returns
        the state at the next count. Runs on the parameters' device without
        a host sync."""
        self.apply(params, grads, state.mu, state.nu, *self.scalars(state.count))
        return AdamState(state.count + 1, state.mu, state.nu)

    @torch.no_grad()
    def apply(self, params, grads, mu, nu, step_size, bc1, bc2) -> None:
        """One Adam update of `params`, `mu` and `nu` in place; the three
        scalars are floats or 0-dim tensors."""
        g1 = torch._foreach_mul(grads, 1 - B1)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g1)  # (1 - b1) g + b1 m
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - B2)
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, g2)  # (1 - b2) g^2 + b2 v
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, step_size)
        torch._foreach_add_(params, u)


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
    def apply(self, params, grads, mu, nu, step_size, bc1, bc2) -> None:
        """Clip the gradients by their global norm, then one Adam update."""
        sq = torch._foreach_mul(grads, grads)
        norm = torch.sqrt(sum(s.sum() for s in sq))
        keep = norm < self.max_grad_norm
        scaled = torch._foreach_div(grads, norm)
        torch._foreach_mul_(scaled, self.max_grad_norm)
        grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
        super().apply(params, grads, mu, nu, step_size, bc1, bc2)
