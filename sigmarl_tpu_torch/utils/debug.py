"""Debug-mode numerics guards, gated by `Parameters.debug_numerics`.

- `enable_debug_numerics()` turns on autograd's anomaly detection
  (`torch.autograd.set_detect_anomaly(True)`, for the whole process): a
  backward pass that produces NaN raises at the operation that made it, with
  the forward traceback of that operation. It is the nearest counterpart of
  JAX's `jax_debug_nans`, which re-runs a program op by op when it produces
  a NaN; PyTorch runs eagerly, so only the backward pass needs the mode.
- `assert_finite(x, name)` raises `FloatingPointError` naming the tensor
  and its count of non-finite values. It reads the count on the host, so
  on the card it waits for the device.

Callers test the flag before calling either, so nothing on the normal path
pays for them.
"""

from __future__ import annotations

import torch


def enable_debug_numerics() -> None:
    torch.autograd.set_detect_anomaly(True)


def assert_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        raise FloatingPointError(f"debug_numerics: {bad} non-finite values in '{name}'")
    return x
