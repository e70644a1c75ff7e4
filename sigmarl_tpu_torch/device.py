"""Device selection shared by the port's entry points, and the small
constant tensors that per-step code reads on a device."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another. Asking for `cuda` (or nothing) on a machine without a card
    raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    # With its index, so that it compares equal to a tensor's device.
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=64)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`torch.tensor(values)` on `device`, made once per (values, dtype,
    device) and shared by every caller, which must not write to it. Code
    that runs every step takes its constants from here: a tensor made anew
    from host values is a copy from pageable host memory, and such a copy
    waits until the card has run everything queued before it."""
    return torch.tensor(values, dtype=dtype, device=device)
