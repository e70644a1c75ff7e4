"""Device selection, the small constant tensors that per-step code reads
on a device, and seeded draws (the reference's copy of the port's
`device.py`, without the measuring helpers)."""

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


def moved(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`. Host draws go to the card through pinned memory,
    without waiting for the card (a copy from pageable memory would)."""
    device = torch.device(device)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def uniform(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Uniforms in [0, 1) of `shape` on `device`, drawn on the generator's
    own device and then moved: a host generator gives the same numbers
    whatever device the caller runs on (torch's CPU and CUDA generators
    draw different numbers from one seed). Without a generator, from the
    device's default one."""
    if generator is None:
        return torch.rand(shape, device=device)
    return moved(torch.rand(shape, generator=generator, device=generator.device), device)


def normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normals of `shape` on `device`, drawn as `uniform` draws."""
    return moved(torch.randn(shape, generator=generator, device=generator.device), device)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queue on a CUDA device; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
