"""Device selection shared by the port's entry points, the small
constant tensors that per-step code reads on a device, and what the
measuring programs report of the card: its name and power limit, and
where a call waits for it."""

from __future__ import annotations

import functools
import os
import subprocess
import warnings

import torch

# The checkout's root, against which `host_syncs` names files.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def uniform(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Uniforms in [0, 1) of `shape` on `device`, drawn on the generator's
    own device and then moved: a host generator gives the same numbers
    whatever device the caller runs on (torch's CPU and CUDA generators
    draw different numbers from one seed). Without a generator, from the
    device's default one."""
    if generator is None:
        return torch.rand(shape, device=device)
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queue on a CUDA device; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nvidia_smi_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_line(device: torch.device) -> str:
    """What a measurement ran on: the card's name and power limit, or
    "cpu"."""
    return nvidia_smi_line() if device.type == "cuda" else device.type


def host_syncs(fn) -> list:
    """The host syncs while `fn` runs on a CUDA device, as "file:line" of
    the code that waited (relative to the checkout's root): the warnings
    of PyTorch's sync debug mode, one per operation that waits for the
    card (a read of a value, a copy from pageable host memory)."""
    torch.cuda.synchronize()
    # The first switch of the mode in a process waits once itself.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, _ROOT)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]
