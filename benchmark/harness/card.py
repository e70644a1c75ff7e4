"""The card a run measures, and what the result line says of it."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    """The machine has fewer CUDA devices than the cell asks for."""


def require_cards(count: int) -> torch.device:
    """The first card, where the machine holds at least `count`; raises
    NoCard otherwise (a measurement never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell needs {count}")
    return torch.device("cuda", 0)


def power_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card, or why it
    could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if out.returncode != 0:
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip().splitlines()[0]


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_record(dev: torch.device, count: int) -> dict:
    """The result line's `device`: platform, kind (the card's name as
    PyTorch gives it), count and the peak of allocated memory, with the
    power limit beside them. On the CPU (the harness's tests only) the
    platform says so and there is no peak."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "nvidia_smi": power_line()}
