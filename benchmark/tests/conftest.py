"""What the benchmark's own tests share: tiny sizes for a CPU run of
each cell, and a run's parsed result line.

Run from the repository's root: `python -m pytest benchmark/tests -q`.
Tests marked `gpu` run on the card (`python -m pytest -m gpu
benchmark/tests`) and skip here."""

from __future__ import annotations

import json

import pytest
import torch

CELLS = ("cpm_entire_n15.rollout", "cpm_mixed_n4.train", "cpm_entire_n15.latency_b1")
SEED = 3_000_000_123  # past 32 signed bits: seeds may be that large

TINY = {
    "cpm_entire_n15.rollout": {
        "config": {"parameters": {"n_agents": 4}},
        "traffic": {"batch": 4, "warmup_steps": 2, "sampled_steps": 2, "sample_below": 2,
                    "traced_steps": 2}},
    "cpm_entire_n15.latency_b1": {
        "config": {"parameters": {"n_agents": 4}},
        "traffic": {"warmup_steps": 2, "sampled_steps": 2, "sample_below": 2, "traced_steps": 2}},
    "cpm_mixed_n4.train": {
        "config": {"parameters": {"max_steps": 8, "num_epochs": 2, "minibatch_size": 16}},
        "traffic": {"batch": 4, "sampled_iteration_below": 2}},
}


def run_cell(capsys, cell: str, trace: int = 0, control=None, seconds: float = 0.5,
             seed: int = SEED):
    """One CPU run of `cell` at its tiny size: (exit code, parsed last line
    of standard output or None, standard error)."""
    from benchmark import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", overrides=TINY[cell], control=control)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
