"""The readers of the program's own spans and counters
(`metrics/traced_*.py`, `metrics/host_syncs.{rollout,train,filter.latency}.py`):
a traced CPU run of each cell reads them from the profiled stretch, and a
program without tracing (a tree before it) reads nothing and does not
raise."""

from __future__ import annotations

import sys

import pytest

from benchmark.run import reader
from benchmark.tests.conftest import CELLS, run_cell

PROGRAM_METRICS = {
    "cpm_entire_n15.rollout": ("traced_ms.env_step.reset.rollout",
                               "traced_ms.env_step.observe.rollout",
                               "traced_ms.env_step.geometry.rollout",
                               "traced_ms.filter.assemble.rollout", "host_syncs.rollout"),
    "cpm_mixed_n4.train": ("traced_s.env_step.train", "host_syncs.train"),
    "cpm_entire_n15.latency_b1": ("host_syncs.filter.latency",),
}
# Spans that may not run in a tiny CPU run's few traced steps (no env resets).
MAY_NOT_RUN = {"traced_ms.env_step.reset.rollout"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_programs_spans_and_counts(capsys, cell):
    from sigmarl_tpu_torch import trace

    trace.reset()  # earlier runs in this process leave their stretches
    rc, line, err = run_cell(capsys, cell, trace=1)
    assert rc == 0, err
    for name in PROGRAM_METRICS[cell]:
        if name in MAY_NOT_RUN and name not in line["metrics"]:
            continue
        value = line["metrics"][name]["value"]
        # A CPU run waits for no card: its syncs read 0; its spans take time.
        assert value == 0 if name.startswith("host_syncs") else value > 0, (name, value)


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    import sigmarl_tpu_torch

    monkeypatch.delattr(sigmarl_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "sigmarl_tpu_torch.trace", None)
    for name in sorted(n for names in PROGRAM_METRICS.values() for n in names):
        assert reader(name)({"traced_units": 16}) is None, name
