"""The port's tracing (`sigmarl_tpu_torch/trace.py`) on the CPU: nothing
recorded and no profiler range opened while it is off, spans' calls,
totals and self times and the counts' attribution while it is on, counts
diverted from a graph's capture, and a filtered step's spans on the
profiler's timeline."""

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.structs import zero_state
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

ENV_PHASES = ("dynamics", "geometry", "rewards", "paths", "done", "reset", "observe")
FILTER_PHASES = ("assemble", "solve", "finish")
# Phases of code more than one layer calls, named after the span they run in.
SUB_PHASES = {"geometry": ("agents", "boundaries", "collisions"),
              "reset": ("spawn", "geometry", "paths"), "reset.spawn": ("agent",)}
FILTER_SUB_PHASES = ("lanes", "rows")


@pytest.fixture
def fresh():
    """Tracing off and its aggregates empty, before and after the test."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture
def no_ranges(monkeypatch):
    """Any profiler range that the tracing opens raises."""
    def refuse(name):
        raise AssertionError(f"a profiler range was opened for {name!r}")

    monkeypatch.setattr(trace, "record_function", refuse)


class FakeClock:
    """`time.perf_counter_ns` that moves only when told."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now


def test_off_records_nothing_and_opens_no_range(fresh, no_ranges):
    @trace.span("decorated")
    def f(x):
        return x + 1

    with trace.span("outer"):
        trace.count("n", 2)
        assert f(1) == 2
    assert trace.span("outer") is trace.span("outer")  # the shared no-op
    assert trace.snapshot() == {"spans": {}, "counts": {"n": 2}}  # counts count always


def test_enabled_spans_nest_with_calls_totals_and_self_times(fresh, no_ranges, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(trace, "time", clock)
    trace.enable()

    @trace.span("a.leaf")
    def leaf(ns):
        clock.now += ns
        trace.count("k")

    with trace.span("a"):
        clock.now += 10
        leaf(5)
        trace.count("k", 3)
        with trace.span("a.b"):
            clock.now += 7
            leaf(2)
            trace.count("syncs")
        clock.now += 1
    leaf(4)  # a root span of its own
    trace.count("outside")

    snap = trace.snapshot()
    assert snap["counts"] == {"k": 6, "syncs": 1, "outside": 1}
    assert snap["spans"] == {
        "a": {"calls": 1, "total_ns": 25, "self_ns": 11, "counts": {"k": 3}},
        "a.leaf": {"calls": 3, "total_ns": 11, "self_ns": 11, "counts": {"k": 3}},
        "a.b": {"calls": 1, "total_ns": 9, "self_ns": 7, "counts": {"syncs": 1}},
    }
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counts": {}}


def test_a_leading_dot_joins_the_innermost_spans_name(fresh, no_ranges):
    trace.enable()

    @trace.span(".phase")
    def shared():
        trace.count("c")

    with trace.span("a"):
        shared()
        with trace.span(".b"):
            shared()
    shared()
    spans = trace.snapshot()["spans"]
    assert sorted(spans) == ["a", "a.b", "a.b.phase", "a.phase", "phase"]
    assert all(spans[n]["counts"] == {"c": 1} for n in ("a.phase", "a.b.phase", "phase"))


def test_a_span_closes_on_an_exception(fresh, no_ranges):
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("x"):
            raise ValueError("inside")
    with trace.span("y"):
        trace.count("c")
    spans = trace.snapshot()["spans"]
    assert spans["x"]["calls"] == 1 and spans["y"]["counts"] == {"c": 1}
    assert spans["y"]["self_ns"] == spans["y"]["total_ns"]  # `y` did not nest inside `x`


def test_count_sync_counts_only_on_a_card(fresh):
    trace.count_sync(torch.device("cpu"), 3)
    assert "syncs" not in trace.snapshot()["counts"]


def test_diverted_counts_go_to_its_dict_alone(fresh, no_ranges):
    """Counts inside `diverted()` (a graph's capture) reach its dict and
    neither the process's counts nor the open span's; outside it they
    count as before, nested sinks included."""
    trace.enable()
    with trace.span("outer"):
        with trace.diverted() as sink:
            trace.count("k1.launches")
            with trace.diverted() as inner:
                trace.count("k2.launches", 2)
            trace.count("k1.launches", 2)
        trace.count("k2.launches")
    assert sink == {"k1.launches": 3} and inner == {"k2.launches": 2}
    snap = trace.snapshot()
    assert snap["counts"] == {"k2.launches": 1}
    assert snap["spans"]["outer"]["counts"] == {"k2.launches": 1}


def test_the_profiler_flag_follows_a_session(fresh):
    """The flag `span` reads flips with a profiler session: a PyTorch that
    drops or renames it fails here instead of turning the tracing off."""
    assert autograd_profiler._is_profiler_enabled is False
    assert not trace._recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert trace._recording()
        assert isinstance(trace.span("s"), trace._Span)
    assert autograd_profiler._is_profiler_enabled is False
    assert isinstance(trace.span("s"), trace._Off)


@pytest.fixture(scope="module")
def filtered():
    """cpm_entire, N=4, B=2 on the CPU, episodes of 2 steps: the step from
    the all-zero state ends every episode and resets every env."""
    p = Parameters(
        scenario_type="cpm_entire", n_agents=4, num_vmas_envs=2, dt=0.1, max_steps=2,
        is_use_mtv_distance=False, is_obs_noise=False, is_using_cbf_testing=True,
        is_using_centralized_cbf=True,
    )
    env = make_env(p, device="cpu")
    cbf = CBFSafetyFilter(CBFConfig(n_agents=4, newton_iters=5, newton_soft_iters=3),
                          env.cfg, env.tables, device="cpu")
    return env, cbf


def _step(env, cbf, seed=0):
    g = torch.Generator().manual_seed(seed)
    act = (torch.rand((2, 4, 2), generator=g) - 0.3) * env.action_limits
    return cbf_filtered_step(env, cbf, zero_state(env.cfg, "cpu"), act, generator=g)


def test_a_filtered_step_puts_its_phases_on_the_profilers_timeline(fresh, filtered):
    env, cbf = filtered
    _step(env, cbf)  # untraced: leaves nothing behind
    assert trace.snapshot()["spans"] == {}
    resets = env.reset_steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(env, cbf)
    assert env.reset_steps == resets + 1
    _step(env, cbf)  # after the session: nothing more
    spans = trace.snapshot()["spans"]
    names = (["rollout_step", "filter", "env_step"] + [f"env_step.{p}" for p in ENV_PHASES]
             + [f"filter.{p}" for p in FILTER_PHASES]
             + [f"env_step.{p}.{q}" for p, sub in SUB_PHASES.items() for q in sub]
             + [f"filter.assemble.{q}" for q in FILTER_SUB_PHASES])
    assert sorted(spans) == sorted(names)
    # Once per agent placed in turn; the rows' lane (two sides), pair and
    # stacked parts.
    repeated = {"env_step.reset.spawn.agent": env.n_agents, "filter.assemble.rows": 4}
    assert all(spans[n]["calls"] == repeated.get(n, 1) for n in names)
    nested = [("env_step", ENV_PHASES), ("filter", FILTER_PHASES),
              ("filter.assemble", FILTER_SUB_PHASES)] + [
        (f"env_step.{p}", sub) for p, sub in SUB_PHASES.items()]
    for parent, phases in nested:
        children = sum(spans[f"{parent}.{p}"]["total_ns"] for p in phases)
        assert spans[parent]["self_ns"] == spans[parent]["total_ns"] - children >= 0

    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in spans:
            assert e.name() not in events or e.name() in repeated, f"{e.name()} recorded twice"
            events.setdefault(e.name(), (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(events) == sorted(names)
    for parent, phases in [("rollout_step", ("filter", "env_step"))] + nested:
        s0, s1 = events[parent]
        for p in phases:
            c0, c1 = events[p if parent == "rollout_step" else f"{parent}.{p}"]
            assert s0 <= c0 <= c1 <= s1, (parent, p)
