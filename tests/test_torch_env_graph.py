"""The env step's card path (`env/step_graphs.py`) as far as the CPU can
hold it: the phases its graphs capture make no tensor from host values
after a first step (on the card such a tensor is a copy from pageable
memory, which waits for the card and cannot be captured); the pack that
copies a step's outputs out in one clone, and the copy in; and the paths
that stay eager, the CPU's and a sharded batch's, with their phase spans
and without a graph counter."""

import dataclasses

import pytest
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.step_graphs import StepGraphs, _copy, _Pack

torch.set_num_threads(1)
B = 8
# The main path's scenario, the train cell's (cpm_mixed, observation noise),
# testing mode and the challenge buffer, at N=4.
CASES = {
    "main": dict(scenario_type="cpm_entire", is_obs_noise=False),
    "mixed_noise": dict(scenario_type="cpm_mixed", is_obs_noise=True),
    "testing": dict(scenario_type="cpm_entire", is_obs_noise=False, is_testing_mode=True),
    "challenge": dict(scenario_type="cpm_entire", is_obs_noise=False,
                      is_challenging_initial_state_buffer=True),
}
PHASES = ("dynamics", "geometry", "rewards", "paths", "done", "reset", "observe")


def _env(case, shard=None):
    p = Parameters(n_agents=4, num_vmas_envs=B, dt=0.1, max_steps=1_000_000,
                   is_use_mtv_distance=False, device="cpu", **CASES[case])
    return make_env(p, device="cpu", shard=shard)


def _actions(env, g):
    return (torch.rand((B, env.n_agents, 2), generator=g) - 0.3) * env.action_limits


def _refuse_host_values(*args, **kw):
    raise AssertionError("an env-step phase made a tensor from host values")


@pytest.mark.parametrize("case", list(CASES))
def test_the_graphed_phases_make_no_tensor_from_host_values(monkeypatch, case):
    """After a first step, the six phases the card captures (`StepGraphs.
    _phases`: dynamics to done, then the observation) run with
    `torch.tensor` and `torch.as_tensor` raising, and give what they give
    with them."""
    env = _env(case)
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset(generator=g)
    state, *_ = env.step(state, _actions(env, g), generator=g)
    act = _actions(env, g)
    record_u = env._record_u(None, g)
    noise = (torch.rand((B, env.n_agents, env.obs_dim), generator=g)
             if env.cfg.is_obs_noise else None)

    def run():
        carry = dict(state=state, actions=act, record_u=record_u, noise=noise)
        for phase in StepGraphs._phases(env):
            phase(carry)
        return carry

    want = run()
    monkeypatch.setattr(torch, "tensor", _refuse_host_values)
    monkeypatch.setattr(torch, "as_tensor", _refuse_host_values)
    got = run()
    monkeypatch.undo()
    assert set(got) == set(want)
    for key, a in got.items():
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, want[key]), key
    for f in dataclasses.fields(got["state"]):
        assert torch.equal(getattr(got["state"], f.name), getattr(want["state"], f.name)), f.name
    for k, v in got["info"].items():
        assert torch.equal(v, want["info"][k]), k


def test_the_pack_copies_out_every_output_in_one_buffer():
    """`_Pack` lays tensors of several dtypes and shapes (a scalar, an
    empty one, a strided view) out in one byte buffer: `unpack` of a copy
    gives each back, equal, as views of that copy; `_copy` copies inputs
    in, contiguous and strided alike, and skips a tensor onto itself."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((6, 5), generator=g)
    parts = [[torch.rand(3, generator=g), torch.tensor(True), x[:, 1:3], torch.arange(7)],
             [torch.zeros((0, 4, 2)), torch.ones((2, 2), dtype=torch.bool), torch.tensor(5,
              dtype=torch.int32), torch.rand((4, 3), generator=g).double()]]
    pack = _Pack(parts, torch.device("cpu"))
    for i, part in enumerate(parts):
        pack.write(i, part)
    copy = pack.buffer.clone()
    got = pack.unpack(copy)
    for tensors, back in zip(parts, got):
        for a, b in zip(tensors, back):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            assert b.untyped_storage().data_ptr() == copy.untyped_storage().data_ptr()
    with pytest.raises(RuntimeError):
        pack.write(0, parts[1])
    dst = [torch.zeros(3), torch.zeros((6, 5))[:, 1:3], torch.zeros(7, dtype=torch.int64)]
    src = [parts[0][0], x[:, 1:3], parts[0][3]]
    same = dst[0]
    _copy(dst + [same], src + [same])
    assert all(torch.equal(a, b) for a, b in zip(dst, src))


class _OneRank:
    """A sharded batch's rank as `parallel.mesh.Shard` gives it, for one
    rank: the collectives return this rank's own tensors."""

    rank, world = 0, 1

    def env_slice(self, B):
        return slice(0, B)

    def all_gather(self, x):
        return x.detach().clone()


@pytest.mark.parametrize("sharded", [False, True])
def test_the_cpu_and_a_sharded_step_run_the_eager_body(sharded):
    """On the CPU, unsharded or with a shard (whose phases hold
    collectives), every step runs the phases op by op: each phase span
    and the geometry's sub-spans open once a step, reset steps open
    `env_step.reset`, and the graph counters stay 0; the sharded step at
    one rank gives the unsharded one's numbers."""
    env = _env("challenge", _OneRank() if sharded else None)
    ref = _env("challenge")
    state, _ = env.reset(generator=torch.Generator().manual_seed(1))
    ref_state, _ = ref.reset(generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    steps = 12
    trace.reset()
    for _ in range(steps):
        act = _actions(env, g)
        draws = ResetDraws.sample(env.cfg, g, "cpu", state.cb_valid)
        draws.record_u = torch.rand((), generator=g)
        trace.enable()
        try:
            state, obs, reward, done, _ = env.step(state, act, generator=g, reset_draws=draws)
        finally:
            trace.disable()
        ref_state, ref_obs, ref_reward, ref_done, _ = ref.step(ref_state, act, reset_draws=draws)
        assert torch.equal(obs, ref_obs) and torch.equal(reward, ref_reward)
        assert torch.equal(done, ref_done)
    snap = trace.snapshot()
    trace.reset()
    spans = snap["spans"]
    for phase in PHASES:
        want = env.reset_steps if phase == "reset" else steps
        assert spans.get(f"env_step.{phase}", {}).get("calls", 0) == want, phase
    for sub in ("agents", "boundaries", "collisions"):
        assert spans[f"env_step.geometry.{sub}"]["calls"] == steps
    assert env.reset_steps > 0
    assert not any(k.startswith("env_step.graph.") for k in snap["counts"])
    assert not env._graphs
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state, f.name), getattr(ref_state, f.name)), f.name
