"""The port's checks and measurements on the card, shared by the card
tests (`tests/test_torch_gpu.py`), the card run `chip_smoke.py` and the
profiling scripts under `scripts/`: the training configurations they run,
CUDA-event timers, the main path's inputs to K1 and K2, K1's inputs with
near-zero CLF rows, one testing-mode, CLF-filtered, fp16-parity step on
the card against the same step on the CPU, the challenge buffer's record
and replay steps on the card against the CPU, a step whose reset spawn is
compacted on the card against the CPU, the trainer's update as a graph
replay against the same update run eagerly, a sharded training
iteration against the unsharded one, and the host's launches of a call.
The configurations import on any device; the checks and timers need a
CUDA device."""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple

import numpy as np
import torch

from sigmarl_tpu_torch.safety.qp import StructuredConstraintSet

# The training configurations of the card run (`chip_smoke.py`) and
# `scripts/profile_torch_training.py`. The informed one is the paper's
# reward sweep (`sigmarl_tpu/eval/papers.py:278-285`), observation noise on
# as `Parameters` has it; the XP-MARL one the ICRA'25 priority comparison
# (`papers.py:105-111`), learned priority; opponent modeling the same
# setting with its pad instead.
INFORMED_TRAINING = dict(
    scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=32, dt=0.1, max_steps=128,
    num_epochs=30, minibatch_size=512, is_use_mtv_distance=False,
    rew_method="cbf", h_nom=0.2, is_using_cbf_training=True, is_solve_qp=False,
)
XPMARL_TRAINING = dict(
    scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=32, dt=0.1, max_steps=128,
    num_epochs=30, minibatch_size=512, is_use_mtv_distance=False,
    is_using_prioritized_marl=True, prioritization_method="marl",
)
OPPONENT_TRAINING = {**XPMARL_TRAINING, "is_using_prioritized_marl": False,
                     "is_using_opponent_modeling": True}
# Learned priority with a CBF-filtered rollout at the main path's width, on
# the `Parameters` defaults (MTV distance and observation noise on).
WIDE_XPMARL_TRAINING = dict(
    scenario_type="cpm_entire", n_agents=15, num_vmas_envs=1024, dt=0.1, max_steps=16,
    num_epochs=1, minibatch_size=4096, is_using_prioritized_marl=True,
    prioritization_method="marl", is_communication_noise=True, is_using_cbf_training=True,
    is_solve_qp=True, is_apply_cbf_action=True, is_using_centralized_cbf=True,
)
# CBF-filtered training at the main path's width: the benchmark's
# `cpm_entire_n15_cbf_train` configuration.
FILTERED_TRAINING = dict(
    scenario_type="cpm_entire", n_agents=15, num_vmas_envs=1024, dt=0.1, max_steps=16,
    num_epochs=1, minibatch_size=4096, is_use_mtv_distance=False, is_obs_noise=False,
    rew_method="cbf", is_using_cbf_training=True, is_solve_qp=True, is_apply_cbf_action=True,
    is_using_centralized_cbf=True,
)

# The CLF errors that `near_zero_clf_rows` puts in: rows of norm at most 1e-6.
NEAR_ZERO_ERRORS = (0.0, 1e-9, -1e-9, 1e-7, -1e-7, 5e-7, -5e-7, 1e-6)


class Check(NamedTuple):
    """One measured quantity, its limit and whether it is within it."""

    what: str
    value: float
    limit: float
    ok: bool


def near_zero_clf_rows(cons: StructuredConstraintSet, lam_clf: float,
                       seed: int) -> StructuredConstraintSet:
    """`cons` with a third of the agents' CLF errors (e_head, e_speed) set
    from `NEAR_ZERO_ERRORS`: CLF rows of norm at most 1e-6, which the row
    normalization turns into slack weights near 1e-12 and large b / norm,
    where K1's fast division leaves its ranges."""
    rng = np.random.default_rng(seed)
    B, N = cons.A_s.shape[:2]
    dev = cons.A_s.device
    pick = torch.tensor(rng.random((B, N)) < 1 / 3, device=dev)
    e = torch.tensor(rng.choice(NEAR_ZERO_ERRORS, (B, N, 2)), dtype=torch.float32, device=dev)
    A_s, b_s = cons.A_s.clone(), cons.b_s.clone()
    A_s[:, :, -2, 1] = torch.where(pick, e[..., 0], A_s[:, :, -2, 1])
    A_s[:, :, -1, 0] = torch.where(pick, e[..., 1], A_s[:, :, -1, 0])
    b_s[:, :, -2:] = torch.where(pick[..., None], -lam_clf / 2 * e * e, b_s[:, :, -2:])
    return dataclasses.replace(cons, A_s=A_s, b_s=b_s)


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls on
    the card (CUDA events), after one call to warm up. A call that runs
    shorter on the card than it
    costs the host to launch (a wrapper call costs tens of microseconds)
    is then timed at the host's launch rate. With `queued`, a spin of ~50
    ms on the card goes first, so the host queues the calls while the card
    is busy and the window times the card's work alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_windows(fn, reps: int, windows: int = 7, queued: bool = False) -> dict:
    """Median, least and largest of `windows` CUDA-event windows of `reps`
    calls each (milliseconds per call)."""
    times = sorted(cuda_ms(fn, reps, queued=queued) for _ in range(windows))
    return dict(ms=times[len(times) // 2], ms_min=times[0], ms_max=times[-1])


# The host's calls that put work on the card's queue: kernel launches,
# copies, sets and graph launches.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch")


def host_launches(fn) -> tuple:
    """(fn's result, the calls of `LAUNCH_CALLS` the host made while it
    ran, by name), from the profiler's record of the CUDA API's calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS}
    return out, calls


def env_graph_counts(before: dict | None = None) -> dict:
    """The env step's graph counters (`env/step_graphs.py`): captures and
    replays, since the counts `before` (a `trace.snapshot()["counts"]`)."""
    from sigmarl_tpu_torch import trace

    now, before = trace.snapshot()["counts"], before or {}
    return {k: now.get(f"env_step.graph.{k}", 0) - before.get(f"env_step.graph.{k}", 0)
            for k in ("captures", "replays")}


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| / (1 + |b|), in float64."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def rollout(env, cbf, policy, gen, state, obs, steps: int):
    """`steps` steps of the main path's loop (`bench.filtered_step`);
    returns the final state and obs, and whether obs, rewards and u*
    stayed finite."""
    from sigmarl_tpu_torch.bench import filtered_step

    finite = torch.ones((), dtype=torch.bool, device=obs.device)
    for _ in range(steps):
        state, obs, rew, _ = filtered_step(env, cbf, policy, state, obs, gen)
        finite &= torch.isfinite(obs).all() & torch.isfinite(rew).all()
        finite &= torch.isfinite(state.cbf_u_prev).all()
    return state, obs, bool(finite)


def env_step_launches(env, cbf, policy, gen, state, obs, steps: int):
    """`steps` steps of the main path's loop with each env step's host
    launches counted (`host_launches`): [(whether its reset ran, {call:
    n})], the final state and obs."""
    inner, out = env.step, []

    def counted(*args, **kw):
        before = env.reset_steps
        res, calls = host_launches(lambda: inner(*args, **kw))
        out.append((env.reset_steps > before, calls))
        return res

    env.step = counted
    try:
        state, obs, _ = rollout(env, cbf, policy, gen, state, obs, steps)
    finally:
        del env.step
    return out, state, obs


def warm_main_path(batch: int = 1024, n_agents: int = 15, steps: int = 8):
    """The main path on the card (`bench.main_path`, 3+5) after `steps`
    filtered steps from the all-zero state: (env, filter, policy,
    generator, state, obs, whether the warm-up stayed finite)."""
    from sigmarl_tpu_torch.bench import main_path

    env, cbf, policy, gen, state, obs = main_path(batch, n_agents, "cuda")
    return (env, cbf, policy, gen, *rollout(env, cbf, policy, gen, state, obs, steps))


def qp_capture(cbf, state, act, group_id=None):
    """K1's inputs and static arguments at this state and action."""
    from sigmarl_tpu_torch.safety.qp import kernel_inputs

    cfg = cbf.cfg
    cons, u_nom, _, _ = cbf.assemble(state, act, group_id)
    args = kernel_inputs(cons, u_nom, (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max),
                         state.cbf_u_prev, cfg.newton_ws_cap)
    static = ((cfg.w_u_acc, cfg.w_u_steer), (cbf.a_min, cbf.rate_min),
              (cbf.a_max, cbf.rate_max))
    return args, static


def capture_kernel_inputs(env, cbf, policy, gen, state, obs):
    """The inputs the main path gives both kernels at this state: K1's
    arguments and static arguments, and K2's arguments."""
    from sigmarl_tpu_torch.bench import policy_actions
    from sigmarl_tpu_torch.safety.circles import circle_centers_world

    qp_args, qp_static = qp_capture(cbf, state, policy_actions(env, policy, obs, gen))
    centers = circle_centers_world(cbf.centers_local, state.pos, state.rot)
    q, pid, chunks_l, chunks_r = cbf.stencil_inputs(centers, state.path_id)
    pd_args = (q, pid, env.tables.left_seg, env.tables.right_seg, chunks_l, chunks_r)
    return qp_args, qp_static, pd_args


def filtered_state(env, cbf, steps: int = 4):
    """A live state of `env` after a reset and `steps` filtered steps with
    (0.5, 0) nominal actions, for capturing the kernels' inputs."""
    from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

    gen = torch.Generator(device=env.device).manual_seed(1)
    act = torch.zeros((env.batch_dim, env.n_agents, 2), device=env.device)
    act[..., 0] = 0.5
    state, _ = env.reset(generator=gen)
    for _ in range(steps):
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=gen)
    return state


def wide_clf_setup():
    """The env and filter of the wide CLF evaluation: cpm_entire, N=15,
    B=1024, testing mode, the CLF controller, centralized, 3+5 budget."""
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env

    p = Parameters(scenario_type="cpm_entire", n_agents=15, num_vmas_envs=1024, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
                   is_testing_mode=True, is_using_cbf_testing=True, nom_controller_type="clf",
                   device="cuda")
    env = make_env(p)
    cbf = CBFSafetyFilter(CBFConfig(n_agents=15, nom_controller_type="clf", newton_iters=5,
                                    newton_soft_iters=3), env.cfg, env.tables, device=env.device)
    return env, cbf


def clf_qp_capture(cbf, state):
    """K1's inputs at a CLF-filtered state (the nominal action does not
    depend on the RL action)."""
    B, N = state.pos.shape[:2]
    return qp_capture(cbf, state, torch.zeros((B, N, 2), device=state.pos.device))


def _fp16_distances(cbf, state) -> torch.Tensor:
    """The stencil's distances as the fp16-parity filter rounds them, per
    lane row: [B, N, 2C, 9] (row c * 2 + side, as `assemble` orders them)."""
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.safety.circles import circle_centers_world

    centers = circle_centers_world(cbf.centers_local, state.pos, state.rot)
    B, N, C = centers.shape[:3]
    q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id, state.idx_left, state.idx_right)
    d_left, d_right = pseudo_distance_stencil(q, pid, cbf.tables.left_seg, cbf.tables.right_seg,
                                              cl, cr)
    d = torch.stack([d_left.reshape(B, N, C, 9), d_right.reshape(B, N, C, 9)], dim=3)
    return d.to(torch.float16).reshape(B, N, 2 * C, 9)


def clf_step_card_vs_cpu(dev: str = "cuda", B: int = 8) -> List[Check]:
    """One testing-mode, CLF-filtered, fp16-parity step (cpm_mixed, N=4)
    from the same state and draws on the card and on the CPU:

    - the nominal input and the CLF rows to atol 1e-5;
    - the lane rows (A, b, h) to atol 1e-4 and relative 1e-5, except in
      rows whose float16 distances differ between the two devices (where
      the circle centers part by an ulp, the rounding to float16 can fall
      on either side), and those exceptions in at most 1 % of the entries;
    - the card's solution no worse than the CPU's by a relative 1e-3 in F
      on the CPU's rows;
    - the env step from the same applied actions: rewards and positions to
      atol 2e-5, observations to 1e-4, done flags equal.

    Returns the checks; the caller asserts that every one is ok."""
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, cbf_filtered_step, make_env
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to
    from sigmarl_tpu_torch.safety.qp import solve_structured_qp

    N = 4
    p = Parameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B, dt=0.1,
                   max_steps=1_000_000, is_testing_mode=True, is_use_mtv_distance=False,
                   is_obs_noise=False, is_using_cbf_testing=True, nom_controller_type="clf")
    ccfg = CBFConfig(n_agents=N, nom_controller_type="clf", fp16_parity=True)
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device=dev)
    cbf_c = CBFSafetyFilter(ccfg, env_c.cfg, env_c.tables, device="cpu")
    cbf_g = CBFSafetyFilter(ccfg, env_g.cfg, env_g.tables, device=dev)
    g = torch.Generator().manual_seed(4)
    state, _ = env_c.reset(generator=g)
    act = torch.zeros((B, N, 2))
    for _ in range(5):
        state, *_ = cbf_filtered_step(env_c, cbf_c, state, act, generator=g)
    sg = state_to(state, torch.device(dev))
    cons, u_nom, _, _ = cbf_c.assemble(state, act)
    cons_g, u_nom_g, _, _ = cbf_g.assemble(sg, act.to(dev))
    checks = [Check("nominal input", float((u_nom_g.cpu() - u_nom).abs().max()), 1e-5, False)]

    lane = slice(0, 2 * ccfg.n_circles)
    d16_differs = (_fp16_distances(cbf_g, sg).cpu() != _fp16_distances(cbf_c, state)).any(-1)
    clf_err, apart, apart_agreeing, entries = 0.0, 0, 0, 0
    for f in ("A_s", "b_s", "h_s"):
        a, b = getattr(cons_g, f).cpu(), getattr(cons, f)
        clf_err = max(clf_err, float((a[:, :, -2:] - b[:, :, -2:]).abs().max()))
        far = ~torch.isclose(a[:, :, lane], b[:, :, lane], atol=1e-4, rtol=1e-5)
        if far.dim() == 4:  # A: [B, N, rows, 2]
            far = far.any(-1)
        apart += int(far.sum())
        apart_agreeing += int((far & ~d16_differs).sum())
        entries += far.numel()
    checks += [
        Check("CLF rows", clf_err, 1e-5, False),
        Check("lane-row entries apart where the float16 distances agree", apart_agreeing, 0, False),
        Check("share of lane-row entries apart", apart / entries, 0.01, False),
    ]

    fc = cbf_c.filter_actions(state, act, u_init=state.cbf_u_prev)
    fg = cbf_g.filter_actions(sg, act.to(dev), u_init=sg.cbf_u_prev)
    w_u = (ccfg.w_u_acc, ccfg.w_u_steer)
    lo, hi = (cbf_c.a_min, cbf_c.rate_min), (cbf_c.a_max, cbf_c.rate_max)

    def F(u):
        return solve_structured_qp(cons, u_nom, w_u, lo, hi, n_iters=0, u_init=u)[1].double()

    F_c, F_g = F(fc.u_star), F(fg.u_star.cpu())
    checks.append(Check("card F above CPU F (relative)",
                        float(((F_g - F_c) / (1.0 + F_c.abs())).max()), 1e-3, False))

    draws = ResetDraws.sample(env_c.cfg, g, "cpu")
    draws_g = ResetDraws(*(None if x is None else x.to(dev) for x in (
        draws.scenario_gumbel, draws.path_u, draws.point_u, draws.speed_u)))
    sc, oc, rc, dc, _ = env_c.step(state, fc.safe_actions, reset_draws=draws)
    sg2, og, rg, dg, _ = env_g.step(sg, fc.safe_actions.to(dev), reset_draws=draws_g)
    checks += [
        Check("step reward", float((rg.cpu() - rc).abs().max()), 2e-5, False),
        Check("step position", float((sg2.pos.cpu() - sc.pos).abs().max()), 2e-5, False),
        Check("step observation", float((og.cpu() - oc).abs().max()), 1e-4, False),
        Check("step done flags differing", int((dg.cpu() != dc).sum()), 0, False),
    ]
    return [c._replace(ok=c.value <= c.limit) for c in checks]


def challenge_buffer_steps_card_vs_cpu(dev: str = "cuda", B: int = 8) -> List[Check]:
    """Two steps with the challenging initial-state buffer on (cpm_mixed,
    N=4, a ring of 3 slots, every full-env reset replaying a record) from
    the same state and draws on the card and on the CPU. Before the first,
    agent 1 is put on agent 0 in every env, so that all B envs record (more
    than the ring holds: the later envs win) and then replay. Per step: the
    buffer, its pointer and valid count, the records and replays counted,
    and the done flags equal; positions and rewards to atol 2e-5,
    observations to 1e-4. Returns the checks."""
    from sigmarl_tpu_torch import Parameters, make_env
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import replace_state, state_to

    N, C = 4, 3
    p = Parameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
                   is_challenging_initial_state_buffer=True)
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device=dev)
    for env in (env_c, env_g):
        env.cfg = dataclasses.replace(env.cfg, challenge_buffer_size=C,
                                      probability_use_recording=1.0)
    g = torch.Generator().manual_seed(5)
    state, _ = env_c.reset(generator=g)
    act = torch.zeros((B, N, 2))
    act[..., 0] = 0.4
    for _ in range(4):  # fill the state buffer the records come from
        state, *_ = env_c.step(state, act, generator=g)
    pos = state.pos.clone()
    pos[:, 1] = pos[:, 0] + torch.tensor([0.02, 0.0])
    state = replace_state(state, pos=pos)
    sg = state_to(state, torch.device(dev))
    checks = []
    for k in range(2):
        draws = ResetDraws.sample(env_c.cfg, g, "cpu")
        # The replay's pick for every count v of valid records: floor(u v).
        u = torch.rand((B,), generator=g)
        draws.pick = (u[None] * torch.arange(1, C + 1)[:, None]).to(torch.int64)
        draws.record_u = torch.rand((), generator=g)
        draws_g = ResetDraws(**{f.name: None if getattr(draws, f.name) is None
                                else getattr(draws, f.name).to(dev)
                                for f in dataclasses.fields(ResetDraws)})
        sc, oc, rc, dc, _ = env_c.step(state, act, reset_draws=draws)
        sg, og, rg, dg, _ = env_g.step(sg, act.to(dev), reset_draws=draws_g)
        counts_c, counts_g = env_c.challenge_counts.tolist(), env_g.challenge_counts.tolist()
        checks += [
            Check(f"step {k + 1}: buffer", float((sg.challenge_buffer.cpu() - sc.challenge_buffer)
                                                 .abs().max()), 0.0, False),
            Check(f"step {k + 1}: pointer and valid count differing",
                  int(sg.cb_pointer.cpu() != sc.cb_pointer) + int(sg.cb_valid.cpu() != sc.cb_valid),
                  0, False),
            Check(f"step {k + 1}: records and replays differing ({counts_c} on the CPU)",
                  int(counts_c != counts_g), 0, False),
            Check(f"step {k + 1}: done flags differing", int((dg.cpu() != dc).sum()), 0, False),
            Check(f"step {k + 1}: position", float((sg.pos.cpu() - sc.pos).abs().max()), 2e-5, False),
            Check(f"step {k + 1}: reward", float((rg.cpu() - rc).abs().max()), 2e-5, False),
            Check(f"step {k + 1}: observation", float((og.cpu() - oc).abs().max()), 1e-4, False),
        ]
        state = sc
    records, replays = env_c.challenge_counts.tolist()
    checks.append(Check("envs recorded short of B (all collided in step 1)",
                        max(0, B - records), 0, False))
    checks.append(Check("no env replayed", int(replays == 0), 0, False))
    return [c._replace(ok=c.value <= c.limit) for c in checks]


def compact_reset_card_vs_cpu(dev: str = "cuda", B: int = 1024, N: int = 4,
                              share: float = 0.23) -> List[Check]:
    """Steps at B=1024 (cpm_entire, N=4) from the same state and draws on
    the card and on the CPU, before each of which about `share` of the
    envs collide (agent 1 put on agent 0), so that they reset and the
    spawn is compacted (at most 3B/8 resetting envs); a third step with
    half of the envs colliding spawns at full width. Per step: both
    devices take the same branch (the env's counters), done flags,
    path, point and scenario ids equal, positions and rewards to atol
    2e-5, observations to 1e-4. Returns the checks."""
    from sigmarl_tpu_torch import Parameters, make_env
    from sigmarl_tpu_torch.env.reset import ResetDraws, compact_slots
    from sigmarl_tpu_torch.env.structs import replace_state, state_to

    p = Parameters(scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False)
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device=dev)
    slots = compact_slots(B, False)
    g = torch.Generator().manual_seed(9)
    state, _ = env_c.reset(generator=g)
    sg = state_to(state, torch.device(dev))
    act = torch.zeros((B, N, 2))
    act[..., 0] = 0.3
    checks = []
    for k, frac in enumerate((share, share, 0.5)):
        hit = torch.rand((B,), generator=g) < frac
        pos = state.pos.clone()
        pos[hit, 1] = pos[hit, 0] + torch.tensor([0.02, 0.0])
        state, sg = replace_state(state, pos=pos), replace_state(sg, pos=pos.to(dev))
        draws = ResetDraws.sample(env_c.cfg, g, "cpu", compact_slots=slots)
        before = [(e.compact_reset_steps, e.full_reset_steps) for e in (env_c, env_g)]
        state, oc, rc, dc, _ = env_c.step(state, act, reset_draws=draws)
        sg, og, rg, dg, _ = env_g.step(sg, act.to(dev), reset_draws=draws.to(dev))
        branch = [(e.compact_reset_steps - c0, e.full_reset_steps - f0)
                  for e, (c0, f0) in zip((env_c, env_g), before)]
        want = (1, 0) if int(dc.sum()) <= slots else (0, 1)
        ids = sum(int((getattr(sg, f).cpu() != getattr(state, f)).sum())
                  for f in ("path_id", "point_id", "scenario_id"))
        checks += [
            Check(f"step {k + 1} ({int(dc.sum())} envs reset): branches differing from "
                  f"{'compacted' if want == (1, 0) else 'full width'} ({branch})",
                  int(branch[0] != want) + int(branch[1] != want), 0, False),
            Check(f"step {k + 1}: done flags differing", int((dg.cpu() != dc).sum()), 0, False),
            Check(f"step {k + 1}: path, point and scenario ids differing", ids, 0, False),
            Check(f"step {k + 1}: position", float((sg.pos.cpu() - state.pos).abs().max()),
                  2e-5, False),
            Check(f"step {k + 1}: reward", float((rg.cpu() - rc).abs().max()), 2e-5, False),
            Check(f"step {k + 1}: observation", float((og.cpu() - oc).abs().max()), 1e-4, False),
        ]
    checks.append(Check("compacted steps short of 2", max(0, 2 - env_g.compact_reset_steps),
                        0, False))
    return [c._replace(ok=c.value <= c.limit) for c in checks]


def iteration_draws(tr, generator: torch.Generator):
    """Every random number of one plain or CBF-filtered training iteration
    of trainer `tr` (one process, all B envs; no observation noise, XP-MARL
    or opponent modeling), drawn from `generator` on its device. With the
    challenge buffer, each step's replay picks are a [CB, B] table by
    valid count."""
    from sigmarl_tpu_torch.env.reset import ResetDraws, compact_slots
    from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws

    p, cfg = tr.parameters, tr.env.cfg
    if tr.use_prio or tr.use_om or cfg.is_obs_noise or p.is_prb or tr.shard is not None:
        raise ValueError("iteration_draws covers plain and filtered iterations in one process")
    T, B, N, E = p.max_steps, cfg.batch_dim, cfg.n_agents, p.num_epochs
    dev = generator.device
    # Drawn before the branch is known: both spawns' uniforms where the
    # env may compact.
    slots = compact_slots(B, cfg.is_challenging_initial_state_buffer)
    resets = []
    for _ in range(T):
        d = ResetDraws.sample(cfg, generator, dev, compact_slots=slots)
        if cfg.is_challenging_initial_state_buffer:
            v = torch.arange(1, cfg.challenge_buffer_size + 1, device=dev)[:, None]
            u = torch.rand((B,), generator=generator, device=dev)
            d.pick = torch.minimum((u[None] * v).long(), v - 1)
            d.record_u = torch.rand((), generator=generator, device=dev)
        resets.append(d)
    M = T * B
    return IterationDraws(
        action_noise=torch.randn((T, B, N, 2), generator=generator, device=dev),
        reset_draws=resets,
        permutations=torch.stack([torch.randperm(M, generator=generator, device=dev)
                                  for _ in range(E)]),
        entropy_noise=torch.randn((E, tr.n_minibatches, M // tr.n_minibatches, N, 2),
                                  generator=generator, device=dev),
    )


def update_draws(tr, generator: torch.Generator):
    """The update's random numbers of one iteration of trainer `tr` (the
    epochs' permutations and the minibatches' entropy noise, and the
    priority loss's under learned priority), drawn from `generator` on its
    device and moved to the trainer's."""
    from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws

    p, N = tr.parameters, tr.env.cfg.n_agents
    E, n_mb, dev = p.num_epochs, tr.n_minibatches, generator.device
    M = p.max_steps * tr.env.cfg.batch_dim
    mb = M // n_mb
    prio = tr.prio_policy_net is not None
    return IterationDraws(
        action_noise=None, reset_draws=None,
        permutations=torch.stack([torch.randperm(M, generator=generator, device=dev)
                                  for _ in range(E)]),
        entropy_noise=torch.randn((E, n_mb, mb, N, 2), generator=generator, device=dev),
        priority_entropy_noise=torch.randn((E, n_mb, mb, N, 1), generator=generator,
                                           device=dev) if prio else None,
    ).to(tr.device)


def update_graph_vs_eager(graph_tr, eager_tr, state, generator: torch.Generator,
                          sync_mode: str = "warn") -> dict:
    """One rollout of `graph_tr` (a trainer on the card that captures its
    update) from `state`, then the update of the same frames with the same
    draws (`update_draws` from `generator`) twice: by `eager_tr` (built
    from the same `Parameters` with `update_graph=False`), its networks
    and moments first set to those of `state`, and by `graph_tr`'s graph
    replays. The program is captured before the replays are watched for
    host syncs: counted (`sync_mode` "warn", `device.host_syncs`) or
    raised on ("error"). Returns equal (every parameter, moment and loss
    statistic bit for bit), max_abs_diff, the seconds of each update, the
    syncs, the loss statistics and the graph trainer's next state."""
    import time

    from sigmarl_tpu_torch.device import host_syncs
    from sigmarl_tpu_torch.rl.mappo_cavs import TrainState
    from sigmarl_tpu_torch.rl.optim import AdamState

    env_state, obs, ep_accum, batch, _ = graph_tr.rollout(state)
    data, _ = graph_tr.frames(state, batch)
    draws = update_draws(graph_tr, generator)
    e_opt = AdamState(state.opt_state.count, eager_tr.opt_state.mu, eager_tr.opt_state.nu)
    with torch.no_grad():
        for a, b in zip(eager_tr.parameter_list() + e_opt.mu + e_opt.nu,
                        graph_tr.parameter_list(*state.networks) + state.opt_state.mu
                        + state.opt_state.nu):
            a.copy_(b)
    nets = eager_tr.networks()
    e_state = dataclasses.replace(state, policy=nets[0], critic=nets[1], opt_state=e_opt,
                                  prio_policy=nets[2] if len(nets) > 2 else None,
                                  prio_critic=nets[3] if len(nets) > 2 else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_opt, e_stats = eager_tr.update(e_state, data, draws)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0

    graph_tr.update_program(state, data)  # captured here, outside the watch
    out, start = [], []

    def replays():
        start.append(time.perf_counter())
        out.append(graph_tr.update(state, data, draws))

    torch.cuda.synchronize()
    if sync_mode == "error":
        torch.cuda.set_sync_debug_mode("error")
        try:
            replays()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = []
    else:
        syncs = host_syncs(replays)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - start[0]
    g_opt, g_stats = out[0]
    mine = graph_tr.parameter_list(*state.networks) + g_opt.mu + g_opt.nu
    theirs = eager_tr.parameter_list() + e_opt.mu + e_opt.nu
    equal = all(torch.equal(a, b) for a, b in zip(mine, theirs)) and all(
        torch.equal(g_stats[k], e_stats[k]) for k in g_stats)
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(mine, theirs))
    nxt = TrainState(
        policy=state.policy, critic=state.critic, opt_state=g_opt, env_state=env_state,
        obs=obs, ep_reward_accum=ep_accum, iteration=state.iteration + 1,
        prio_policy=state.prio_policy, prio_critic=state.prio_critic,
    )
    return dict(equal=equal, max_abs_diff=diff, eager_s=eager_s, graph_s=graph_s, syncs=syncs,
                stats={k: float(v) for k, v in g_stats.items()}, state=nxt)


def _flat_parameters(state) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for n in state.networks for t in n.parameters()])


def _timed_iteration(tr, state, draws=None):
    """(state', metrics, seconds, {kernel: launches}) of one iteration."""
    import time

    from sigmarl_tpu_torch.ops import launch_counts

    before = launch_counts()
    tr._sync()
    t0 = time.perf_counter()
    state, m = tr.train_iteration(state, draws)
    tr._sync()
    launches = launch_counts(since=before)
    return state, m, time.perf_counter() - t0, launches


def unsharded_iteration(kw: dict, seed: int, dev: str = "cuda") -> dict:
    """The reference of `sharded_iteration_rank`: one process over all B
    envs, the draws drawn once on the card from `seed` (the start's reset
    and one iteration), then a second iteration from the trainer's own
    generator, timed. Returns the draws (on the CPU), the first iteration's
    state, obs, metrics and parameters, both iterations' seconds and
    launches, and the env's (reset, compacted, full-width) step counts
    after each."""
    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to

    tr = MAPPOCAVs(Parameters(**kw, device=dev))
    gen = torch.Generator(device=tr.device).manual_seed(seed)
    start = ResetDraws.sample(tr.env.cfg, gen, tr.device)
    draws = iteration_draws(tr, gen)
    state, m, sec, launches = _timed_iteration(tr, tr.initial_state(reset_draws=start), draws)
    out = dict(start=start.to("cpu"), draws=draws.to("cpu"),
               env_state=state_to(state.env_state, "cpu"), obs=state.obs.cpu(),
               metrics={k: float(v) for k, v in m.items()}, params=_flat_parameters(state).cpu(),
               seconds=[sec], launches=[launches], lr=tr.parameters.lr,
               updates=tr.updates_per_iter, counts=tr.challenge_counts().cpu(),
               resets=[reset_counts(tr.env)], env_graphs=len(tr.env._graphs))
    _, _, sec, launches = _timed_iteration(tr, state)
    out["seconds"].append(sec)
    out["launches"].append(launches)
    out["resets"].append(reset_counts(tr.env))
    return out


def sharded_iteration_rank(shard, device, kw: dict, start, draws) -> dict:
    """One rank of the sharded counterpart of `unsharded_iteration` (a
    function for `parallel.dryrun.spawn_ranks`): the same start and draws,
    sliced to the rank's envs; the gathered state and obs, the reduced
    metrics, the rank's parameters, and each iteration's seconds and the
    rank's launches."""
    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.env.structs import state_to
    from sigmarl_tpu_torch.parallel.mesh import gather_world_state

    tr = MAPPOCAVs(Parameters(**kw, device=str(device)), shard=shard)
    state = tr.initial_state(reset_draws=start.to(device))
    state, m, sec, launches = _timed_iteration(tr, state, draws.to(device))
    out = dict(env_state=state_to(gather_world_state(state.env_state, shard), "cpu"),
               obs=shard.all_gather(state.obs).cpu(),
               metrics={k: float(v) for k, v in m.items()}, params=_flat_parameters(state).cpu(),
               seconds=[sec], launches=[launches], counts=tr.challenge_counts().cpu(),
               resets=[reset_counts(tr.env)], env_graphs=len(tr.env._graphs))
    _, _, sec, launches = _timed_iteration(tr, state)
    out["seconds"].append(sec)
    out["launches"].append(launches)
    out["resets"].append(reset_counts(tr.env))
    return out


def reset_counts(env) -> tuple:
    """The env's (reset, compacted, full-width) reset-step counts."""
    return env.reset_steps, env.compact_reset_steps, env.full_reset_steps


def policy_rows_invariant(policy, obs: torch.Tensor, rows: int) -> float:
    """Largest difference between the policy's outputs on the first `rows`
    envs alone and on all envs: 0 where the layers round alike at both
    batch sizes."""
    with torch.no_grad():
        loc_all, scale_all = policy(obs)
        loc, scale = policy(obs[:rows])
    return float(torch.maximum((loc_all[:rows] - loc).abs().max(),
                               (scale_all[:rows] - scale).abs().max()))


def sharded_vs_unsharded(ref: dict, ranks: List[dict], what: str) -> List[Check]:
    """The checks of a sharded iteration against the unsharded one:

    - the gathered rollout: integer fields and flags equal, the challenge
      buffer's records equal, float fields (obs included) within 1e-3
      (u* within 1e-2), and whether every field is bit for bit (reported
      as a check whose limit is 0, counted ok either way: a policy layer
      that rounds differently at another row count parts it);
    - the parameters: at least 99 % within 1e-6 of the unsharded ones and
      all within 2 lr per update; every rank's equal to rank 0's;
    - the metrics: `n_done` equal, the rest to a relative 1e-4;
    - launches: K1 and K2 once per rollout step on every rank, K3 once per
      reset step (every rank spawns when any env resets);
    - the reset-step counts (reset, compacted, full width) of every rank
      equal the unsharded env's: the branch is decided over all envs;
    - the env step: graphs captured unsharded on the card, none on a rank
      (a sharded step holds collectives, so it runs op by op)."""
    checks = []
    r0 = ranks[0]
    worst, exact = 0.0, True
    for f in dataclasses.fields(ref["env_state"]):
        a, b = getattr(r0["env_state"], f.name), getattr(ref["env_state"], f.name)
        exact &= bool(torch.equal(a, b))
        if a.is_floating_point():
            d = float((a - b).abs().max()) if a.numel() else 0.0
            lim = 1e-2 if f.name == "cbf_u_prev" else 1e-3
            if f.name == "challenge_buffer":
                lim = 0.0
            checks.append(Check(f"{what}: {f.name} max |sharded - unsharded|", d, lim, d <= lim))
            worst = max(worst, d)
        else:
            checks.append(Check(f"{what}: {f.name} entries that differ",
                                float((a != b).sum()), 0.0, bool(torch.equal(a, b))))
    d = float((r0["obs"] - ref["obs"]).abs().max())
    exact &= d == 0.0
    checks.append(Check(f"{what}: obs max |sharded - unsharded|", d, 1e-3, d <= 1e-3))
    checks.append(Check(f"{what}: rollout bit for bit (0 = yes; largest state difference)",
                        max(worst, d), 0.0, True))
    diffs = (r0["params"] - ref["params"]).abs()
    share = float((diffs <= 1e-6).float().mean())
    checks.append(Check(f"{what}: share of parameters within 1e-6", share, 0.99, share >= 0.99))
    lim = 2 * ref["lr"] * ref["updates"]
    checks.append(Check(f"{what}: max parameter difference", float(diffs.max()), lim,
                        float(diffs.max()) <= lim))
    for r in ranks[1:]:
        checks.append(Check(f"{what}: ranks' parameters differ (max)",
                            float((r["params"] - r0["params"]).abs().max()), 0.0,
                            bool(torch.equal(r["params"], r0["params"]))))
    m, mr = r0["metrics"], ref["metrics"]
    checks.append(Check(f"{what}: n_done", m["n_done"], mr["n_done"], m["n_done"] == mr["n_done"]))
    for k in ("episode_reward_mean", "reward_mean", "cbf_solved_share", "loss_objective",
              "loss_critic", "loss_entropy"):
        both_nan = math.isnan(m[k]) and math.isnan(mr[k])  # no episode ended
        gap = 0.0 if both_nan else abs(m[k] - mr[k]) / max(abs(mr[k]), 1e-12)
        checks.append(Check(f"{what}: {k} relative gap", gap, 1e-4, gap <= 1e-4))
    checks.append(Check(f"{what}: challenge (records, replays) differ",
                        float((r0["counts"] - ref["counts"]).abs().sum()), 0.0,
                        bool(torch.equal(r0["counts"], ref["counts"]))))
    for rank, r in enumerate(ranks):
        checks.append(Check(f"{what}: rank {rank} reset-step counts {r['resets']} differ from "
                            f"{ref['resets']}", float(r["resets"] != ref["resets"]), 0.0,
                            r["resets"] == ref["resets"]))
    for rank, r in enumerate(ranks):
        checks.append(Check(f"{what}: rank {rank} env-step graph keys", r["env_graphs"], 0,
                            r["env_graphs"] == 0))
    checks.append(Check(f"{what}: unsharded env-step graph keys", ref["env_graphs"], 1,
                        ref["env_graphs"] >= 1))
    T = len(ref["draws"].reset_draws)
    for rank, r in enumerate(ranks):
        for it, launches in enumerate(r["launches"]):
            resets = r["resets"][it][0] - (r["resets"][it - 1][0] if it else 0)
            for k, n in launches.items():
                want = resets if k == "spawn_place" else T
                checks.append(Check(f"{what}: rank {rank} iteration {it + 1} {k} launches",
                                    n, want, n == want))
    return checks
