"""The trainer's update as one program (`rl/update_program.py`) and the
multi-tensor optimizer (`rl/optim.py`) on the CPU, held bit for bit against
the formulation they replace: Adam one parameter at a time with host-float
scalars and returned moments, and the eager loop over `minibatch_update`.

The reference optimizer below is that formulation, kept here as the test's
yardstick. Every comparison is `torch.equal`: the new code runs the same
float32 operations in the same order. The card's graph replay is held
against the same program run eagerly in `tests/test_torch_gpu.py`."""

import numpy as np
import pytest
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.rl import checkpoint as ckpt
from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws, MAPPOCAVs
from sigmarl_tpu_torch.rl.networks import _dense_stack, _load_dense_stack, to_jax_params
from sigmarl_tpu_torch.rl.optim import B1, B2, EPS, Adam, AdamState, ClippedAdam

torch.set_num_threads(1)


class PerParameterAdam(Adam):
    """Adam one parameter at a time, host-float scalars, new moments."""

    @torch.no_grad()
    def step(self, params, grads, state):
        k = state.count + 1
        bc1, bc2 = 1 - B1**k, 1 - B2**k
        step_size = -self.learning_rate(state.count)
        mu, nu = [], []
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m = (1 - B1) * g + B1 * m
            v = (1 - B2) * (g * g) + B2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            p.add_(step_size * u)
            mu.append(m)
            nu.append(v)
        return AdamState(k, mu, nu)


class PerParameterClippedAdam(ClippedAdam):
    """The global-norm clip one tensor at a time, then `PerParameterAdam`."""

    @torch.no_grad()
    def step(self, params, grads, state):
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.max_grad_norm
        grads = [torch.where(keep, g, g / norm * self.max_grad_norm) for g in grads]
        return PerParameterAdam.step(self, params, grads, state)


SHAPES = [(256, 30), (256,), (4, 256), (4,), (1, 120), (1,)]


@pytest.mark.parametrize("clipped", [False, True], ids=["Adam", "ClippedAdam"])
def test_foreach_step_equals_the_per_parameter_step(clipped):
    """Five steps from the same float32 parameters and gradients, with the
    gradients' global norm above the clip in some steps and below it in
    others: parameters, moments and counts equal bit for bit."""
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]
             for scale in (0.3, 1e-3, 0.05, 2.0, 1e-5)]
    if clipped:
        new, old = ClippedAdam(1.0, 3e-4, 3e-5, 2, 5), PerParameterClippedAdam(1.0, 3e-4, 3e-5, 2, 5)
        norms = [np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g)) for g in grads]
        assert min(norms) < 1.0 < max(norms)
    else:
        new, old = Adam(3e-4), PerParameterAdam(3e-4)
    pn = [torch.tensor(x) for x in params]
    po = [torch.tensor(x) for x in params]
    sn, so = new.init(pn), old.init(po)
    ptrs = [t.data_ptr() for t in pn + sn.mu + sn.nu]
    for g in grads:
        sn = new.step(pn, [torch.tensor(x) for x in g], sn)
        so = old.step(po, [torch.tensor(x) for x in g], so)
        for a, b in zip(pn + sn.mu + sn.nu, po + so.mu + so.nu):
            assert torch.equal(a, b)
    assert sn.count == so.count == 5
    assert [t.data_ptr() for t in pn + sn.mu + sn.nu] == ptrs  # updated in place


def test_schedule_table_equals_the_host_floats():
    """The table a captured step reads: for every update count of a run
    (960 updates per iteration, 250 iterations, and past the end of the
    schedule), in float64 the host floats themselves, in float32 each one
    rounded once."""
    opt = ClippedAdam(1.0, 2.5e-4, 1e-5, 960, 250)
    n = 960 * 251
    t64 = opt.schedule(0, n, torch.float64).numpy()
    t32 = opt.schedule(0, n, torch.float32).numpy()
    for c in list(range(0, n, 997)) + [959, 960, 961, n - 1]:
        k = c + 1
        want = (-opt.learning_rate(c), 1 - B1**k, 1 - B2**k)
        assert tuple(t64[c]) == want
        assert tuple(t32[c]) == tuple(np.float32(w) for w in want)
        assert opt.scalars(c) == want
    assert tuple(opt.schedule(1000, 3, torch.float64)[1].tolist()) == opt.scalars(1001)


B, N, T = 4, 4, 8
BASE = dict(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B, dt=0.1, max_steps=T,
            n_iters=3, num_epochs=1, minibatch_size=8, is_use_mtv_distance=False,
            is_obs_noise=False, random_seed=0, device="cpu")
CONFIGS = {
    "plain": {},
    "learned_priority": dict(is_using_prioritized_marl=True, prioritization_method="marl"),
}


def _frames(tr, seed):
    """Synthetic frames of one iteration (M = T * B rows) and the update's
    draws for `epochs` epochs, from numpy."""
    rng = np.random.default_rng(seed)
    M, D = T * B, tr.policy_obs_dim

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    obs = f(M, N, D)
    with torch.no_grad():
        loc, scale = tr.policy_net(obs)
        noise = f(M, N, 2)
        act = torch.tanh(loc + scale * noise) * tr.high
    data = dict(obs=obs, action=act, log_prob=f(M, N, scale=0.5) - 1.0, adv=f(M, N),
                vt=f(M, N))
    if tr.prio_policy_net is not None:
        data.update(prio_obs=f(M, N, tr.env.cfg.obs_dim), prio_scores=torch.tanh(f(M, N)),
                    prio_log_prob=f(M, N, scale=0.5), prio_adv=f(M, N), prio_vt=f(M, N))
    E, n_mb = tr.parameters.num_epochs, tr.n_minibatches
    mb = M // n_mb
    draws = IterationDraws(
        action_noise=None, reset_draws=None,
        permutations=torch.from_numpy(np.stack([rng.permutation(M) for _ in range(E)])),
        entropy_noise=f(E, n_mb, mb, N, 2),
        priority_entropy_noise=f(E, n_mb, mb, N, 1),
    )
    return data, draws


@pytest.fixture(scope="module", params=list(CONFIGS))
def trainers(request, tmp_path_factory):
    """Two trainers from one seed: the first updates through the program,
    the second through the eager loop with the per-parameter optimizer."""
    kw = {**BASE, **CONFIGS[request.param],
          "where_to_save": str(tmp_path_factory.mktemp("u")) + "/"}
    new = MAPPOCAVs(Parameters(**kw))
    old = MAPPOCAVs(Parameters(**kw), env=new.env)
    o = new.optimizer
    old.optimizer = PerParameterClippedAdam(o.max_grad_norm, o.lr, o.lr_min, o.updates_per_iter,
                                            o.n_iters)
    return new, old


def test_program_equals_the_eager_minibatch_loop(trainers):
    """One epoch of 4 minibatches through `UpdateProgram.step`, run eagerly
    on its static buffers, against the loop over `minibatch_update` with
    the per-parameter optimizer: every parameter, moment and loss
    statistic equal, the networks (all four under learned priority)
    moved."""
    new, old = trainers
    assert new.eager_reason is None and not new.update_graph and new.n_minibatches == 4
    sn, so = new.initial_state(), old.initial_state()
    before = [t.clone() for t in new.parameter_list()]
    for a, b in zip(before, old.parameter_list()):
        assert torch.equal(a, b)
    data, draws = _frames(new, 1)
    opt_n, stats_n = new.update(sn, data, draws)
    opt_o, stats_o = old._update_loop(so, data, draws, None)
    assert opt_n.count == opt_o.count == 4
    for a, b in zip(new.parameter_list() + opt_n.mu + opt_n.nu,
                    old.parameter_list() + opt_o.mu + opt_o.nu):
        assert torch.equal(a, b)
    assert all(not torch.equal(a, b) for a, b in zip(before, new.parameter_list()))
    assert set(stats_n) == set(stats_o) == set(new.program.keys)
    for k in stats_n:
        assert torch.equal(stats_n[k], stats_o[k]), k


def test_reloaded_checkpoint_continues_identically(trainers, tmp_path):
    """Save the networks (the checkpoint files' flax layout) and copies of
    the optimizer's moments after one update, continue one more; reload
    both into the same tensors in place (`copy_`: the program keeps its
    buffers) and repeat the second update: bit for bit."""
    tr = trainers[0]
    state = tr.initial_state()
    data1, draws1 = _frames(tr, 2)
    data2, draws2 = _frames(tr, 3)
    opt, _ = tr.update(state, data1, draws1)
    state.opt_state = opt
    for i, net in enumerate(tr.networks()):
        ckpt.save_params(str(tmp_path / f"net{i}.pkl"), to_jax_params(net))
    saved_moments = [t.clone() for t in opt.mu + opt.nu]
    prog = tr.program
    opt2, stats2 = tr.update(state, data2, draws2)
    want = [t.clone() for t in tr.parameter_list() + opt2.mu + opt2.nu]

    for i, net in enumerate(tr.networks()):
        _load_dense_stack(net, *_dense_stack(ckpt.load_params(str(tmp_path / f"net{i}.pkl"))))
    for dst, src in zip(opt2.mu + opt2.nu, saved_moments):
        dst.copy_(src)
    state.opt_state = AdamState(opt.count, opt2.mu, opt2.nu)
    opt3, stats3 = tr.update(state, data2, draws2)
    assert tr.program is prog and opt3.count == opt2.count
    for a, b in zip(tr.parameter_list() + opt3.mu + opt3.nu, want):
        assert torch.equal(a, b)
    for k in stats2:
        assert torch.equal(stats2[k], stats3[k])


def test_update_form_by_configuration(tmp_path):
    """The CPU runs the program eagerly, never a graph; PRB and
    `debug_numerics` keep the eager loop (the sharded trainer's is held in
    `tests/test_torch_parallel.py`)."""
    kw = {**BASE, "where_to_save": str(tmp_path) + "/"}
    tr = MAPPOCAVs(Parameters(**kw))
    assert tr.eager_reason is None and not tr.update_graph
    assert MAPPOCAVs(Parameters(**kw, is_prb=True)).eager_reason == "prb"
    try:
        tr = MAPPOCAVs(Parameters(**kw, debug_numerics=True))
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert tr.eager_reason == "debug_numerics" and not tr.update_graph


def test_warm_up_leaves_the_state_as_it_was(tmp_path):
    """The capture's warm-up runs the step at the table's first row and
    undoes it: with one minibatch update per iteration (frames_per_batch
    below minibatch_size) it reads no row past the table, and the
    parameters, moments and counter end as they began."""
    tr = MAPPOCAVs(Parameters(**{**BASE, "minibatch_size": 64, "where_to_save": str(tmp_path)}))
    assert tr.updates_per_iter == 1
    state = tr.initial_state()
    data, _ = _frames(tr, 4)
    prog = tr.update_program(state, data)
    prog.begin(data, 0)
    before = [t.clone() for t in prog.params + prog.mu + prog.nu + [prog.row]]
    prog.warm_up()
    for a, b in zip(prog.params + prog.mu + prog.nu + [prog.row], before):
        assert torch.equal(a, b)
