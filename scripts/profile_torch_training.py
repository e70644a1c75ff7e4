#!/usr/bin/env python3
"""Where one MAPPO training iteration of the PyTorch port spends its time
on the card.

    python3 scripts/profile_torch_training.py

Configurations, `sigmarl_tpu_torch/utils/card_checks.py`'s training
constants:

- informed (`INFORMED_TRAINING`): CBF-informed training at the paper's
  reward-sweep setting (cpm_mixed, N=4, B=32, T=128, 30 epochs of minibatch
  512, "cbf" reward from the margins-only filter, observation noise on);
- filtered (`FILTERED_TRAINING`): CBF-filtered training at the main path's
  width (cpm_entire, N=15, B=1024, T=16, centralized filter at its 2+15
  budget, one epoch of minibatch 4096);
- xpmarl (`XPMARL_TRAINING`): the ICRA'25 learned-priority setting
  (cpm_mixed, N=4, B=32, T=128, 30 epochs of minibatch 512);
- opponent (`OPPONENT_TRAINING`): opponent modeling in the same setting;
- wide (`WIDE_XPMARL_TRAINING`): learned priority with a CBF-filtered
  rollout at N=15, B=1024, T=16 on the `Parameters` defaults.

For each: one iteration to warm up, one timed iteration (host clock, the
card synchronised at the end of the rollout, GAE and update phases), then
one iteration traced with torch.profiler: the device's busy time, its
busy and idle shares of the timed iteration (the profiler's start-up
inflates its own wall time), the kernel launches, K1's and K2's device
time and the kernels with the most device time. Prints one JSON line per
configuration. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sigmarl_tpu_torch.utils import card_checks as cc  # noqa: E402

CONFIGS = {
    "informed": cc.INFORMED_TRAINING, "filtered": cc.FILTERED_TRAINING,
    "xpmarl": cc.XPMARL_TRAINING, "opponent": cc.OPPONENT_TRAINING,
    "wide": cc.WIDE_XPMARL_TRAINING,
}


def profile_config(name: str, smi: str, workdir: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters

    p = Parameters(**CONFIGS[name], n_iters=10, where_to_save=workdir + "/", device="cuda")
    tr = MAPPOCAVs(p)
    state = tr.initial_state()
    state, _ = tr.train_iteration(state)  # warm-up
    state, m = tr.train_iteration(state)
    phases = {k: m[f"seconds_{k}"] for k in ("rollout", "gae", "update")}
    iter_s = sum(phases.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = tr.train_iteration(state)
        torch.cuda.synchronize()

    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tot, cnt = kernels.get(e.key, (0.0, 0))
        kernels[e.key] = (tot + e.self_device_time_total, cnt + e.count)
    busy_s = sum(t for t, _ in kernels.values()) / 1e6
    launches = sum(c for _, c in kernels.values())

    def share(tag):
        return sum(t for k, (t, _) in kernels.items() if tag in k) / 1e3

    k1_ms, k2_ms = share("qp_newton_kernel"), share("pd_stencil_kernel")
    frames = p.frames_per_batch
    print(f"[{name}] iteration {iter_s:.3f} s: rollout {phases['rollout']:.3f}, GAE "
          f"{phases['gae']:.4f}, update {phases['update']:.3f} ({tr.updates_per_iter} minibatch "
          f"updates); {frames / phases['rollout']:.1f} rollout frames/s, "
          f"{frames / iter_s:.1f} frames/s overall")
    print(f"[{name}] traced iteration: device busy {busy_s:.3f} s, {launches} kernel launches; "
          f"against the timed iteration the device is busy {busy_s / iter_s:.1%} and idle "
          f"{1 - busy_s / iter_s:.1%}; K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms")
    for key, (us, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {cnt:7d}x  {key[:90]}")
    return dict(config=name, device=smi, n_agents=p.n_agents, batch=p.num_vmas_envs,
                steps=p.max_steps, updates=tr.updates_per_iter, iteration_s=iter_s,
                phases_s=phases, rollout_frames_per_s=frames / phases["rollout"],
                device_busy_s=busy_s, idle_share=1 - busy_s / iter_s, launches=launches,
                k1_ms=k1_ms, k2_ms=k2_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device is available", file=sys.stderr)
        return 1
    from sigmarl_tpu_torch.device import nvidia_smi_line

    smi = nvidia_smi_line()
    os.makedirs(os.path.join(ROOT, "outputs"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile_", dir=os.path.join(ROOT, "outputs")) as wd:
        results = [profile_config(n, smi, wd) for n in CONFIGS]
    print(smi)
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
