"""Minimal debug scenario: a few bicycle agents under scripted control.

Runs headless on the chosen map (pure pursuit at 0.5 m/s on every agent,
the env's command dynamics), prints the first agent's position and reward
every 10 steps, and with `--render` draws the trajectories to
`debug_demo.png` on the host.

    python -m sigmarl_tpu_torch.env.debug_demo [--steps 60] [--render]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.core.controllers import pure_pursuit_on_short_term
from sigmarl_tpu_torch.env.env import make_env


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario_type", default="cpm_mixed")
    ap.add_argument("--n_agents", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    p = Parameters(
        scenario_type=args.scenario_type, n_agents=args.n_agents,
        num_vmas_envs=1, dt=0.1, is_use_mtv_distance=False, is_obs_noise=False,
    )
    env = make_env(p, device=args.device)
    gen = torch.Generator(device=env.device).manual_seed(0)
    state, obs = env.reset(generator=gen)
    traj = []
    for i in range(args.steps):
        acts = pure_pursuit_on_short_term(state.pos, state.rot, state.short_term, 0.5,
                                          env.cfg.max_steering)
        state, obs, rew, done, info = env.step(state, acts, generator=gen)
        traj.append(state.pos[0].cpu().numpy())
        if i % 10 == 0:
            print(f"step {i}: pos {state.pos[0, 0].cpu().numpy().round(3)} "
                  f"reward {float(rew[0, 0]):.3f}")
    if args.render:
        from sigmarl_tpu_torch.render import draw_map, pyplot

        plt = pyplot()
        fig, ax = plt.subplots(figsize=(6, 5))
        draw_map(ax, args.scenario_type)
        t = np.stack(traj)
        for a in range(args.n_agents):
            ax.plot(t[:, a, 0], t[:, a, 1], linewidth=1.2)
        fig.savefig("debug_demo.png", dpi=130)
        plt.close(fig)
        print("saved debug_demo.png")
    return np.stack(traj)


if __name__ == "__main__":
    main()
