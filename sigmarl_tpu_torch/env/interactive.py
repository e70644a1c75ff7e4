"""Interactive keyboard-controlled scenario session.

A human drives agent 0 (and optionally agent 1) with the keyboard while
the other agents follow the scripted pure-pursuit nominal; the env steps
at the control period and the window redraws each frame.

`InteractiveSession` is a plain object driven by `key(name)` and `step()`,
so it runs without a display (tests drive it so); `render_interactively`
attaches it to a matplotlib window (an interactive backend) and runs the
draw loop.

Controls:
    agent 0 — arrow keys: Up/Down speed target +-, Left/Right steering.
    agent 1 — W/S speed, A/D steering (with `control_two_agents=True`).
    R resets the episode, Q quits.

    python -m sigmarl_tpu_torch.env.interactive [--scenario_type ...]
        [--n_agents 4] [--control_two_agents] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.core.controllers import pure_pursuit_on_short_term
from sigmarl_tpu_torch.env.env import make_env

SPEED_STEP = 0.1
STEER_STEP = 0.1


class InteractiveSession:
    """One env with agent 0 (and 1) under manual control, on `device`
    (`cuda` unless the caller asks for the CPU). Every random number (the
    resets, R included, and the steps) comes from the session's generator,
    seeded by `seed`."""

    def __init__(
        self,
        scenario_type: str = "cpm_entire",
        n_agents: int = 4,
        control_two_agents: bool = False,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.p = Parameters(
            scenario_type=scenario_type, n_agents=n_agents, num_vmas_envs=1,
            dt=0.1, is_use_mtv_distance=False, is_obs_noise=False,
        )
        self.env = make_env(self.p, device=device)
        self.control_two_agents = control_two_agents
        self.generator = torch.Generator(device=self.env.device).manual_seed(seed)
        self.state, self.obs = self.env.reset(generator=self.generator)
        self.n_agents = n_agents
        # Manual (speed, steering) targets per controlled agent.
        self.targets = np.zeros((2, 2), np.float32)
        self.t = 0
        self.done = False
        self.quit = False

    # ---------------------------------------------------------------- input
    def key(self, name: str) -> None:
        """Apply one key event (matplotlib key names)."""
        lim_v = (AGENTS["min_speed"], AGENTS["max_speed"])
        lim_s = (AGENTS["min_steering"], AGENTS["max_steering"])
        k = name.lower()
        if k == "up":
            self.targets[0, 0] += SPEED_STEP
        elif k == "down":
            self.targets[0, 0] -= SPEED_STEP
        elif k == "left":
            self.targets[0, 1] += STEER_STEP
        elif k == "right":
            self.targets[0, 1] -= STEER_STEP
        elif self.control_two_agents and k == "w":
            self.targets[1, 0] += SPEED_STEP
        elif self.control_two_agents and k == "s":
            self.targets[1, 0] -= SPEED_STEP
        elif self.control_two_agents and k == "a":
            self.targets[1, 1] += STEER_STEP
        elif self.control_two_agents and k == "d":
            self.targets[1, 1] -= STEER_STEP
        elif k == "r":
            self.reset()
            return
        elif k == "q":
            self.quit = True
            return
        self.targets[:, 0] = np.clip(self.targets[:, 0], *lim_v)
        self.targets[:, 1] = np.clip(self.targets[:, 1], *lim_s)

    def reset(self) -> None:
        """A new episode, from the session's generator (so a replayed
        episode does not repeat the last one's draws)."""
        self.state, self.obs = self.env.reset(generator=self.generator)
        self.targets[:] = 0.0
        self.t = 0
        self.done = False

    # ---------------------------------------------------------------- step
    def actions(self) -> torch.Tensor:
        """[1, N, 2] actions: the manual targets for the controlled agents,
        pure pursuit at 0.5 m/s for the rest."""
        acts = pure_pursuit_on_short_term(
            self.state.pos, self.state.rot, self.state.short_term, 0.5, self.env.cfg.max_steering
        )
        n_manual = 2 if self.control_two_agents else 1
        acts[0, :n_manual] = torch.as_tensor(self.targets[:n_manual], device=acts.device)
        return acts

    def step(self):
        """Advance one control period; returns (reward [N], done)."""
        self.state, self.obs, rew, done, _ = self.env.step(
            self.state, self.actions(), generator=self.generator
        )
        self.t += 1
        self.done = bool(done[0])
        return rew[0].cpu().numpy(), self.done


def render_interactively(
    scenario_type: str = "cpm_entire",
    n_agents: int = 4,
    control_two_agents: bool = False,
    max_steps: Optional[int] = None,
    interval_ms: int = 100,
    device: str | torch.device | None = None,
):
    """Open a matplotlib window and drive the session with the keyboard.
    Needs an interactive backend (TkAgg, QtAgg, macosx); on a machine
    without a display run `python -m sigmarl_tpu_torch.env.debug_demo`."""
    import matplotlib
    import matplotlib.pyplot as plt

    from sigmarl_tpu_torch.render import render_frame

    if matplotlib.get_backend().lower() == "agg":
        raise RuntimeError(
            "render_interactively needs an interactive matplotlib backend "
            "(got Agg). On headless machines run env/debug_demo.py instead."
        )

    sess = InteractiveSession(scenario_type, n_agents, control_two_agents, device=device)
    fig, ax = plt.subplots(figsize=(7, 6))
    fig.canvas.mpl_connect("key_press_event", lambda ev: sess.key(ev.key or ""))
    while not sess.quit and (max_steps is None or sess.t < max_steps):
        sess.step()
        ax.clear()
        render_frame(
            ax, scenario_type, sess.state.pos[0].cpu().numpy(), sess.state.rot[0].cpu().numpy(),
            short_term=sess.state.short_term[0].cpu().numpy(),
        )
        ax.set_title(
            f"t={sess.t * sess.p.dt:.1f}s  agent0 target "
            f"v={sess.targets[0, 0]:+.2f} steer={sess.targets[0, 1]:+.2f}  "
            "(arrows; R reset; Q quit)"
        )
        plt.pause(interval_ms / 1000.0)
    plt.close(fig)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario_type", default="cpm_entire")
    ap.add_argument("--n_agents", type=int, default=4)
    ap.add_argument("--control_two_agents", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    render_interactively(args.scenario_type, args.n_agents, args.control_two_agents,
                         device=args.device)
