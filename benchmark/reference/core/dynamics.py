"""Kinematic bicycle dynamics on tensors, one explicit Euler step.

State layout: `x = [x, y, yaw, speed, steering]`, input `u = [accel,
steering_rate]`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.reference.constants import AGENTS

Tensor = torch.Tensor


@dataclass(frozen=True)
class BicycleParams:
    """Static model parameters (defaults: the CPM-lab muCar)."""

    l_f: float = AGENTS["l_f"]
    l_r: float = AGENTS["l_r"]
    max_speed: float = AGENTS["max_speed"]
    min_speed: float = AGENTS["min_speed"]
    max_steering: float = AGENTS["max_steering"]
    min_steering: float = AGENTS["min_steering"]
    max_acc: float = AGENTS["max_acc"]
    min_acc: float = AGENTS["min_acc"]
    max_steering_rate: float = AGENTS["max_steering_rate"]
    min_steering_rate: float = AGENTS["min_steering_rate"]

    @property
    def l_wb(self) -> float:
        return self.l_f + self.l_r


def ode(params: BicycleParams, x: Tensor, u: Tensor) -> Tensor:
    """Continuous-time dynamics dx/dt. x [..., 5]; u [..., 2]."""
    beta = torch.atan(params.l_r / params.l_wb * torch.tan(x[..., 4]))
    return torch.stack(
        [
            x[..., 3] * torch.cos(x[..., 2] + beta),
            x[..., 3] * torch.sin(x[..., 2] + beta),
            (x[..., 3] / params.l_wb) * torch.tan(x[..., 4]) * torch.cos(beta),
            u[..., 0],
            u[..., 1],
        ],
        dim=-1,
    )


def step(
    params: BicycleParams, x0: Tensor, u: Tensor, dt: float, tick_per_step: int = 1
) -> tuple[Tensor, Tensor, Tensor]:
    """Integrate one control period with explicit Euler sub-steps. Steering
    is wrapped to [-pi, pi). Returns (state [..., 5], sideslip [...],
    velocity [..., 2])."""
    h = dt / tick_per_step
    x = x0
    for _ in range(tick_per_step):
        x = x + h * ode(params, x, u)
    steering = torch.remainder(x[..., 4] + math.pi, 2 * math.pi) - math.pi
    x = torch.cat([x[..., :4], steering[..., None]], dim=-1)
    beta = torch.atan(params.l_r / params.l_wb * torch.tan(steering))
    course = x[..., 2] + beta
    vel = torch.stack([x[..., 3] * torch.cos(course), x[..., 3] * torch.sin(course)], dim=-1)
    return x, beta, vel


def command_step(
    params: BicycleParams,
    pos: Tensor,
    rot: Tensor,
    speed: Tensor,
    steering: Tensor,
    action: Tensor,
    dt: float,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """World step from (speed, steering) targets: clamp the commands,
    convert them to (accel, steering rate) by finite difference over dt,
    clamp to the actuator limits and integrate one Euler step.

    Returns (pos', rot', speed', steering', sideslip', vel')."""
    v_cmd = torch.clamp(action[..., 0], -params.max_speed, params.max_speed)
    s_cmd = torch.clamp(action[..., 1], -params.max_steering, params.max_steering)
    u_acc = torch.clamp((v_cmd - speed) / dt, params.min_acc, params.max_acc)
    u_rate = torch.clamp(
        (s_cmd - steering) / dt, params.min_steering_rate, params.max_steering_rate
    )
    x0 = torch.cat([pos, rot[..., None], speed[..., None], steering[..., None]], dim=-1)
    u = torch.stack([u_acc, u_rate], dim=-1)
    x1, beta, vel = step(params, x0, u, dt, tick_per_step=1)
    return x1[..., 0:2], x1[..., 2], x1[..., 3], x1[..., 4], beta, vel
