"""Scripted nominal controllers on tensors.

PID, constant, target following and pure pursuit on the short-term path;
each gives (speed, steering) targets that `RoadTrafficEnv.step` takes.
Batched over any leading axes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sigmarl_tpu_torch.core.geometry import angle_eliminate_two_pi

Tensor = torch.Tensor


@dataclass(frozen=True)
class PIDState:
    integral: Tensor
    prev_error: Tensor


def pid_init(shape, device=None) -> PIDState:
    return PIDState(torch.zeros(shape, device=device), torch.zeros(shape, device=device))


def pid_step(
    state: PIDState, error: Tensor, kp: float, ki: float, kd: float, dt: float
) -> tuple[Tensor, PIDState]:
    """One discrete PID update: (output, next state)."""
    integral = state.integral + error * dt
    derivative = (error - state.prev_error) / dt
    out = kp * error + ki * integral + kd * derivative
    return out, PIDState(integral, error)


def constant_controller(shape, speed: float, steering: float = 0.0, device=None) -> Tensor:
    """Constant (speed, steering) command [*shape, 2]."""
    a = torch.zeros(tuple(shape) + (2,), device=device)
    a[..., 0] = speed
    a[..., 1] = steering
    return a


def target_following(
    pos: Tensor,
    rot: Tensor,
    target: Tensor,
    speed_target: float,
    max_steering: float,
    k_heading: float = 2.0,
) -> Tensor:
    """Steer in proportion to the heading error toward `target` at
    `speed_target`. pos [..., 2]; rot [...]; target [..., 2]. Returns
    [..., 2]."""
    vec = target - pos
    heading = torch.atan2(vec[..., 1], vec[..., 0])
    err = angle_eliminate_two_pi(heading - rot)
    steer = torch.clamp(k_heading * err, -max_steering, max_steering)
    speed = torch.full_like(steer, speed_target)
    return torch.stack([speed, steer], dim=-1)


def pure_pursuit_on_short_term(
    pos: Tensor,
    rot: Tensor,
    short_term: Tensor,
    speed_target: float,
    max_steering: float,
    lookahead_index: int = 1,
) -> Tensor:
    """Aim at the `lookahead_index`-th point of the short-term reference
    path. short_term [..., S, 2]. Returns [..., 2] actions."""
    target = short_term[..., lookahead_index, :]
    return target_following(pos, rot, target, speed_target, max_steering)
