"""Control-affine second-order kinematics of the circle centers (batched).

The truncated-Taylor CBF constraints need the circle-center accelerations
as affine functions of u = [accel, steering_rate]; those second
derivatives are exactly affine in u, so the coefficients are computed in
closed form, vectorized over `[B, N, C]`.

State layout per agent: [x, y, psi, v, delta].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class CenterKinematics(NamedTuple):
    """Per-circle first derivatives and affine acceleration coefficients.

    All fields [..., C] or [..., C, 2]:
      ddx_c = c_ddx + a_ddx @ u,   ddy_c = c_ddy + a_ddy @ u
    """

    dx: Tensor
    dy: Tensor
    a_ddx: Tensor
    c_ddx: Tensor
    a_ddy: Tensor
    c_ddy: Tensor


def center_kinematics(
    psi: Tensor, v: Tensor, delta: Tensor, centers_local: Tensor, l_r: float, l_wb: float
) -> CenterKinematics:
    """Closed-form affine coefficients of the circle-center accelerations.
    psi, v, delta [...]; centers_local [C, 2]."""
    k = l_r / l_wb
    tan_d = torch.tan(delta)
    sec2 = 1.0 / torch.cos(delta) ** 2
    beta = torch.atan(k * tan_d)
    cos_b = torch.cos(beta)
    sin_b = torch.sin(beta)
    phi = psi + beta
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)

    dpsi = v / l_wb * tan_d * cos_b
    dx = v * cos_phi
    dy = v * sin_phi
    k_beta = k * sec2 / (1.0 + (k * tan_d) ** 2)

    # Body-frame CG acceleration, affine in u.
    a_x = torch.stack([cos_phi, -v * sin_phi * k_beta], dim=-1)
    c_x = -v * sin_phi * dpsi
    a_y = torch.stack([sin_phi, v * cos_phi * k_beta], dim=-1)
    c_y = v * cos_phi * dpsi
    # Yaw acceleration (c_psi = 0).
    a_psi = torch.stack(
        [cos_b * tan_d / l_wb, (v / l_wb) * (cos_b * sec2 - sin_b * tan_d * k_beta)],
        dim=-1,
    )

    # Chain rule to each circle center at local offset (ox, oy).
    ox = centers_local[:, 0]
    oy = centers_local[:, 1]
    sin_p, cos_p = torch.sin(psi)[..., None], torch.cos(psi)[..., None]
    dpsi_c = dpsi[..., None]
    dx_c = dx[..., None] - ox * sin_p * dpsi_c - oy * cos_p * dpsi_c
    dy_c = dy[..., None] + ox * cos_p * dpsi_c - oy * sin_p * dpsi_c

    dpsi2 = (dpsi * dpsi)[..., None]
    a_x2, a_y2, a_psi2 = a_x[..., None, :], a_y[..., None, :], a_psi[..., None, :]
    a_ddx = a_x2 - (ox * sin_p)[..., None] * a_psi2 - (oy * cos_p)[..., None] * a_psi2
    c_ddx = c_x[..., None] - ox * cos_p * dpsi2 + oy * sin_p * dpsi2
    a_ddy = a_y2 + (ox * cos_p)[..., None] * a_psi2 - (oy * sin_p)[..., None] * a_psi2
    c_ddy = c_y[..., None] - ox * sin_p * dpsi2 - oy * cos_p * dpsi2
    return CenterKinematics(dx_c, dy_c, a_ddx, c_ddx, a_ddy, c_ddy)
