"""Kinematic ball robot ("Point"), port of ``mujoco_maze_tpu.models.point``.

The reference PointEnv (mujoco-maze `point.py`): 2 actions (forward gain,
rotation delta), direct qpos integration, velocity clipping, manual wall
collision (owned by the env layer).  The reference's one ``mj_step`` per
step is replaced by the closed-form residual below, plus the impedance
ejection responses in ``ops/segments``.  All constants are derived from the
model (see the JAX package's notes), none calibrated.

Every function acts on a batch: ``qpos (B, nq)``, ``qvel (B, nv)``,
``action (B, 2)``, all float32 on one device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..physics.exact_trig import sincos
from .base import Robot, uniform_from


class PointRobot(Robot):
    NAME = "Point"
    MANUAL_COLLISION = True
    ORI_IND = 2
    RADIUS = 0.4
    OBJBALL_TYPE = "hinge"
    # the object worlds step their objects with the reduced object solve
    # (float32) or the exact mj_step replica (float64); a Point robot that
    # sets this to False keeps the quasi-static block push and the
    # kick/roll/bounce ball (JAX models/point.py:31-34)
    USES_POINT_WORLD = True

    VELOCITY_LIMITS: float = 10.0

    nq = 3  # slide x, slide y, hinge rot  (point.xml:29-31)
    nv = 3
    action_dim = 2
    frame_skip = 1      # point.py:42
    timestep = 0.02     # point.xml:3
    obs_dim = 6         # qpos[:3] + qvel[:3]  (point.py:63-69)

    # Off-axis COM of sphere + arrow box (rho = 100): r_com = m_box*0.6/m.
    COM_OFFSET: float = 4.0 * 0.6 / (4.0 + 100.0 * (4.0 / 3.0) * np.pi * 0.125)
    # Wall-contact ejection: body sphere 0.5 vs manual-collision RADIUS 0.4;
    # critically damped impedance with lam = 1/max(0.02, 2*dt), mu = 1.
    WALL_CONTACT_MARGIN: float = 0.1
    CONTACT_LAM: float = 1.0 / 0.04
    CONTACT_MU: float = 1.0
    # Leading arrow-box corners in body frame (box pos 0.6 + half 0.5).
    ARROW_TIPS = ((1.1, 0.1), (1.1, -0.1))
    # Body mass matrix constants (point.xml geom densities, rho = 100).
    _M_SPH = 100.0 * (4.0 / 3.0) * np.pi * 0.125   # 52.35988
    _M_BOX = 100.0 * (1.0 * 0.2 * 0.2)             # 4.0
    BODY_MASS: float = _M_SPH + _M_BOX             # 56.35988
    COUPLE_ARM: float = _M_BOX * 0.6               # 2.4
    SPIN_INERTIA_PRIME: float = (
        0.4 * _M_SPH * 0.25 + _M_BOX * (1.0**2 + 0.2**2) / 12.0
        + _M_BOX * 0.6**2
    ) - (_M_BOX * 0.6) ** 2 / (_M_SPH + _M_BOX)    # 6.92045

    # reset noise law (point.py:71-75): qpos ~ U(-0.1, 0.1), qvel ~ U(0, 0.1)
    QPOS_NOISE = (-0.1, 0.1)
    QVEL_NOISE = (0.0, 0.1)

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        # Dummy-actuator ctrl ranges (point.xml:29-32).
        high = np.array([1.0, 0.25], dtype=np.float64)
        return -high, high

    def init_qpos(self, height_offset: float) -> np.ndarray:
        return np.zeros(3, dtype=np.float64)

    def obs_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        # point.py:37-41
        high = np.full(6, np.inf, dtype=np.float64)
        high[3:] = self.VELOCITY_LIMITS * 1.2
        high[self.ORI_IND] = np.pi
        return -high, high

    def reset_noise(self, generator, num_envs, nq_total, nv_total):
        dev = generator.device
        uq = torch.rand((num_envs, nq_total), generator=generator, device=dev)
        uv = torch.rand((num_envs, nv_total), generator=generator, device=dev)
        return uniform_from(uq, *self.QPOS_NOISE), uniform_from(uv, *self.QVEL_NOISE)

    def kinematic_step(
        self, qpos: torch.Tensor, qvel: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's direct qpos write + velocity clip (point.py:44-57).

        Clips the FULL qvel (the reference clips ``self.data.qvel``
        wholesale).  The float64 fidelity path's sine and cosine are
        libm's to the bit (``physics/exact_trig.py``), as the JAX
        package's XLA float64 ones are.
        """
        ori = qpos[:, 2] + action[:, 1]
        # Single-branch wrap (point.py:48-51) — not a modulo.
        ori = torch.where(ori < -math.pi, ori + 2 * math.pi, ori)
        ori = torch.where(ori > math.pi, ori - 2 * math.pi, ori)
        s, c = sincos(ori)
        x = qpos[:, 0] + c * action[:, 0]
        y = qpos[:, 1] + s * action[:, 0]
        qpos = torch.cat([torch.stack([x, y, ori], dim=1), qpos[:, 3:]], dim=1)
        qvel = torch.clamp(qvel, -self.VELOCITY_LIMITS, self.VELOCITY_LIMITS)
        return qpos, qvel

    def residual_step(
        self, qpos: torch.Tensor, qvel: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The smooth mj_step residual, in closed form: drift by qvel plus
        the exact centrifugal slide acceleration of the off-axis COM under
        hinge spin ``w`` (models/point.py of the JAX package)."""
        dt = self.timestep
        r = self.COM_OFFSET
        th = qpos[:, 2]
        w = qvel[:, 2]
        th1 = th + w * dt
        s0, c0 = torch.sin(th), torch.cos(th)
        s1, c1 = torch.sin(th1), torch.cos(th1)
        dvx = w * r * (s1 - s0)
        dvy = -w * r * (c1 - c0)
        ddx = r * (c0 - c1) - w * r * s0 * dt
        ddy = r * (s0 - s1) + w * r * c0 * dt
        x = qpos[:, 0] + qvel[:, 0] * dt + ddx
        y = qpos[:, 1] + qvel[:, 1] * dt + ddy
        qpos = torch.cat([torch.stack([x, y, th1], dim=1), qpos[:, 3:]], dim=1)
        qvel = torch.cat([torch.stack([qvel[:, 0] + dvx, qvel[:, 1] + dvy,
                                       qvel[:, 2]], dim=1), qvel[:, 3:]], dim=1)
        return qpos, qvel

    def observe(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[:, :3], qvel[:, :3]], dim=1)

