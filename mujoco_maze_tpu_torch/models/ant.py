"""Quadruped "Ant" robot with contact dynamics (port of
``mujoco_maze_tpu.models.ant``).

The reference AntEnv (mujoco-maze `ant.py` + `assets/ant.xml`): a 13-body
tree with a free root, 8 torque-controlled hinges (ctrlrange ±30), RK4 at
dt 0.02 × frame_skip 5.  The ant meets the maze through the engine's
contact pipeline, so its dynamics run on the world model (robot + static
maze geoms) that the env spec composes.

Every function acts on a batch: ``qpos (B, nq)``, ``qvel (B, nv)``,
``action (B, 8)``, float32 on one device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..physics import contact, engine
from ..physics.math3d import quat_rotate
from ..physics.model import FREE, HINGE, Actuator, Body, Geom, Joint
from .base import Robot, uniform_from

_DEG = np.pi / 180.0

# shared geom params (ant.xml default class)
_GEOM = dict(
    density=5.0,
    friction=(1.0, 0.5, 0.5),
    solref=(0.02, 1.0),
    solimp=(0.8, 0.8, 0.01),
    margin=0.01,
    contype=1,
    conaffinity=0,
)


def build_ant_bodies(torso_z: float = 0.75) -> Tuple[List[Body], List[Actuator]]:
    """The 13-body ant tree (content parity: assets/ant.xml:21-68)."""

    def capsule(p2):
        return Geom.capsule_fromto((0, 0, 0), p2, 0.08, **_GEOM)

    bodies = [
        Body(
            name="torso",
            parent=-1,
            pos=(0.0, 0.0, torso_z),
            joints=[Joint(FREE, name="root")],
            geoms=[Geom(gtype=0, size=(0.25,), **_GEOM)],  # sphere
        )
    ]
    # leg layout: (name suffix, xy sign pair, ankle axis, ankle range)
    legs = [
        ("1", (+1, +1), (-1, 1, 0), (30, 70)),    # front_left
        ("2", (-1, +1), (1, 1, 0), (-70, -30)),   # front_right
        ("3", (-1, -1), (-1, 1, 0), (-70, -30)),  # back
        ("4", (+1, -1), (1, 1, 0), (30, 70)),     # right_back
    ]
    for name, (sx, sy), ankle_axis, ankle_range in legs:
        base = len(bodies)
        bodies.append(Body(name=f"leg_{name}", parent=0, pos=(0.0, 0.0, 0.0),
                           geoms=[capsule((0.2 * sx, 0.2 * sy, 0.0))]))
        bodies.append(Body(
            name=f"aux_{name}", parent=base, pos=(0.2 * sx, 0.2 * sy, 0.0),
            joints=[Joint(HINGE, axis=(0, 0, 1), armature=1.0, damping=1.0,
                          limited=True, range=(-30 * _DEG, 30 * _DEG),
                          name=f"hip_{name}")],
            geoms=[capsule((0.2 * sx, 0.2 * sy, 0.0))]))
        bodies.append(Body(
            name=f"foot_{name}", parent=base + 1, pos=(0.2 * sx, 0.2 * sy, 0.0),
            joints=[Joint(HINGE, axis=ankle_axis, armature=1.0, damping=1.0,
                          limited=True,
                          range=(ankle_range[0] * _DEG, ankle_range[1] * _DEG),
                          name=f"ankle_{name}")],
            geoms=[capsule((0.4 * sx, 0.4 * sy, 0.0))]))
    # actuator order parity (hip_4, ankle_4, hip_1, ... — ant.xml:71-78)
    actuators = [
        Actuator(f"{kind}_{name}", gear=1.0, ctrlrange=(-30.0, 30.0))
        for name in ("4", "1", "2", "3")
        for kind in ("hip", "ankle")
    ]
    return bodies, actuators


class AntRobot(Robot):
    NAME = "Ant"
    MANUAL_COLLISION = False
    ORI_IND = 3
    RADIUS = None
    OBJBALL_TYPE = "freejoint"
    USES_WORLD_ENGINE = True

    nq = 15
    nv = 14
    action_dim = 8
    frame_skip = 5      # ant.py:54
    timestep = 0.02     # ant.xml:3
    obs_dim = 29        # qpos[:15] + qvel[:14] (ant.py:75-82)

    FORWARD_REWARD_WEIGHT = 1.0   # ant.py:47
    CTRL_COST_WEIGHT = 1e-4       # ant.py:48
    CONTACT_MARGIN = 0.01         # ant.xml default geom margin
    # default-class geom params applied to world geoms composed into the
    # ant's model (the reference XML defaults propagate to maze geoms)
    WORLD_GEOM_DEFAULTS = dict(
        density=5.0,
        friction=(1.0, 0.5, 0.5),
        solref=(0.02, 1.0),
        solimp=(0.8, 0.8, 0.01),
        margin=0.01,
    )
    # reset noise law (ant.py:84-96): qpos ~ U(-0.1, 0.1), qvel ~ N(0, 0.1)
    QPOS_NOISE = (-0.1, 0.1)
    QVEL_STD = 0.1

    def build_bodies(self, torso_z: float = 0.75):
        return build_ant_bodies(torso_z)

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        high = np.full(self.action_dim, 30.0)
        return -high, high

    def init_qpos(self, height_offset: float) -> np.ndarray:
        qpos = np.zeros(self.nq)
        qpos[2] = 0.75 + height_offset
        qpos[3] = 1.0
        return qpos

    def obs_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        high = np.full(self.obs_dim, np.inf)
        return -high, high

    def reset_noise(self, generator, num_envs, nq_total, nv_total):
        dev = generator.device
        uq = torch.rand((num_envs, nq_total), generator=generator, device=dev)
        nv = torch.randn((num_envs, nv_total), generator=generator, device=dev)
        return uniform_from(uq, *self.QPOS_NOISE), nv * self.QVEL_STD

    @staticmethod
    def extra_force(spec):
        """The constraint forces the engine adds to the joint limits:
        contacts and the falling blocks' support (JAX models/ant.py:201-205),
        as ``extra_qfrc(kd, qacc0, Minv, qvel)``."""
        model = spec.dynamic_model
        cset = spec.contact_set
        _, chain_mask, _, _ = engine.get_masks(model)

        def extra_cb(kd, qacc0, Minv, qvel_now):
            qfrc = contact.contact_qfrc(model, cset, kd, qvel_now, qacc0,
                                        Minv, chain_mask)
            if spec._falling_support:
                qfrc = qfrc + spec.support_qfrc(kd, qacc0, Minv, qvel_now)
            return qfrc

        return extra_cb

    def dynamics_step(self, spec, qpos: torch.Tensor, qvel: torch.Tensor,
                      action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """frame_skip RK4 steps on the world model, with contacts and the
        falling blocks' support."""
        ctrl = action.to(qpos.dtype)
        extra_cb = self.extra_force(spec)
        for _ in range(self.frame_skip):
            qpos, qvel = engine.rk4_step(spec.dynamic_model, qpos, qvel, ctrl,
                                         extra_qfrc=extra_cb)
        return qpos, qvel

    def inner_reward_terms(self, xy_before: torch.Tensor,
                           xy_after: torch.Tensor, action: torch.Tensor):
        """(forward, ctrl_cost) per env (ant.py:56-73): the planar speed of
        the torso and the control cost on the raw action."""
        vel = (xy_after - xy_before) / self.dt
        forward = torch.sqrt(torch.sum(vel * vel, dim=1))
        ctrl_cost = self.CTRL_COST_WEIGHT * torch.sum(action * action, dim=1)
        return forward, ctrl_cost

    def observe(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[:, :15], qvel[:, :14]], dim=1)

    def get_ori(self, qpos: torch.Tensor) -> torch.Tensor:
        """Heading: body-x axis projected on the xy plane (ant.py:98-103)."""
        ex = torch.zeros_like(qpos[:, :3])
        ex[:, 0] = 1.0
        v = quat_rotate(qpos[:, 3:7], ex)
        return torch.atan2(v[:, 1], v[:, 0])
