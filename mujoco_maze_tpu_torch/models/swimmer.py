"""3-link planar swimmer (port of ``mujoco_maze_tpu.models.swimmer``).

The reference SwimmerEnv (mujoco-maze `swimmer.py` + `assets/swimmer.xml`):
slide x, slide y and a hinge chain in a viscous fluid (viscosity 0.1,
density 4000), RK4 at dt 0.01 × frame_skip 4, gear-150 actuators on the
two tail hinges.  The step runs the closed-form planar dynamics
(:mod:`..ops.swimmer_math`) on the robot dofs only; the generic engine
(:mod:`..physics.engine`, with the fluid drag) is the route it is held
against, taken when ``USE_CLOSED_FORM`` is cleared.  The swimmer has no
contacts: it never meets the maze's walls, and the world dofs of the block
worlds (SwimmerPush, SwimmerFall) pass through a step unchanged.

Every function acts on a batch: ``qpos (B, nq)``, ``qvel (B, nv)``,
``action (B, action_dim)``, float32 on one device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..physics import engine
from ..physics.model import HINGE, SLIDE, Actuator, Body, Geom, Joint, build_model
from .base import Robot, uniform_from

_DEG = np.pi / 180.0


def _torso() -> Body:
    return Body(
        name="torso",
        parent=-1,
        pos=(0.0, 0.0, 0.0),
        joints=[
            Joint(SLIDE, axis=(1, 0, 0), armature=0.1, name="slider1"),
            Joint(SLIDE, axis=(0, 1, 0), armature=0.1, name="slider2"),
            Joint(HINGE, axis=(0, 0, 1), armature=0.1, name="rot"),
        ],
        geoms=[Geom.capsule_fromto((1.5, 0, 0), (0.5, 0, 0), 0.1, density=1000.0)],
    )


def _tail(name: str, parent: int, pos, joint: str) -> Body:
    return Body(
        name=name,
        parent=parent,
        pos=pos,
        joints=[Joint(HINGE, axis=(0, 0, 1), armature=0.1, limited=True,
                      range=(-100 * _DEG, 100 * _DEG), name=joint)],
        geoms=[Geom.capsule_fromto((0, 0, 0), (-1, 0, 0), 0.1, density=1000.0)],
    )


def build_swimmer_model(n_links: int = 3):
    """Content parity: assets/swimmer.xml (3 links) and assets/reacher.xml
    (its first 2 links)."""
    bodies = [_torso(), _tail("mid", 0, (0.5, 0.0, 0.0), "rot2")]
    if n_links == 3:
        bodies.append(_tail("back", 1, (-1.0, 0.0, 0.0), "rot3"))
    return build_model(
        bodies,
        [Actuator(f"rot{k}", gear=150.0, ctrlrange=(-1, 1))
         for k in range(2, n_links + 1)],
        timestep=0.01,
        viscosity=0.1,
        fluid_density=4000.0,
    )


class SwimmerRobot(Robot):
    NAME = "Swimmer"
    MANUAL_COLLISION = False
    ORI_IND = 2
    RADIUS = None
    OBJBALL_TYPE = None

    N_LINKS = 3
    nq = 5
    nv = 5
    action_dim = 2
    frame_skip = 4      # swimmer.py:30
    timestep = 0.01     # swimmer.xml:3
    obs_dim = 10        # full qpos + qvel (swimmer.py:49-53)

    FORWARD_REWARD_WEIGHT = 1.0   # swimmer.py:23
    CTRL_COST_WEIGHT = 1e-4       # swimmer.py:24
    # reset noise law (swimmer.py:55-68): qpos and qvel ~ U(-0.1, 0.1) over
    # the full state, world dofs included
    RESET_NOISE = (-0.1, 0.1)
    ZERO_WORLD_DOFS_ON_RESET = False

    USE_CLOSED_FORM = True  # ops/swimmer_math; False steps the engine

    def __init__(self) -> None:
        from ..ops import swimmer_math

        self.model = engine.prepare(build_swimmer_model(self.N_LINKS))
        self.dyn = swimmer_math.spec_from_model(self.model)

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        high = np.ones(self.action_dim, dtype=np.float64)
        return -high, high

    def init_qpos(self, height_offset: float) -> np.ndarray:
        return self.model.qpos0[: self.nq].copy()

    def obs_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        high = np.full(self.obs_dim, np.inf, dtype=np.float64)
        return -high, high

    def reset_noise(self, generator, num_envs, nq_total, nv_total):
        dev = generator.device
        uq = torch.rand((num_envs, nq_total), generator=generator, device=dev)
        uv = torch.rand((num_envs, nv_total), generator=generator, device=dev)
        return uniform_from(uq, *self.RESET_NOISE), uniform_from(uv, *self.RESET_NOISE)

    def dynamics_step(self, spec, qpos: torch.Tensor, qvel: torch.Tensor,
                      action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """frame_skip RK4 steps of the robot dofs; the world dofs after them
        pass through (no robot-object coupling, JAX ``dynamics_step``)."""
        from ..ops import swimmer_math

        ctrl = action.to(qpos.dtype)
        q, v = qpos[:, : self.nq], qvel[:, : self.nv]
        for _ in range(self.frame_skip):
            if self.USE_CLOSED_FORM:
                q, v = swimmer_math.rk4_step_swimmer(self.dyn, q, v, ctrl)
            else:
                q, v = engine.rk4_step(self.model, q, v, ctrl)
        return (torch.cat([q, qpos[:, self.nq:]], dim=1),
                torch.cat([v, qvel[:, self.nv:]], dim=1))

    def inner_reward_terms(self, xy_before: torch.Tensor,
                           xy_after: torch.Tensor, action: torch.Tensor):
        """(forward, ctrl_cost) per env (swimmer.py:32-47): the planar speed
        of the torso and the control cost on the raw action, written out
        in the kernel's order (the speed as a product with 1 / dt)."""
        inv_dt = 1.0 / self.dt
        vx = (xy_after[:, 0] - xy_before[:, 0]) * inv_dt
        vy = (xy_after[:, 1] - xy_before[:, 1]) * inv_dt
        forward = torch.sqrt(vx * vx + vy * vy)
        csq = action[:, 0] * action[:, 0]
        for a in range(1, action.shape[1]):
            csq = csq + action[:, a] * action[:, a]
        return forward, self.CTRL_COST_WEIGHT * csq

    def observe(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[:, : self.nq], qvel[:, : self.nv]], dim=1)

    def get_ori(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, self.ORI_IND]
