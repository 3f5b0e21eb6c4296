"""Robot model contract for the lockstep engine (port of
``mujoco_maze_tpu.models.base``).

A robot is a *static description* (dof layout, action space, reset-noise
law) plus functions on batched ``(B, ·)`` torch tensors that the env step
composes.  State is explicit and owned by the env.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch


class Robot(ABC):
    """Static robot description + batched dynamics functions.

    Class attrs mirror the reference contract (agent_model.py:13-17):
    ``MANUAL_COLLISION``, ``ORI_IND``, ``RADIUS``, ``OBJBALL_TYPE``; and
    the port's routing flags: ``USES_POINT_WORLD`` (a manual-collision
    robot whose object worlds take the object solve in float32 and the
    exact replica in float64; without it the quasi-static push and the
    kick/roll/bounce ball, JAX envs/env.py:143-191) and, for robots on
    the rigid-body engine, ``USES_WORLD_ENGINE``.
    """

    NAME: str
    MANUAL_COLLISION: bool
    ORI_IND: Optional[int] = None
    RADIUS: Optional[float] = None
    OBJBALL_TYPE: Optional[str] = None
    USES_POINT_WORLD: bool = False

    nq: int            # robot generalized coordinates
    nv: int            # robot dofs
    action_dim: int
    frame_skip: int
    timestep: float
    obs_dim: int       # robot-only observation length

    # Whether reset zeroes noise on world (non-robot) dofs.
    ZERO_WORLD_DOFS_ON_RESET: bool = True

    @property
    def dt(self) -> float:
        return self.timestep * self.frame_skip

    @abstractmethod
    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(low, high) of the action box."""

    @abstractmethod
    def init_qpos(self, height_offset: float) -> np.ndarray:
        """Robot qpos0 (world-frame origin at the maze's ROBOT cell)."""

    @abstractmethod
    def obs_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(low, high) of the robot observation box."""

    @abstractmethod
    def reset_noise(
        self, generator: torch.Generator, num_envs: int, nq_total: int,
        nv_total: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Additive reset noise ``(B, nq_total)``, ``(B, nv_total)`` over the
        full state vectors, drawn from ``generator`` on its device."""

    @abstractmethod
    def observe(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        """Robot observation ``(B, obs_dim)`` from the full state."""


def uniform_from(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``lo + u * (hi - lo)`` in float32, for ``u`` uniform on [0, 1)."""
    width = float(np.float32(hi) - np.float32(lo))
    return lo + u * width
