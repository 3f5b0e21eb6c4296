"""Env-ID registry: maze families × reward variants × robots → 145 env IDs.

Port of ``mujoco_maze_tpu.registry``: the same walk over the task library
(reference mujoco-maze `__init__.py:17-78`), gated on each task's per-robot
``Scaling`` slot, including the reference's detail that the ``swimmer``
slot gates *both* Reacher and Swimmer.  No gymnasium registration in this
slice (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Type

import torch

from ._device import DeviceLike, resolve_device
from .envs.env import MazeEnvSpec
from .models.ant import AntRobot
from .models.point import PointRobot
from .models.reacher import ReacherRobot
from .models.swimmer import SwimmerRobot
from .tasks.core import MazeTask
from .tasks.library import TaskRegistry

MAX_EPISODE_STEPS = 1000  # reference __init__.py:31

_ROBOTS = {"Point": PointRobot, "Ant": AntRobot, "Swimmer": SwimmerRobot,
           "Reacher": ReacherRobot}


@dataclass(frozen=True)
class EnvEntry:
    """One registered env ID."""

    env_id: str
    robot_name: str
    maze_id: str
    version: int
    task_cls: Type[MazeTask]
    maze_size_scaling: float
    inner_reward_scaling: float
    reward_threshold: float
    max_episode_steps: int = MAX_EPISODE_STEPS


def _build_registry() -> Dict[str, EnvEntry]:
    registry: Dict[str, EnvEntry] = {}

    def add(robot_name: str, maze_id: str, i: int, task_cls, scale: float) -> None:
        env_id = f"{robot_name}{maze_id}-v{i}"
        registry[env_id] = EnvEntry(
            env_id=env_id,
            robot_name=robot_name,
            maze_id=maze_id,
            version=i,
            task_cls=task_cls,
            maze_size_scaling=scale,
            inner_reward_scaling=task_cls.INNER_REWARD_SCALING,
            reward_threshold=task_cls.REWARD_THRESHOLD,
        )

    for maze_id in TaskRegistry.keys():
        for i, task_cls in enumerate(TaskRegistry.tasks(maze_id)):
            scaling = task_cls.MAZE_SIZE_SCALING
            if scaling.point is not None:
                add("Point", maze_id, i, task_cls, scaling.point)
            if scaling.ant is not None:
                add("Ant", maze_id, i, task_cls, scaling.ant)
            if scaling.swimmer is not None:
                # The swimmer slot gates both robots (reference __init__.py:51-78).
                add("Reacher", maze_id, i, task_cls, scaling.swimmer)
                add("Swimmer", maze_id, i, task_cls, scaling.swimmer)

    return registry


ENV_REGISTRY: Dict[str, EnvEntry] = _build_registry()


def env_ids() -> List[str]:
    return list(ENV_REGISTRY.keys())


def entry(env_id: str) -> EnvEntry:
    if env_id not in ENV_REGISTRY:
        raise KeyError(f"Unknown env id {env_id!r}")
    return ENV_REGISTRY[env_id]


def make_spec(
    env_id: str,
    *,
    maze_height: float = 0.5,
    restitution_coef: float = 0.8,
    inner_reward_scaling: Optional[float] = None,
    task_kwargs: Optional[Dict[str, Any]] = None,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
):
    """Build the :class:`MazeEnvSpec` of a registered env ID on ``device``
    (``None`` means CUDA; pass ``device="cpu"`` to run without a card).
    ``inner_reward_scaling`` overrides the task's own scale of the robot's
    inner reward (JAX registry.py:112-131)."""
    e = entry(env_id)
    return MazeEnvSpec(
        robot=_ROBOTS[e.robot_name](),
        maze_task=e.task_cls,
        maze_size_scaling=e.maze_size_scaling,
        inner_reward_scaling=(e.inner_reward_scaling
                              if inner_reward_scaling is None
                              else inner_reward_scaling),
        maze_height=maze_height,
        restitution_coef=restitution_coef,
        task_kwargs=task_kwargs,
        dtype=torch.float32 if dtype is None else dtype,
        device=resolve_device(device),
    )


def make_batched(env_id: str, num_envs: int, auto_reset: bool = True,
                 device: DeviceLike = None, **kwargs):
    """The native batched lockstep env (``device=None`` means CUDA)."""
    from .envs.batched import BatchedMazeEnv

    return BatchedMazeEnv(make_spec(env_id, device=device, **kwargs), num_envs,
                          auto_reset=auto_reset)
