"""Task abstractions: goals, scaling, reward/termination heads.

Port of ``mujoco_maze_tpu.tasks.core``.  The user-facing extension API is
the same (subclass a task, override class attributes / ``create_maze`` /
goals — reference mujoco-maze `maze_task.py:26-99`); the *lowering* step
now yields :class:`TaskHeads` whose reward and termination functions act
on a batch of observations ``(B, obs_dim)`` as torch tensors.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, List, NamedTuple, Optional, Type

import numpy as np
import torch

from ..maze.cells import MazeCell


class Rgb(NamedTuple):
    red: float
    green: float
    blue: float


RED = Rgb(0.7, 0.1, 0.1)
GREEN = Rgb(0.1, 0.7, 0.1)
BLUE = Rgb(0.1, 0.1, 0.7)


class MazeGoal:
    """A goal region (parity: maze_task.py:26-47)."""

    def __init__(
        self,
        pos: np.ndarray,
        reward_scale: float = 1.0,
        rgb: Rgb = RED,
        threshold: float = 0.6,
        custom_size: Optional[float] = None,
    ) -> None:
        assert 0.0 <= reward_scale <= 1.0
        self.pos = np.asarray(pos, dtype=np.float64)
        self.dim = self.pos.shape[0]
        self.reward_scale = reward_scale
        self.rgb = rgb
        self.threshold = threshold
        self.custom_size = custom_size

    def neighbor(self, obs: np.ndarray) -> bool:
        return bool(np.linalg.norm(obs[: self.dim] - self.pos) <= self.threshold)

    def euc_dist(self, obs: np.ndarray) -> float:
        return float(np.sum(np.square(obs[: self.dim] - self.pos)) ** 0.5)


class Scaling(NamedTuple):
    """Per-robot maze size scaling; ``None`` gates registration
    (parity: maze_task.py:50-53, __init__.py:19-78)."""

    ant: Optional[float]
    point: Optional[float]
    swimmer: Optional[float]


class GoalArrays(NamedTuple):
    """Fixed-size goal soup: the static lowering of a task's goal list."""

    pos: torch.Tensor           # (G, 3) float32, zero-padded goal positions
    dim_mask: torch.Tensor      # (G, 3) float32, 1.0 where a coordinate counts
    threshold: torch.Tensor     # (G,) float32
    reward_scale: torch.Tensor  # (G,) float32
    valid: torch.Tensor         # (G,) bool slot validity


class TaskHeads(NamedTuple):
    """Reward/termination of one task instance on a batch of observations.

    ``reward(obs, goal_pos=None) -> (B,)`` float and
    ``termination(obs, goal_pos=None) -> (B,)`` bool, for ``obs`` of shape
    ``(B, obs_dim)``.
    """

    reward: Callable[..., torch.Tensor]
    termination: Callable[..., torch.Tensor]
    goals: GoalArrays


def lower_goals(goals: List[MazeGoal], pad_to: Optional[int] = None,
                device=None) -> GoalArrays:
    g = max(len(goals), 1) if pad_to is None else pad_to
    pos = np.zeros((g, 3), dtype=np.float64)
    dim_mask = np.zeros((g, 3), dtype=np.float64)
    threshold = np.zeros((g,), dtype=np.float64)
    reward_scale = np.zeros((g,), dtype=np.float64)
    valid = np.zeros((g,), dtype=bool)
    for i, goal in enumerate(goals):
        pos[i, : goal.dim] = goal.pos
        dim_mask[i, : goal.dim] = 1.0
        threshold[i] = goal.threshold
        reward_scale[i] = goal.reward_scale
        valid[i] = True

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return GoalArrays(
        pos=f32(pos),
        dim_mask=f32(dim_mask),
        threshold=f32(threshold),
        reward_scale=f32(reward_scale),
        valid=torch.as_tensor(valid, device=device),
    )


def _goal_dist2(g: GoalArrays, p: torch.Tensor, goal_pos=None) -> torch.Tensor:
    """(B, G) squared masked distance from ``p (B, 3)`` to each goal.

    The three terms are summed in a fixed order (x, y, then z), the order
    the CUDA kernel sums them in.
    """
    pos = g.pos if goal_pos is None else goal_pos
    delta = (p[:, None, :] - pos) * g.dim_mask
    return (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]
            + delta[..., 2] * delta[..., 2])


def _goal_hits(g: GoalArrays, obs: torch.Tensor, offset: int,
               goal_pos=None) -> torch.Tensor:
    """(B, G) bool: which goals the (offset) observation position is inside."""
    dist2 = _goal_dist2(g, obs[:, offset: offset + 3], goal_pos)
    return (dist2 <= g.threshold * g.threshold) & g.valid


class MazeTask(ABC):
    """Base task. Subclass + override class attrs / goals to customize.

    Parity surface: maze_task.py:56-90.  ``REWARD_TYPE`` / ``OBS_OFFSET``
    drive the default lowering; tasks with exotic rewards override
    :meth:`lower`.
    """

    REWARD_THRESHOLD: float
    PENALTY: Optional[float] = None
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=8.0, point=4.0, swimmer=4.0)
    INNER_REWARD_SCALING: float = 0.01
    # For Fall/Push/BlockMaze
    OBSERVE_BLOCKS: bool = False
    # For Billiard
    OBSERVE_BALLS: bool = False
    OBJECT_BALL_SIZE: float = 1.0
    # Unused by stock tasks (kept for parity)
    PUT_SPIN_NEAR_AGENT: bool = False
    TOP_DOWN_VIEW: bool = False
    # Lowering hints
    REWARD_TYPE: str = "goal"  # "goal" | "dist" | "none"
    OBS_OFFSET: int = 0        # 0 = robot position, 3 = first object position

    def __init__(self, scale: float) -> None:
        self.goals: List[MazeGoal] = []
        self.scale = scale

    def sample_goals(self) -> bool:
        """Whether goals are resampled per episode (not ported yet)."""
        return False

    # -- host-side (numpy) API, kept for parity/inspection ----------------
    def termination(self, obs: np.ndarray) -> bool:
        o = np.asarray(obs)[self.OBS_OFFSET :]
        return any(goal.neighbor(o) for goal in self.goals)

    def reward(self, obs: np.ndarray) -> float:
        o = np.asarray(obs)[self.OBS_OFFSET :]
        if self.REWARD_TYPE == "none":
            return 0.0
        if self.REWARD_TYPE == "dist":
            return -self.goals[0].euc_dist(o) / self.scale
        for goal in self.goals:
            if goal.neighbor(o):
                return goal.reward_scale
        return self.PENALTY

    @staticmethod
    @abstractmethod
    def create_maze() -> List[List[MazeCell]]:
        ...

    # -- lowering to batched torch heads ----------------------------------
    def lower(self, device=None) -> TaskHeads:
        goals = lower_goals(self.goals, device=device)
        offset = self.OBS_OFFSET
        reward_type = self.REWARD_TYPE
        penalty = 0.0 if self.PENALTY is None else float(self.PENALTY)
        # the dist head multiplies by the float32 reciprocal of the scale
        # (the CUDA kernel does the same, so the two agree to the bit)
        inv_scale = float(np.float32(1.0) / np.float32(self.scale))

        def termination(obs: torch.Tensor, goal_pos=None) -> torch.Tensor:
            return _goal_hits(goals, obs, offset, goal_pos).any(dim=1)

        if reward_type == "none":

            def reward(obs: torch.Tensor, goal_pos=None) -> torch.Tensor:
                return obs.new_zeros(obs.shape[0])

        elif reward_type == "dist":

            def reward(obs: torch.Tensor, goal_pos=None) -> torch.Tensor:
                d2 = _goal_dist2(goals, obs[:, offset: offset + 3], goal_pos)[:, 0]
                return -(torch.sqrt(d2) * inv_scale)

        elif reward_type == "goal":

            def reward(obs: torch.Tensor, goal_pos=None) -> torch.Tensor:
                hits = _goal_hits(goals, obs, offset, goal_pos)
                # first hit wins (maze_task.py:357-360)
                first = torch.argmax(hits.to(torch.uint8), dim=1)
                return torch.where(
                    hits.any(dim=1), goals.reward_scale[first],
                    obs.new_full((), penalty))

        else:
            raise ValueError(f"Unknown REWARD_TYPE {reward_type!r}")

        return TaskHeads(reward=reward, termination=termination, goals=goals)


class DistRewardMixIn:
    """Dense negative-distance reward (parity: maze_task.py:93-99)."""

    REWARD_THRESHOLD: float = -1000.0
    REWARD_TYPE: str = "dist"


TaskType = Type[MazeTask]
