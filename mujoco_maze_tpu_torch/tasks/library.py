"""The stock task library: 18 maze families x 2-5 reward variants
(copy of ``mujoco_maze_tpu.tasks.library``, quirks kept verbatim).

Grid layouts, goal placements, scalings and thresholds replicate the
reference task registry exactly (mujoco-maze `maze_task.py:
102-807`) — including its documented quirks (``NoRewardMultiFall`` subclasses
``GoalRewardFall``, maze_task.py:342) — because the registry defines the
env-ID semantics.  All behavior is expressed through the declarative
``REWARD_TYPE``/``OBS_OFFSET``/goal-list lowering of :mod:`.core`.

Deliberate divergence (intended-behavior call): the reference declares
``class DistRewardX(GoalRewardX, DistRewardMixIn)`` with the mixin *last*, so
under Python MRO the goal class's ``reward``/``REWARD_THRESHOLD`` win and
most reference "DistReward" tasks silently behave as sparse goal-reward tasks
(threshold 0.9) — contradicting the reference README ("v0: Distance-based
Reward") and its own mixin (maze_task.py:93-99).  Verified empirically against
the reference classes.  Here the mixin is listed first, so v0 tasks produce
the documented dense distance reward with ``REWARD_THRESHOLD = -1000``.
``DistRewardBilliard``/``BlockCarry``/``SmallBilliard`` define ``reward``
directly in the reference and were true dist-reward there; unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np

from ..maze.cells import MazeCell
from .core import GREEN, DistRewardMixIn, MazeGoal, MazeTask, Scaling

E, B, R = MazeCell.EMPTY, MazeCell.BLOCK, MazeCell.ROBOT
C = MazeCell.CHASM
OB = MazeCell.OBJECT_BALL
MXY = MazeCell.XY_BLOCK
MYZ = MazeCell.YZ_BLOCK
MXYZ = MazeCell.XYZ_BLOCK


# ---------------------------------------------------------------- UMaze --
class GoalRewardUMaze(MazeTask):
    """maze_task.py:102-122"""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([0.0, 2.0 * scale]))]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, R, E, E, B],
            [B, B, B, E, B],
            [B, E, E, E, B],
            [B, B, B, B, B],
        ]


class DistRewardUMaze(DistRewardMixIn, GoalRewardUMaze):
    pass


# ----------------------------------------------------------- SimpleRoom --
class GoalRewardSimpleRoom(GoalRewardUMaze):
    """maze_task.py:129-141"""

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([2.0 * scale, 0.0]))]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, R, E, E, B],
            [B, B, B, B, B],
        ]


class DistRewardSimpleRoom(DistRewardMixIn, GoalRewardSimpleRoom):
    pass


# ----------------------------------------------------------- SquareRoom --
class GoalRewardSquareRoom(GoalRewardUMaze):
    """maze_task.py:148-164"""

    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.5, point=4.0, swimmer=2.0)

    def __init__(self, scale: float, goal: Tuple[float, float] = (1.0, 0.0)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array(goal) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, E, E, E, B],
            [B, E, R, E, B],
            [B, E, E, E, B],
            [B, B, B, B, B],
        ]


class NoRewardSquareRoom(GoalRewardSquareRoom):
    REWARD_TYPE: str = "none"

    def __init__(self, scale: float) -> None:
        super().__init__(scale)


class DistRewardSquareRoom(DistRewardMixIn, GoalRewardSquareRoom):
    pass


# ----------------------------------------------------------------- Push --
class GoalRewardPush(GoalRewardUMaze):
    """maze_task.py:179-195"""

    OBSERVE_BLOCKS: bool = True

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([0.0, 2.375]) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, E, R, B, B],
            [B, E, MXY, E, B],
            [B, B, E, B, B],
            [B, B, B, B, B],
        ]


class DistRewardPush(DistRewardMixIn, GoalRewardPush):
    pass


# ------------------------------------------------------------ MultiPush --
class GoalRewardMultiPush(GoalRewardUMaze):
    """maze_task.py:202-221"""

    OBSERVE_BLOCKS: bool = True
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.0, point=6.0, swimmer=None)

    def __init__(self, scale: float, goal: Tuple[float, float] = (1.0, -2)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array(goal) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B],
            [B, B, B, E, B, B],
            [B, E, E, MXY, E, B],
            [B, E, R, E, B, B],
            [B, E, E, MXY, E, B],
            [B, B, B, E, B, B],
            [B, B, B, B, B, B],
        ]


class DistRewardMultiPush(DistRewardMixIn, GoalRewardMultiPush):
    pass


class NoRewardMultiPush(GoalRewardMultiPush):
    REWARD_TYPE: str = "none"


# ------------------------------------------------------- MultiPushSmall --
class GoalRewardMultiPushSmall(GoalRewardMultiPush):
    """maze_task.py:233-248"""

    def __init__(self, scale: float, goal: Tuple[float, float] = (1.0, -1.0)) -> None:
        super().__init__(scale, goal)

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B],
            [B, B, E, B, B, B],
            [B, E, MXY, E, B, B],
            [B, B, R, MXY, E, B],
            [B, E, MXY, E, B, B],
            [B, B, E, B, B, B],
            [B, B, B, B, B, B],
        ]


class DistRewardMultiPushSmall(DistRewardMixIn, GoalRewardMultiPushSmall):
    pass


class NoRewardMultiPushSmall(GoalRewardMultiPushSmall):
    REWARD_TYPE: str = "none"


# ------------------------------------------------------------- PushMaze --
class GoalRewardPushMaze(GoalRewardUMaze):
    """maze_task.py:260-278"""

    OBSERVE_BLOCKS: bool = True
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.0, point=6.0, swimmer=None)

    def __init__(self, scale: float, goal: Tuple[float, float] = (3.0, 0.0)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array(goal) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B],
            [B, E, E, R, MXY, E, B],
            [B, B, B, B, E, B, B],
            [B, E, MXY, E, MXY, B, B],
            [B, B, E, B, E, B, B],
            [B, B, B, B, B, B, B],
        ]


class DistRewardPushMaze(DistRewardMixIn, GoalRewardPushMaze):
    pass


class NoRewardPushMaze(GoalRewardPushMaze):
    REWARD_TYPE: str = "none"


# ----------------------------------------------------------------- Fall --
class GoalRewardFall(GoalRewardUMaze):
    """maze_task.py:290-308"""

    OBSERVE_BLOCKS: bool = True

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([0.0, 3.375, 4.5]) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B],
            [B, R, E, B],
            [B, E, MYZ, B],
            [B, C, C, B],
            [B, E, E, B],
            [B, B, B, B],
        ]


class DistRewardFall(DistRewardMixIn, GoalRewardFall):
    pass


# ------------------------------------------------------------ MultiFall --
class GoalRewardMultiFall(GoalRewardUMaze):
    """maze_task.py:315-335"""

    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.0, point=None, swimmer=None)
    OBSERVE_BLOCKS: bool = True
    PENALTY: float = -0.0001

    def __init__(self, scale: float, goal: Tuple[float, float] = (3.0, 1.0)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([*goal, 0.5]) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B],
            [B, R, E, C, E, B],
            [B, E, MXYZ, C, E, B],
            [B, C, C, B, B, B],
            [B, E, E, B, B, B],
            [B, B, B, B, B, B],
        ]


class DistRewardMultiFall(DistRewardMixIn, GoalRewardMultiFall):
    pass


class NoRewardMultiFall(GoalRewardFall):
    # Reference quirk kept verbatim: subclasses GoalRewardFall, *not*
    # GoalRewardMultiFall, so `<robot>MultiFall-v2` uses the Fall maze
    # (maze_task.py:342-344).
    REWARD_TYPE: str = "none"


# --------------------------------------------------------------- 2Rooms --
class GoalReward2Rooms(MazeTask):
    """maze_task.py:347-373"""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=4.0, point=4.0, swimmer=4.0)

    def __init__(self, scale: float, goal: Tuple[float, float] = (4.0, -2.0)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array(goal) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B, B],
            [B, E, E, E, B, E, E, B],
            [B, E, E, E, B, E, E, B],
            [B, E, R, E, B, E, E, B],
            [B, E, E, E, B, E, E, B],
            [B, E, E, E, E, E, E, B],
            [B, B, B, B, B, B, B, B],
        ]


class DistReward2Rooms(DistRewardMixIn, GoalReward2Rooms):
    pass


class SubGoal2Rooms(GoalReward2Rooms):
    """maze_task.py:380-391"""

    def __init__(
        self,
        scale: float,
        primary_goal: Tuple[float, float] = (4.0, -2.0),
        subgoals: List[Tuple[float, float]] = [(1.0, -2.0), (-1.0, 2.0)],
    ) -> None:
        super().__init__(scale, primary_goal)
        for subgoal in subgoals:
            self.goals.append(
                MazeGoal(np.array(subgoal) * scale, reward_scale=0.5, rgb=GREEN)
            )


# --------------------------------------------------------------- 4Rooms --
class GoalReward4Rooms(MazeTask):
    """maze_task.py:394-422"""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=4.0, point=4.0, swimmer=4.0)

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([6.0 * scale, -6.0 * scale]))]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B, B, B],
            [B, E, E, E, B, E, E, E, B],
            [B, E, E, E, E, E, E, E, B],
            [B, E, E, E, B, E, E, E, B],
            [B, B, E, B, B, B, E, B, B],
            [B, E, E, E, B, E, E, E, B],
            [B, E, E, E, E, E, E, E, B],
            [B, R, E, E, B, E, E, E, B],
            [B, B, B, B, B, B, B, B, B],
        ]


class DistReward4Rooms(DistRewardMixIn, GoalReward4Rooms):
    pass


class SubGoal4Rooms(GoalReward4Rooms):
    """maze_task.py:429-435"""

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals += [
            MazeGoal(np.array([0.0 * scale, -6.0 * scale]), 0.5, GREEN),
            MazeGoal(np.array([6.0 * scale, 0.0 * scale]), 0.5, GREEN),
        ]


# ---------------------------------------------------------------- TRoom --
class GoalRewardTRoom(MazeTask):
    """maze_task.py:438-463"""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=4.0, point=4.0, swimmer=4.0)

    def __init__(self, scale: float, goal: Tuple[float, float] = (2.0, -3.0)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array(goal) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B],
            [B, E, E, B, E, E, B],
            [B, E, E, B, E, E, B],
            [B, E, B, B, B, E, B],
            [B, E, E, R, E, E, B],
            [B, B, B, B, B, B, B],
        ]


class DistRewardTRoom(DistRewardMixIn, GoalRewardTRoom):
    pass


class SubGoalTRoom(GoalRewardTRoom):
    """maze_task.py:470-480"""

    def __init__(
        self,
        scale: float,
        primary_goal: Tuple[float, float] = (2.0, -3.0),
        subgoal: Tuple[float, float] = (-2.0, -3.0),
    ) -> None:
        super().__init__(scale, primary_goal)
        self.goals.append(
            MazeGoal(np.array(subgoal) * scale, reward_scale=0.5, rgb=GREEN)
        )


# ------------------------------------------------------------- Corridor --
class NoRewardCorridor(MazeTask):
    """maze_task.py:483-503"""

    REWARD_THRESHOLD: float = 0.0
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=4.0, point=4.0, swimmer=1.0)
    REWARD_TYPE: str = "none"

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B, B, B],
            [B, E, E, B, E, E, E, E, B],
            [B, E, E, B, E, E, E, E, B],
            [B, E, E, E, E, E, B, B, B],
            [B, E, E, E, R, E, E, E, B],
            [B, B, B, E, E, E, E, E, B],
            [B, E, E, E, E, B, E, E, B],
            [B, E, E, E, E, B, E, E, B],
            [B, B, B, B, B, B, B, B, B],
        ]


class GoalRewardCorridor(NoRewardCorridor):
    """maze_task.py:506-518"""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001
    REWARD_TYPE: str = "goal"

    def __init__(self, scale: float, goal: Tuple[float, float] = (3.0, -3.0)) -> None:
        super().__init__(scale)
        self.goals.append(MazeGoal(np.array(goal) * scale))


class DistRewardCorridor(DistRewardMixIn, GoalRewardCorridor):
    pass


# --------------------------------------------------------- LongCorridor --
class GoalRewardLongCorridor(GoalRewardUMaze):
    """maze_task.py:525-542"""

    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.0, point=4.0, swimmer=2.0)

    def __init__(self, scale: float, goal: Tuple[float, float] = (1.0, 3.0)) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array(goal) * scale)]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B, B, B],
            [B, R, B, E, E, E, B, E, B],
            [B, E, B, E, B, E, B, E, B],
            [B, E, B, E, B, E, B, E, B],
            [B, E, E, E, B, E, E, E, B],
            [B, B, B, B, B, B, B, B, B],
        ]


class DistRewardLongCorridor(DistRewardMixIn, GoalRewardLongCorridor):
    pass


# ------------------------------------------------------------ BlockMaze --
class GoalRewardBlockMaze(GoalRewardUMaze):
    """maze_task.py:549-568"""

    MAZE_SIZE_SCALING: Scaling = Scaling(ant=8.0, point=4.0, swimmer=None)
    OBSERVE_BLOCKS: bool = True

    def __init__(self, scale: float) -> None:
        super().__init__(scale)
        self.goals = [MazeGoal(np.array([0.0, 3.0 * scale]))]

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, R, E, E, B],
            [B, B, B, MXY, B],
            [B, E, E, E, B],
            [B, E, E, E, B],
            [B, B, B, B, B],
        ]


class DistRewardBlockMaze(DistRewardMixIn, GoalRewardBlockMaze):
    pass


# ----------------------------------------------------------- BlockCarry --
class GoalRewardBlockCarry(MazeTask):
    """maze_task.py:575-616 — reward/termination on the *block* position
    (obs[3:6])."""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.0, point=3.0, swimmer=None)
    OBSERVE_BLOCKS: bool = True
    GOAL_SIZE: float = 0.3
    OBS_OFFSET: int = 3

    def __init__(self, scale: float, goal: Tuple[float, float] = (2.0, 0.0)) -> None:
        super().__init__(scale)
        self.goals.append(
            MazeGoal(
                np.array(goal) * scale,
                threshold=self.GOAL_SIZE + 0.5,
                custom_size=self.GOAL_SIZE,
            )
        )

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, E, E, E, B],
            [B, R, MXY, E, B],
            [B, E, E, E, B],
            [B, B, B, B, B],
        ]


class DistRewardBlockCarry(GoalRewardBlockCarry):
    REWARD_TYPE: str = "dist"


class NoRewardBlockCarry(GoalRewardBlockCarry):
    REWARD_TYPE: str = "none"


# ------------------------------------------------------------- Billiard --
class GoalRewardBilliard(MazeTask):
    """maze_task.py:629-672 — reward/termination on the *ball* position
    (obs[3:6])."""

    REWARD_THRESHOLD: float = 0.9
    PENALTY: float = -0.0001
    MAZE_SIZE_SCALING: Scaling = Scaling(ant=None, point=3.0, swimmer=None)
    OBSERVE_BALLS: bool = True
    GOAL_SIZE: float = 0.3
    OBS_OFFSET: int = 3

    def __init__(self, scale: float, goal: Tuple[float, float] = (2.0, -3.0)) -> None:
        super().__init__(scale)
        goal = np.array(goal) * scale
        self.goals.append(
            MazeGoal(goal, threshold=self._threshold(), custom_size=self.GOAL_SIZE)
        )

    def _threshold(self) -> float:
        return self.OBJECT_BALL_SIZE + self.GOAL_SIZE

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B],
            [B, E, E, E, E, E, B],
            [B, E, E, E, E, E, B],
            [B, E, E, OB, E, E, B],
            [B, E, E, R, E, E, B],
            [B, E, E, E, E, E, B],
            [B, B, B, B, B, B, B],
        ]


class DistRewardBilliard(GoalRewardBilliard):
    REWARD_TYPE: str = "dist"


class NoRewardBilliard(GoalRewardBilliard):
    REWARD_TYPE: str = "none"

    def __init__(self, scale: float) -> None:
        # Parity: maze_task.py:681-682 — skips goal creation entirely.
        MazeTask.__init__(self, scale)


class SubGoalBilliard(GoalRewardBilliard):
    """maze_task.py:688-705"""

    def __init__(
        self,
        scale: float,
        primary_goal: Tuple[float, float] = (2.0, -3.0),
        subgoals: List[Tuple[float, float]] = [(-2.0, -3.0), (-2.0, 1.0), (2.0, 1.0)],
    ) -> None:
        super().__init__(scale, primary_goal)
        for subgoal in subgoals:
            self.goals.append(
                MazeGoal(
                    np.array(subgoal) * scale,
                    reward_scale=0.5,
                    rgb=GREEN,
                    threshold=self._threshold(),
                    custom_size=self.GOAL_SIZE,
                )
            )


class BanditBilliard(SubGoalBilliard):
    """maze_task.py:708-729"""

    def __init__(
        self,
        scale: float,
        primary_goal: Tuple[float, float] = (4.0, -2.0),
        subgoals: List[Tuple[float, float]] = [(4.0, 2.0)],
    ) -> None:
        super().__init__(scale, primary_goal, subgoals)

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B, B, B],
            [B, E, E, B, B, E, B],
            [B, E, E, E, E, E, B],
            [B, R, OB, E, B, B, B],
            [B, E, E, E, E, E, B],
            [B, E, E, E, E, E, B],
            [B, B, B, B, B, B, B],
        ]


# -------------------------------------------------------- SmallBilliard --
class GoalRewardSmallBilliard(GoalRewardBilliard):
    """maze_task.py:732-753"""

    MAZE_SIZE_SCALING: Scaling = Scaling(ant=2.0, point=4.0, swimmer=None)
    OBJECT_BALL_SIZE: float = 0.4
    GOAL_SIZE: float = 0.2

    def __init__(self, scale: float, goal: Tuple[float, float] = (-1.0, -2.0)) -> None:
        super().__init__(scale, goal)

    @staticmethod
    def create_maze() -> List[List[MazeCell]]:
        return [
            [B, B, B, B, B],
            [B, E, E, E, B],
            [B, E, OB, E, B],
            [B, E, R, E, B],
            [B, B, B, B, B],
        ]


class DistRewardSmallBilliard(GoalRewardSmallBilliard):
    REWARD_TYPE: str = "dist"
    REWARD_THRESHOLD: float = -1000.0


class NoRewardSmallBilliard(GoalRewardSmallBilliard):
    REWARD_TYPE: str = "none"


# -------------------------------------------------------------- Registry --
class TaskRegistry:
    """maze_task.py:765-807 — key → ordered task variants (index == version)."""

    REGISTRY: Dict[str, List[Type[MazeTask]]] = {
        "SimpleRoom": [DistRewardSimpleRoom, GoalRewardSimpleRoom],
        "SquareRoom": [DistRewardSquareRoom, GoalRewardSquareRoom, NoRewardSquareRoom],
        "UMaze": [DistRewardUMaze, GoalRewardUMaze],
        "Push": [DistRewardPush, GoalRewardPush],
        "MultiPush": [DistRewardMultiPush, GoalRewardMultiPush, NoRewardMultiPush],
        "MultiPushSmall": [
            DistRewardMultiPushSmall,
            GoalRewardMultiPushSmall,
            NoRewardMultiPushSmall,
        ],
        "PushMaze": [DistRewardPushMaze, GoalRewardPushMaze, NoRewardPushMaze],
        "Fall": [DistRewardFall, GoalRewardFall],
        "MultiFall": [DistRewardMultiFall, GoalRewardMultiFall, NoRewardMultiFall],
        "2Rooms": [DistReward2Rooms, GoalReward2Rooms, SubGoal2Rooms],
        "4Rooms": [DistReward4Rooms, GoalReward4Rooms, SubGoal4Rooms],
        "TRoom": [DistRewardTRoom, GoalRewardTRoom, SubGoalTRoom],
        "BlockMaze": [DistRewardBlockMaze, GoalRewardBlockMaze],
        "Corridor": [DistRewardCorridor, GoalRewardCorridor, NoRewardCorridor],
        "LongCorridor": [DistRewardLongCorridor, GoalRewardLongCorridor],
        "BlockCarry": [DistRewardBlockCarry, GoalRewardBlockCarry, NoRewardBlockCarry],
        "Billiard": [
            DistRewardBilliard,  # v0
            GoalRewardBilliard,  # v1
            SubGoalBilliard,  # v2
            BanditBilliard,  # v3
            NoRewardBilliard,  # v4
        ],
        "SmallBilliard": [
            DistRewardSmallBilliard,
            GoalRewardSmallBilliard,
            NoRewardSmallBilliard,
        ],
    }

    @staticmethod
    def keys() -> List[str]:
        return list(TaskRegistry.REGISTRY.keys())

    @staticmethod
    def tasks(key: str) -> List[Type[MazeTask]]:
        return TaskRegistry.REGISTRY[key]
