"""Maze grid cell vocabulary (copy of ``mujoco_maze_tpu.maze.cells``).

The reference cell enum (mujoco-maze `maze_env_utils.py:19-81`): same 10
cell kinds and predicates, kept as a plain ``IntEnum`` so grids lower
directly to numpy ``int32`` arrays.  Copied, not imported: importing any
``mujoco_maze_tpu`` module imports JAX.
"""

from __future__ import annotations

from enum import IntEnum
from typing import List, Sequence

import numpy as np


class MazeCell(IntEnum):
    """One grid cell of a maze specification."""

    ROBOT = -1  # start position
    EMPTY = 0
    BLOCK = 1
    CHASM = 2
    OBJECT_BALL = 3
    # Movable blocks (which axes the block may translate along / spin about).
    XY_BLOCK = 14
    XZ_BLOCK = 15
    YZ_BLOCK = 16
    XYZ_BLOCK = 17
    XY_HALF_BLOCK = 18
    SPIN = 19

    # -- predicates (parity: maze_env_utils.py:35-81) --------------------
    def is_block(self) -> bool:
        return self == MazeCell.BLOCK

    def is_chasm(self) -> bool:
        return self == MazeCell.CHASM

    def is_object_ball(self) -> bool:
        return self == MazeCell.OBJECT_BALL

    def is_empty(self) -> bool:
        return self in (MazeCell.ROBOT, MazeCell.EMPTY)

    def is_robot(self) -> bool:
        return self == MazeCell.ROBOT

    def is_wall_or_chasm(self) -> bool:
        return self in (MazeCell.BLOCK, MazeCell.CHASM)

    def can_move_x(self) -> bool:
        return self in (
            MazeCell.XY_BLOCK,
            MazeCell.XY_HALF_BLOCK,
            MazeCell.XZ_BLOCK,
            MazeCell.XYZ_BLOCK,
            MazeCell.SPIN,
        )

    def can_move_y(self) -> bool:
        return self in (
            MazeCell.XY_BLOCK,
            MazeCell.XY_HALF_BLOCK,
            MazeCell.YZ_BLOCK,
            MazeCell.XYZ_BLOCK,
            MazeCell.SPIN,
        )

    def can_move_z(self) -> bool:
        return self in (MazeCell.XZ_BLOCK, MazeCell.YZ_BLOCK, MazeCell.XYZ_BLOCK)

    def can_spin(self) -> bool:
        return self == MazeCell.SPIN

    def can_move(self) -> bool:
        return self.can_move_x() or self.can_move_y() or self.can_move_z()

    def is_half_block(self) -> bool:
        return self == MazeCell.XY_HALF_BLOCK


MazeGrid = List[List[MazeCell]]


def grid_to_array(structure: Sequence[Sequence[MazeCell]]) -> np.ndarray:
    """Lower a grid of :class:`MazeCell` to a dense ``int32`` array."""
    return np.asarray([[int(c) for c in row] for row in structure], dtype=np.int32)
