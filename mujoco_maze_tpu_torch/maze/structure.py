"""Static analysis of a maze grid (copy of ``mujoco_maze_tpu.maze.structure``).

The reference performs this work by synthesizing MuJoCo XML at env
construction (mujoco-maze `maze_env.py:97-217`).  Here the same scan
lowers the grid directly to numpy arrays (wall boxes, movable blocks,
object balls, robot origin, xy limits), which the env spec turns into
device tables once, at construction.
"""

from __future__ import annotations

import itertools as it
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from .cells import MazeCell
from .collision import extract_wall_segments


@dataclass(frozen=True)
class MovableBlockSpec:
    """One movable block (Push/Fall/Spin cells — maze_env.py:563-660)."""

    row: int
    col: int
    pos: Tuple[float, float, float]       # body frame origin (x, y, h)
    size: Tuple[float, float, float]      # half-extents (sx, sy, h)
    move_x: bool
    move_y: bool
    move_z: bool
    spin: bool
    falling: bool                         # z-limited slide (range -offset..0)
    mass: float
    z_range: Tuple[float, float]          # slide-z joint limits
    xy_range: float                       # ± slide limit when falling

    @property
    def name(self) -> str:
        return f"movable_{self.row}_{self.col}"


@dataclass(frozen=True)
class ObjectBallSpec:
    """One object ball (Billiard cells — maze_env.py:489-560)."""

    row: int
    col: int
    pos: Tuple[float, float]              # body frame origin (x, y); geom z = size
    size: float                           # radius

    @property
    def name(self) -> str:
        return f"objball_{self.row}_{self.col}"


@dataclass(frozen=True)
class MazeStructure:
    """Everything static derivable from (grid, scaling, maze_height)."""

    grid: np.ndarray                      # (H, W) int32 of MazeCell values
    size_scaling: float
    height: float
    torso_x: float                        # robot origin offset (maze_env.py:63-68)
    torso_y: float
    elevated: bool                        # any CHASM → world lifted (maze_env.py:59)
    any_blocks: bool                      # any movable block (maze_env.py:61)
    height_offset: float                  # height * scaling if elevated else 0
    init_positions: Tuple[Tuple[float, float], ...]
    # Static wall boxes (BLOCK cells): centers (n,3), half-extents (n,3)
    block_pos: np.ndarray
    block_size: np.ndarray
    # Elevated platform boxes (non-CHASM cells when elevated)
    platform_pos: np.ndarray
    platform_size: np.ndarray
    movable_blocks: Tuple[MovableBlockSpec, ...] = field(default_factory=tuple)
    object_balls: Tuple[ObjectBallSpec, ...] = field(default_factory=tuple)

    def wall_segments(self, radius: float) -> np.ndarray:
        """Robot-radius-inflated wall faces for manual collision."""
        structure = [[MazeCell(v) for v in row] for row in self.grid]
        return extract_wall_segments(
            structure, self.size_scaling, self.torso_x, self.torso_y, radius
        )

    def xy_limits(self) -> Tuple[float, float, float, float]:
        """(xmin, xmax, ymin, ymax) of non-BLOCK cells (maze_env.py:248-260)."""
        xmin, ymin, xmax, ymax = 100.0, 100.0, -100.0, -100.0
        h, w = self.grid.shape
        for i, j in it.product(range(h), range(w)):
            if MazeCell(self.grid[i, j]).is_block():
                continue
            xmin, xmax = min(xmin, j), max(xmax, j)
            ymin, ymax = min(ymin, i), max(ymax, i)
        s = self.size_scaling
        xmin, xmax = (xmin - 0.5) * s - self.torso_x, (xmax + 0.5) * s - self.torso_x
        ymin, ymax = (ymin - 0.5) * s - self.torso_y, (ymax + 0.5) * s - self.torso_y
        return xmin, xmax, ymin, ymax


def _find_robots(structure: Sequence[Sequence[MazeCell]], s: float):
    coords = []
    for i, j in it.product(range(len(structure)), range(len(structure[0]))):
        if structure[i][j].is_robot():
            coords.append((j * s, i * s))
    if not coords:
        raise ValueError("No robot in maze specification.")
    return coords


def analyze_maze(
    structure: Sequence[Sequence[MazeCell]],
    size_scaling: float,
    maze_height: float = 0.5,
    put_spin_near_agent: bool = False,
) -> MazeStructure:
    """Scan a grid the way ``MazeEnv.__init__`` does (maze_env.py:57-191)."""
    h_cells, w_cells = len(structure), len(structure[0])
    elevated = any(MazeCell.CHASM in row for row in structure)
    any_blocks = any(any(c.can_move() for c in row) for row in structure)

    robots = _find_robots(structure, size_scaling)
    torso_x, torso_y = robots[0]
    init_positions = tuple((x - torso_x, y - torso_y) for x, y in robots)

    height_offset = maze_height * size_scaling if elevated else 0.0
    h = maze_height / 2 * size_scaling
    half = size_scaling * 0.5

    block_pos: List[Tuple[float, float, float]] = []
    block_size: List[Tuple[float, float, float]] = []
    platform_pos: List[Tuple[float, float, float]] = []
    platform_size: List[Tuple[float, float, float]] = []
    movables: List[MovableBlockSpec] = []
    balls: List[ObjectBallSpec] = []

    for i in range(h_cells):
        for j in range(w_cells):
            struct = structure[i][j]
            if struct.is_robot() and put_spin_near_agent:
                struct = MazeCell.SPIN
            x = j * size_scaling - torso_x
            y = i * size_scaling - torso_y
            if elevated and not struct.is_chasm():
                platform_pos.append((x, y, h))
                platform_size.append((half, half, h))
            if struct.is_block():
                block_pos.append((x, y, h + height_offset))
                block_size.append((half, half, h))
            elif struct.can_move():
                # Geometry of movable blocks: maze_env.py:563-660.
                falling = struct.can_move_z()
                bh, bx = h, x
                if struct.can_spin():
                    bh = h * 0.1
                    bx = x + size_scaling * 0.25
                    shrink = 0.1
                elif falling:
                    shrink = 0.99
                elif struct.is_half_block():
                    shrink = 0.5
                else:
                    shrink = 1.0
                size = half * shrink
                movables.append(
                    MovableBlockSpec(
                        row=i,
                        col=j,
                        pos=(bx, y, bh),
                        size=(size, size, bh),
                        move_x=struct.can_move_x(),
                        move_y=struct.can_move_y(),
                        move_z=struct.can_move_z(),
                        spin=struct.can_spin(),
                        falling=falling,
                        mass=0.001 if falling else 0.0002,
                        z_range=(-height_offset, 0.0),
                        xy_range=size_scaling,
                    )
                )
            elif struct.is_object_ball():
                balls.append(ObjectBallSpec(row=i, col=j, pos=(x, y), size=1.0))

    def arr(v, width):
        return (
            np.asarray(v, dtype=np.float64)
            if v
            else np.zeros((0, width), dtype=np.float64)
        )

    return MazeStructure(
        grid=np.asarray([[int(c) for c in row] for row in structure], dtype=np.int32),
        size_scaling=size_scaling,
        height=maze_height,
        torso_x=torso_x,
        torso_y=torso_y,
        elevated=elevated,
        any_blocks=any_blocks,
        height_offset=height_offset,
        init_positions=init_positions,
        block_pos=arr(block_pos, 3),
        block_size=arr(block_size, 3),
        platform_pos=arr(platform_pos, 3),
        platform_size=arr(platform_size, 3),
        movable_blocks=tuple(movables),
        object_balls=tuple(balls),
    )


def with_ball_size(ms: MazeStructure, ball_size: float) -> MazeStructure:
    """Return a copy with object-ball radii set from the task spec."""
    if not ms.object_balls:
        return ms
    import dataclasses

    balls = tuple(
        dataclasses.replace(b, size=ball_size) for b in ms.object_balls
    )
    return dataclasses.replace(ms, object_balls=balls)
