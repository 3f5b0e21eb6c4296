"""Numpy oracle for 2-D segment geometry (copy of
``mujoco_maze_tpu.maze.collision``).

This module is the *reference implementation* used by differential tests: the
batched collision ops in :mod:`mujoco_maze_tpu_torch.ops.segments` are
validated against it (the same differential-testing pattern as the reference's
`tests/test_intersect.py:42-84`).

Behavioral parity target: mujoco-maze `maze_env_utils.py:84-206`
(``Line``/``Collision``/``CollisionDetector``), re-expressed with real-valued
vectors instead of complex arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cells import MazeCell


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return a[0] * b[1] - a[1] * b[0]


class Line:
    """A 2-D line segment with the same operations as the reference ``Line``."""

    def __init__(self, p1: Sequence[float], p2: Sequence[float]) -> None:
        self.p1 = np.asarray(p1, dtype=np.float64)
        self.p2 = np.asarray(p2, dtype=np.float64)
        self.v1 = self.p2 - self.p1
        self.norm = float(np.hypot(*self.v1))

    def _intersect(self, other: "Line") -> bool:
        # Sign test: do other's endpoints straddle this segment's carrier line?
        # Parity: maze_env_utils.py:96-99 (conj-product imag == 2-D cross).
        v2 = other.p1 - self.p1
        v3 = other.p2 - self.p1
        return _cross2(self.v1, v2) * _cross2(self.v1, v3) <= 0.0

    def _projection(self, p: np.ndarray) -> np.ndarray:
        nv1 = -self.v1
        scale = float(np.dot(p - self.p1, nv1)) / float(np.dot(nv1, nv1))
        return self.p1 + nv1 * scale

    def reflection(self, p: Sequence[float]) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        return p + 2.0 * (self._projection(p) - p)

    def distance(self, p: Sequence[float]) -> float:
        p = np.asarray(p, dtype=np.float64)
        return float(np.hypot(*(p - self._projection(p))))

    def intersect(self, other: "Line") -> Optional[np.ndarray]:
        if self._intersect(other) and other._intersect(self):
            return self._cross_point(other)
        return None

    def _cross_point(self, other: "Line") -> np.ndarray:
        v2 = other.p2 - other.p1
        v3 = self.p2 - other.p1
        a = _cross2(self.v1, v2)
        b = _cross2(self.v1, v3)
        return other.p1 + b / a * v2

    def __repr__(self) -> str:
        return f"Line(({self.p1[0]}, {self.p1[1]}) -> ({self.p2[0]}, {self.p2[1]}))"


@dataclass
class Collision:
    point: np.ndarray       # intersection of movement segment and wall
    reflection: np.ndarray  # new endpoint mirrored across the wall line

    def rest(self) -> np.ndarray:
        return self.reflection - self.point


# Neighbor scan order matters for wall ordering parity
# (maze_env_utils.py:149: [0,-1], [-1,0], [0,1], [1,0]).
NEIGHBORS: Tuple[Tuple[int, int], ...] = ((0, -1), (-1, 0), (0, 1), (1, 0))


def extract_wall_segments(
    structure: Sequence[Sequence[MazeCell]],
    size_scaling: float,
    torso_x: float,
    torso_y: float,
    radius: float,
) -> np.ndarray:
    """All wall faces a circular robot of ``radius`` can collide with.

    Returns an ``(n, 2, 2)`` float64 array of segments (p1, p2), inflated by
    the robot radius, emitted only for BLOCK faces adjacent to EMPTY/ROBOT
    cells — the same faces, in the same order, as the reference precomputation
    (maze_env_utils.py:168-184).
    """
    h, w = len(structure), len(structure[0])

    def is_empty(i: int, j: int) -> bool:
        if 0 <= i < h and 0 <= j < w:
            return structure[i][j].is_empty()
        return False

    segments: List[Tuple[Tuple[float, float], Tuple[float, float]]] = []
    for i in range(h):
        for j in range(w):
            if not structure[i][j].is_block():
                continue
            y_base = i * size_scaling - torso_y
            x_base = j * size_scaling - torso_x
            offset = size_scaling * 0.5 + radius
            min_y, max_y = y_base - offset, y_base + offset
            min_x, max_x = x_base - offset, x_base + offset
            for dx, dy in NEIGHBORS:
                if not is_empty(i + dy, j + dx):
                    continue
                p1 = (max_x if dx == 1 else min_x, max_y if dy == 1 else min_y)
                p2 = (min_x if dx == -1 else max_x, min_y if dy == -1 else max_y)
                segments.append((p1, p2))
    if not segments:
        return np.zeros((0, 2, 2), dtype=np.float64)
    return np.asarray(segments, dtype=np.float64)


class CollisionDetector:
    """Numpy oracle with the reference's manual-collision semantics."""

    EPS: float = 0.05

    def __init__(
        self,
        structure: Sequence[Sequence[MazeCell]],
        size_scaling: float,
        torso_x: float,
        torso_y: float,
        radius: float,
    ) -> None:
        segs = extract_wall_segments(structure, size_scaling, torso_x, torso_y, radius)
        self.lines = [Line(p1, p2) for p1, p2 in segs]

    def detect(self, old_pos: np.ndarray, new_pos: np.ndarray) -> Optional[Collision]:
        move = Line(old_pos, new_pos)
        if move.norm <= 1e-8:
            return None
        collisions = []
        for line in self.lines:
            intersection = line.intersect(move)
            if intersection is not None:
                reflection = line.reflection(move.p2)
                collisions.append(Collision(intersection, reflection))
        if not collisions:
            return None
        col = collisions[0]
        dist = float(np.hypot(*(col.point - move.p1)))
        for collision in collisions[1:]:
            new_dist = float(np.hypot(*(collision.point - move.p1)))
            if new_dist < dist:
                col, dist = collision, new_dist
        return col

    def resolve(
        self, old_pos: np.ndarray, new_pos: np.ndarray, restitution: float
    ) -> np.ndarray:
        """Full manual-collision resolution (maze_env.py:457-464 semantics)."""
        collision = self.detect(old_pos, new_pos)
        if collision is None:
            return np.asarray(new_pos, dtype=np.float64)
        pos = collision.point + restitution * collision.rest()
        if self.detect(old_pos, pos) is not None:
            return np.asarray(old_pos, dtype=np.float64)
        return pos
