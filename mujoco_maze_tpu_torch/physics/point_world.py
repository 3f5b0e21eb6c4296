"""Static object worlds of the Point robot: the data builders of
``mujoco_maze_tpu.physics.point_world`` (numpy only).

The Point object worlds (Push, Fall, BlockMaze, BlockCarry, Billiard)
step their movable blocks and hinge balls with the reduced object solve
(``ops/object_lanes.py``).  That solve reads the tables built here:

* :class:`PointWorldParams`: the robot's contact geometry and the contact
  constants of the world (``params_for_world``);
* :class:`WallBoxes`: the static boxes (BLOCK cells and elevated
  platforms);
* :class:`BallWorld` and :class:`BlockWorld`: the hinge balls and the
  movable blocks (falling blocks with their z slide and joint limits).

Copied, not imported, because importing any ``mujoco_maze_tpu`` module
imports JAX.  The port runs float32 only, so every array is rounded to
float32 here, as the JAX package rounds them for its float32 path.  The
JAX package's monolithic solve over these tables (``object_forward``,
``rk4_object_step``) has no twin in the port: ``ops/object_lanes.py`` is
the port's one object solve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

F32 = np.float32


class WallBoxes(NamedTuple):
    """Static wall boxes (the maze's BLOCK cells and platforms), padded to
    at least one row, with a mask of the real ones."""

    c: np.ndarray     # (W, 3) float32 centers
    h: np.ndarray     # (W, 3) float32 half extents
    mask: np.ndarray  # (W,) float32, 1.0 for real walls


@dataclasses.dataclass(frozen=True)
class PointWorldParams:
    """Constants derived from the Point model (point.xml, density 100) and
    the world builder's contact defaults (maze_env.py:102-112): sphere
    r = 0.5 at z = 0.5, arrow box half (0.5, 0.1, 0.1) at body offset
    (0.6, 0, 0.5), slide friction mu = 1, solimp the element-wise mean of
    the two geoms' (hardened to (.995, .995, .01) when movable blocks
    exist)."""

    dt: float = 0.02
    m_sphere: float = 100.0 * (4.0 / 3.0) * math.pi * 0.125
    m_box: float = 4.0
    arm: float = 4.0 * 0.6                    # a = m_box * offset
    inertia: float = (0.4 * 100.0 * (4.0 / 3.0) * math.pi * 0.125 * 0.25
                      + 4.0 * (1.0 + 0.04) / 12.0 + 4.0 * 0.36)
    sphere_r: float = 0.5
    sphere_z: float = 0.5
    arrow_off: float = 0.6
    arrow_half_l: float = 0.5
    arrow_half_w: float = 0.1
    arrow_z_lo: float = 0.4
    arrow_z_hi: float = 0.6
    mu: float = 1.0
    zeta: float = 1.0                          # solref dampratio
    tc: float = 0.04                           # max(solref_tc=0.02, 2*dt)
    dmin: float = 0.9
    dmax: float = 0.97
    width: float = 0.001
    f_dmin: float = 0.9
    f_dmax: float = 0.97
    f_width: float = 0.001

    @property
    def m(self) -> float:
        return self.m_sphere + self.m_box

    @property
    def invw_t(self) -> float:
        """MuJoCo ``body_invweight0`` (translational) of the robot body: the
        mean diagonal of the com-point translational inverse inertia at
        qpos0 (the z row is 0)."""
        m, a, i = self.m, self.arm, self.inertia
        det = m * i - a * a
        r = a / m
        a_yy = i / det - 2.0 * r * a / det + r * r * m / det
        return (1.0 / m + a_yy) / 3.0


def params_for_world(any_blocks: bool, dt: float = 0.02,
                     torso_z: float = 0.0) -> PointWorldParams:
    """Contact constants of a Point world (maze_env.py:108-112 hardening).

    ``torso_z``: the torso body's z offset, 0.75 + height_offset in
    elevated worlds (maze_env.py:105-107), 0 otherwise; the robot geoms
    ride the torso, so their contact heights shift with it."""
    kw = dict(dt=dt, sphere_z=0.5 + torso_z, arrow_z_lo=0.4 + torso_z,
              arrow_z_hi=0.6 + torso_z)
    if not any_blocks:
        return PointWorldParams(**kw)
    # default class solimp -> (.995, .995, .01); robot geoms keep (.9, .99)
    return PointWorldParams(
        dmin=(0.9 + 0.995) / 2, dmax=(0.99 + 0.995) / 2,
        width=(0.001 + 0.01) / 2,
        f_dmin=(0.9 + 0.995) / 2, f_dmax=(0.99 + 0.995) / 2,
        f_width=(0.001 + 0.01) / 2,
        **kw,
    )


def wall_boxes_from_structure(ms) -> WallBoxes:
    """Static wall boxes of a maze (BLOCK cells, then elevated platforms)."""
    pos = np.concatenate([np.asarray(ms.block_pos).reshape(-1, 3),
                          np.asarray(ms.platform_pos).reshape(-1, 3)], 0)
    half = np.concatenate([np.asarray(ms.block_size).reshape(-1, 3),
                           np.asarray(ms.platform_size).reshape(-1, 3)], 0)
    n = max(len(pos), 1)
    c = np.zeros((n, 3))
    h = np.ones((n, 3)) * -1.0
    mask = np.zeros((n,))
    if len(pos):
        c[: len(pos)] = pos
        h[: len(pos)] = half
        mask[: len(pos)] = 1.0
    return WallBoxes(c=c.astype(F32), h=h.astype(F32), mask=mask.astype(F32))


class BallWorld(NamedTuple):
    """The hinge-type object balls (maze_env.py:489-536): per ball a body
    at ``body_pos`` with slide-x/slide-y/hinge-z joints and a sphere geom
    of radius ``r`` at (0, 0, r), mass 1e-4 r^3."""

    r: np.ndarray         # (nb,) float32 radii
    mass: np.ndarray      # (nb,)
    inertia: np.ndarray   # (nb,) spin inertia about the hinge (2/5 m r^2)
    body_pos: np.ndarray  # (nb, 2) body origins (cell centers)

    @property
    def nb(self) -> int:
        return self.r.shape[0]


def ball_world_from_structure(ms) -> BallWorld:
    pos = np.asarray([ob.pos for ob in ms.object_balls], np.float64)
    r = np.asarray([ob.size for ob in ms.object_balls], np.float64)
    mass = 1e-4 * r ** 3
    return BallWorld(r=r.astype(F32), mass=mass.astype(F32),
                     inertia=(0.4 * mass * r * r).astype(F32),
                     body_pos=pos.reshape(-1, 2).astype(F32))


class BlockWorld(NamedTuple):
    """The movable blocks (maze_env.py:563-648): axis-aligned boxes on
    slide joints, mass 2e-4 (push blocks, unlimited x/y slides) or 1e-3
    (falling blocks: limited x/y slides of +-size_scaling and a z slide
    limited to (-height_offset, 0), in ``lim``)."""

    half: np.ndarray          # (nb, 3) float32 half extents
    mass: np.ndarray          # (nb,)
    body_pos: np.ndarray      # (nb, 3) body origins
    has_x: Tuple[bool, ...]
    has_y: Tuple[bool, ...]
    has_z: Tuple[bool, ...]
    # per block None, or ((xlo, xhi) | None, (ylo, yhi) | None,
    # (zlo, zhi) | None) joint-coordinate limits
    lim: Tuple

    @property
    def nb(self) -> int:
        return self.half.shape[0]


def block_world_from_structure(ms) -> Optional[BlockWorld]:
    """The block world of a maze (falling z slides included: the reduced
    solve models them), or None without movable blocks or with a spin
    block."""
    specs = list(ms.movable_blocks)
    if not specs or any(b.spin for b in specs):
        return None
    lims = []
    for b in specs:
        if b.falling:
            lims.append((
                (-float(b.xy_range), float(b.xy_range)) if b.move_x else None,
                (-float(b.xy_range), float(b.xy_range)) if b.move_y else None,
                (float(b.z_range[0]), float(b.z_range[1]))
                if b.move_z else None,
            ))
        else:
            lims.append(None)
    return BlockWorld(
        half=np.asarray([b.size for b in specs], np.float64).reshape(-1, 3).astype(F32),
        mass=np.asarray([b.mass for b in specs], np.float64).astype(F32),
        body_pos=np.asarray([b.pos for b in specs], np.float64).reshape(-1, 3).astype(F32),
        has_x=tuple(bool(b.move_x) for b in specs),
        has_y=tuple(bool(b.move_y) for b in specs),
        has_z=tuple(bool(b.move_z) for b in specs),
        lim=tuple(lims),
    )
