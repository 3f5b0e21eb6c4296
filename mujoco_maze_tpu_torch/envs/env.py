"""Lockstep maze environment: spec construction + batched reset/step.

Port of ``mujoco_maze_tpu.envs.env`` in float32 for the Point robot
(manual collision) in object-free mazes and in its object worlds —
movable blocks, the Fall worlds' falling block on its platform, and hinge
balls, stepped by the reduced object solve (``ops/object_lanes.py``), or,
for a Point robot without ``USES_POINT_WORLD``, by the quasi-static push
and kick/roll/bounce ball — and in float64 for the Point robot through the
exact mj_step replica (``physics/point_world.py``); for the Ant robot (the rigid-body engine with contacts) in object-free
mazes, in the block worlds and with a free object ball, for any custom
robot on the engine in the same worlds, and for the Swimmer and the Reacher
(closed-form planar dynamics, no contacts) in object-free mazes and in the
block worlds, whose block dofs they never move.  Construction lowers the
grid maze to wall, box, block and goal tables on one device; the step is a
function

    step(state, action) -> StepResult(state', obs, reward, terminated, ...)

over an explicit :class:`EnvState` of batched tensors (``qpos (B, nq)``,
``qvel (B, nv)``, ``t (B,)`` int32).  Randomness comes from an explicit
``torch.Generator``.

Point step order (maze_env.py:448-481): manual robot kinematics → the
objects' RK4 step from the post-teleport robot pose (object worlds) →
smooth residual → the quasi-static push and ball (object worlds without
the solve) → wall-contact ejection → arrow-tip contacts → robot wall
resolution → observation (t already incremented) → task heads; in float64
the replica's RK4 step (the robot, or the robot with its balls and x/y
blocks) replaces everything between the kinematics and the resolution.  The Ant
step is frame_skip RK4 steps of the world model with contacts, then the
observation and the heads, with the inner reward (forward speed minus
control cost) scaled by the task's ``INNER_REWARD_SCALING``; the
Swimmer's and the Reacher's the same with their own dynamics on the robot
dofs.  Observed balls' and then blocks' centers sit after the first three robot
observations, as the reference inserts them (maze_env.py:351-369).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..maze.cells import MazeCell
from ..maze.structure import MazeStructure, analyze_maze, with_ball_size
from ..models.base import Robot
from ..ops import object_lanes, segments
from ..tasks.core import MazeTask, TaskHeads

EPISODE_LIMIT = 1000  # reference max_episode_steps (__init__.py:31)


class EnvState(NamedTuple):
    """Batched dynamic state."""

    qpos: torch.Tensor  # (B, nq) float32, robot dofs then world dofs
    qvel: torch.Tensor  # (B, nv) float32
    t: torch.Tensor     # (B,) int32 — env steps since reset
    goal_pos: Optional[torch.Tensor] = None  # (B, G, 3) when the task
                                             # resamples goals; else None


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, torch.Tensor]


class _BlockRuntime(NamedTuple):
    """Static constants of one movable block (JAX env.py:73-85, the
    fields the port reads)."""

    body_pos: np.ndarray            # (3,) body origin at qpos0
    half: np.ndarray                # (3,) box half extents
    falling: bool                   # a z slide resting on a platform
    qpos_idx: Tuple[int, int, int]  # qpos address of the x, y, z slide, or -1
    xy_lo: np.ndarray               # (2,) travel limits of the center, in
    xy_hi: np.ndarray               # the spec's dtype
    axis_mask: np.ndarray = np.ones(3)  # (3,) 1.0 where the x/y/z slide exists


class _BallRuntime(NamedTuple):
    """One object ball (JAX env.py:88-92): a hinge ball of the Point's
    object worlds, or a free ball of the engine world."""

    body_pos: np.ndarray            # (2,) body origin at qpos0
    size: float                     # radius
    qpos_idx: Tuple[int, ...]       # hinge: the x, y, rot dofs; free: (adr,)
    kind: str = "hinge"             # "hinge" | "free"


def _axis_mask(b) -> np.ndarray:
    """(3,) 1.0 where a movable block has its x, y, z slide (JAX
    env.py:253-262)."""
    return np.asarray([float(b.move_x), float(b.move_y), float(b.move_z)])


class MazeEnvSpec:
    """Static description of one env ID on one device; batched reset/step.

    The port covers, in float32, the Point robot in object-free mazes and
    in its object worlds (blocks, platforms, hinge balls), the Ant in
    object-free mazes, in the worlds with movable blocks and elevated
    platforms and with a free object ball (AntSmallBilliard), and the
    Swimmer and the Reacher in object-free mazes and in the block worlds.
    It is also the extension API's entry point: any custom robot with
    ``USES_WORLD_ENGINE`` and ``build_bodies`` gets the composed engine
    world (robot, movable blocks, free object balls, static maze boxes,
    floor), the reset of its own ``reset_noise`` law and its own
    ``dynamics_step`` (``examples/custom_robot.py``).  On the card a
    custom robot steps through the generic engine kernel in any of these
    worlds, ball worlds included, and the Ant through its own kernel,
    its ball world included.  Everything else raises
    ``NotImplementedError`` naming the ROADMAP queue item that ports it.
    ``device=None`` means CUDA; without a card pass ``device="cpu"``.

    A Point-family robot without ``USES_POINT_WORLD`` keeps the JAX
    package's quasi-static object model in its object worlds: the robot
    disc pushes the blocks along their slides (``_push_blocks``, with the
    pair separation ``_separate_blocks``) and kicks the balls, which roll
    with decay and bounce off the ball-inflated walls (``_step_balls``).
    ``dtype=torch.float64`` is the Point robot's fidelity path: the exact
    mj_step replica of ``physics/point_world.py`` (JAX env.py:1024-1060).
    """

    # the quasi-static ball (JAX env.py:97-100): rolling friction stops it
    # within ~10 steps; velocity gain per unit overlap per step
    BALL_ROLL_DECAY = 0.5
    BALL_KICK_GAIN = 2.0
    ROBOT_GEOM_R = 0.5      # the Point's body sphere (point.xml:22)

    def __init__(
        self,
        robot: Robot,
        maze_task: Type[MazeTask],
        maze_size_scaling: float,
        inner_reward_scaling: float = 1.0,
        maze_height: float = 0.5,
        restitution_coef: float = 0.8,
        task_kwargs: Optional[Dict[str, Any]] = None,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ) -> None:
        fidelity = (dtype == torch.float64 and robot.MANUAL_COLLISION
                    and getattr(robot, "USES_POINT_WORLD", False))
        if dtype != torch.float32 and not fidelity:
            raise NotImplementedError(
                "float64 steps only the Point robot, through the exact "
                "mj_step replica; the Ant, the Swimmer, the Reacher and "
                "custom robots in float64 are not ported yet (ROADMAP queue 1 "
                "item 16)")
        self.robot = robot
        self.device = resolve_device(device)
        self.dtype = dtype
        self.task: MazeTask = maze_task(maze_size_scaling, **(task_kwargs or {}))
        self.inner_reward_scaling = float(inner_reward_scaling)
        self.restitution_coef = float(restitution_coef)

        ms = analyze_maze(
            self.task.create_maze(),
            maze_size_scaling,
            maze_height,
            put_spin_near_agent=self.task.PUT_SPIN_NEAR_AGENT,
        )
        ms = with_ball_size(ms, self.task.OBJECT_BALL_SIZE)
        self.structure: MazeStructure = ms
        if any(b.spin for b in ms.movable_blocks):
            raise NotImplementedError(
                "spin blocks are not ported yet (ROADMAP queue 1 item 11e)")
        if self.task.TOP_DOWN_VIEW or self.task.sample_goals():
            raise NotImplementedError(
                "top-down views and per-episode goal sampling are not ported "
                "yet (ROADMAP queue 1 item 8)")
        if len(ms.init_positions) != 1:
            raise NotImplementedError(
                "mazes with several start cells are not ported yet "
                "(ROADMAP queue 1 item 8)")
        self.heads: TaskHeads = self.task.lower(self.device, dtype)

        self.walls = None
        self.dynamic_model = None
        self.contact_set = None
        self.block_runtimes: Tuple[_BlockRuntime, ...] = ()
        self.ball_runtimes: Tuple[_BallRuntime, ...] = ()
        self.object_world = None
        self.object_spec = None
        self.point_world = None
        self.point_ball_world = None
        self.point_block_world = None
        self._falling_support: tuple = ()
        # the ball-inflated wall soup of the quasi-static ball (JAX
        # env.py:188-191)
        self.objball_walls = self._walls(
            ms.wall_segments(self.task.OBJECT_BALL_SIZE))
        if getattr(robot, "USES_WORLD_ENGINE", False):
            self._build_engine_world()
            self.init_qpos = self.dynamic_model.qpos0.copy()
        else:
            if robot.MANUAL_COLLISION:
                self.walls = self._walls(ms.wall_segments(robot.RADIUS))
            self._build_world_layout()
            self.init_qpos = np.zeros(self.nq, dtype=np.float64)
            self.init_qpos[: robot.nq] = robot.init_qpos(ms.height_offset)
            if fidelity:
                self._build_point_world()
            elif (robot.MANUAL_COLLISION
                  and getattr(robot, "USES_POINT_WORLD", False)):
                # the reduced object solve (JAX env.py:164-187, float32);
                # a Point robot without USES_POINT_WORLD keeps the
                # quasi-static push and the kick/roll/bounce ball
                self.object_world = object_lanes.object_world(ms, robot)
                self.object_spec = object_lanes.spec_from_env(self)
        self.init_qvel = np.zeros(self.nv, dtype=np.float64)
        n_objects = 0
        if self.task.OBSERVE_BALLS:
            n_objects += len(ms.object_balls)
        if self.task.OBSERVE_BLOCKS:
            n_objects += len(ms.movable_blocks)
        self.obs_dim = robot.obs_dim + 3 * n_objects + 1

    def _walls(self, segs: np.ndarray) -> segments.Walls:
        """A wall-segment soup on the spec's device, in its dtype."""
        w = segments.pad_walls(segs, max(len(segs), 1), self.device)
        return w._replace(p1=w.p1.to(self.dtype), p2=w.p2.to(self.dtype))

    def _build_point_world(self) -> None:
        """The float64 fidelity path's worlds (JAX env.py:143-163): the
        exact mj_step replica's constants and wall boxes; the hinge balls
        and the x/y blocks join its coupled solve, while z (falling) blocks
        keep the quasi-static push (``block_world_from_structure`` gives
        None for them)."""
        from ..physics import point_world as pw

        ms, robot = self.structure, self.robot
        self.point_world = (
            pw.params_for_world(
                any_blocks=bool(ms.movable_blocks), dt=robot.timestep,
                torso_z=(0.75 + ms.height_offset) if ms.elevated else 0.0),
            pw.boxes_on(pw.wall_boxes_from_structure(ms, dtype=np.float64),
                        self.device))
        if ms.object_balls and robot.OBJBALL_TYPE == "hinge":
            self.point_ball_world = pw.ball_world_from_structure(
                ms, dtype=np.float64)
        self.point_block_world = pw.block_world_from_structure(
            ms, dtype=np.float64)

    def _build_world_layout(self) -> None:
        """World dofs of a robot without the engine world (JAX
        env.py:225-281): the robot's dofs, then one qpos and one dof per
        slide of each movable block, in x, y, z order, then each hinge
        ball's x, y, rot.  Spin blocks raise before this (ROADMAP item
        11e)."""
        next_idx = self.robot.nq
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        blocks = []
        for b in self.structure.movable_blocks:
            idxs = []
            for present in (b.move_x, b.move_y, b.move_z):
                idxs.append(next_idx if present else -1)
                next_idx += int(present)
            lo, hi = self._block_xy_limits(b)
            blocks.append(_BlockRuntime(
                body_pos=np.asarray(b.pos, np.float64),
                half=np.asarray(b.size, np.float64), falling=b.falling,
                qpos_idx=tuple(idxs), xy_lo=lo.astype(np_dtype),
                xy_hi=hi.astype(np_dtype), axis_mask=_axis_mask(b)))
        self.block_runtimes = tuple(blocks)
        balls = []
        for ob in self.structure.object_balls:
            balls.append(_BallRuntime(
                body_pos=np.asarray(ob.pos, np.float64), size=float(ob.size),
                qpos_idx=(next_idx, next_idx + 1, next_idx + 2)))
            next_idx += 3
        self.ball_runtimes = tuple(balls)
        self.nq = next_idx
        self.nv = next_idx

    def _build_engine_world(self) -> None:
        """Compose robot + movable blocks + free object balls + static maze
        geoms into ONE RigidModel stepped by the engine with contacts (the
        Ant path; JAX env.py:283-541).

        Movable blocks become slide-jointed box bodies whose travel limits
        encode block-vs-wall collision (the falling block's z slide is
        unlimited: its limit is solved coupled with the platform support,
        ``support_qfrc``); object balls become free-jointed spheres that
        meet the robot's spheres in sphere-sphere pairs; BLOCK cells and
        elevated platforms become static
        AABBs; the floor is a plane.  The robot XML's default geom class
        carries over, with the solimp hardening applied when movable
        blocks exist (maze_env.py:108-112)."""
        from ..physics import contact as contact_mod
        from ..physics import engine as engine_mod
        from ..physics.model import (FREE, SLIDE, Body, Geom, Joint,
                                      build_model)

        ms = self.structure
        robot = self.robot
        bodies, actuators = robot.build_bodies(torso_z=0.75 + ms.height_offset)
        geom_default = dict(robot.WORLD_GEOM_DEFAULTS)
        if ms.any_blocks:
            geom_default["solimp"] = (0.995, 0.995, 0.01)
            for b in bodies:
                for g in b.geoms:
                    g.solimp = (0.995, 0.995, 0.01)
        for b in ms.movable_blocks:
            lo, hi = self._block_xy_limits(b)
            joints = []
            if b.move_x:
                joints.append(Joint(SLIDE, axis=(1, 0, 0), name=f"{b.name}_x",
                                    limited=True,
                                    range=(lo[0] - b.pos[0], hi[0] - b.pos[0])))
            if b.move_y:
                joints.append(Joint(SLIDE, axis=(0, 1, 0), name=f"{b.name}_y",
                                    limited=True,
                                    range=(lo[1] - b.pos[1], hi[1] - b.pos[1])))
            if b.move_z:
                joints.append(Joint(SLIDE, axis=(0, 0, 1), name=f"{b.name}_z",
                                    limited=False, range=b.z_range))
            bodies.append(Body(
                name=b.name, parent=-1, pos=b.pos, joints=joints,
                geoms=[Geom(gtype=2, size=b.size, mass=b.mass, contype=1,
                            conaffinity=1, **geom_default)]))
        for ob in ms.object_balls:
            # a free object ball (JAX env.py:376-398, maze_env.py:539-560):
            # its sphere sits ob.size above the body origin, with the
            # reference's fixed solimp
            bodies.append(Body(
                name=ob.name, parent=-1, pos=(ob.pos[0], ob.pos[1], 0.0),
                joints=[Joint(FREE, name=f"{ob.name}_root")],
                geoms=[Geom(gtype=0, size=(ob.size,), pos=(0.0, 0.0, ob.size),
                            contype=1, conaffinity=1,
                            density=geom_default.get("density", 1000.0),
                            friction=geom_default.get("friction",
                                                      (1.0, 0.5, 0.5)),
                            solref=geom_default.get("solref", (0.02, 1.0)),
                            solimp=(0.9, 0.99, 0.001),
                            margin=geom_default.get("margin", 0.0))]))
        statics = [
            Geom(gtype=3, size=(), pos=(0, 0, 0), contype=1, conaffinity=1,
                 friction=geom_default.get("friction", (1.0, 0.5, 0.5)),
                 solref=geom_default.get("solref", (0.02, 1.0)),
                 solimp=geom_default.get("solimp", (0.8, 0.8, 0.01)),
                 margin=geom_default.get("margin", 0.0))
        ]
        for pos, size in zip(ms.block_pos, ms.block_size):
            statics.append(Geom(gtype=2, size=tuple(size), pos=tuple(pos),
                                contype=1, conaffinity=1, **geom_default))
        for pos, size in zip(ms.platform_pos, ms.platform_size):
            statics.append(Geom(gtype=2, size=tuple(size), pos=tuple(pos),
                                contype=1, conaffinity=1, **geom_default))
        model = build_model(bodies, actuators, timestep=robot.timestep,
                            static_geoms=statics)
        self.dynamic_model = engine_mod.prepare(model)
        self.contact_set = contact_mod.build_contact_set(model)
        self.nq = model.nq
        self.nv = model.nv

        # joint addresses by name, and each block's runtime
        qadr, vadr, body_of = {}, {}, {}
        names = [jn.name for b in bodies for jn in b.joints]
        for j, name in enumerate(names):
            qadr[name] = int(model.jnt_qposadr[j])
            vadr[name] = int(model.jnt_dofadr[j])
            body_of[name] = int(model.jnt_body[j])
        self.block_runtimes = tuple(
            _BlockRuntime(
                body_pos=np.asarray(b.pos, np.float64),
                half=np.asarray(b.size, np.float64), falling=b.falling,
                qpos_idx=tuple(qadr.get(f"{b.name}_{a}", -1) for a in "xyz"),
                xy_lo=lo.astype(np.float32), xy_hi=hi.astype(np.float32),
                axis_mask=_axis_mask(b))
            for b in ms.movable_blocks
            for lo, hi in (self._block_xy_limits(b),))
        self.ball_runtimes = tuple(
            _BallRuntime(body_pos=np.asarray(ob.pos, np.float64),
                         size=float(ob.size),
                         qpos_idx=(qadr[f"{ob.name}_root"],), kind="free")
            for ob in ms.object_balls)

        # Falling blocks (JAX env.py:430-469): the support and the z limit
        # are one coupled solve (contact.falling_support_force) against the
        # highest platform top the block's center overlaps, else the floor.
        # The platforms a block can reach within its xy travel are listed
        # as (x, y, half x + block half x, half y + block half y, top).
        falling = []
        for b in ms.movable_blocks:
            if not b.falling:
                continue
            plats = tuple(
                (float(pp[0]), float(pp[1]), float(ps[0] + b.size[0]),
                 float(ps[1] + b.size[1]), float(pp[2] + ps[2]))
                for pp, ps in zip(ms.platform_pos, ms.platform_size)
                if (abs(pp[0] - b.pos[0]) < b.xy_range + b.size[0] + ps[0] + 1e-9
                    and abs(pp[1] - b.pos[1])
                    < b.xy_range + b.size[1] + ps[1] + 1e-9))
            name = f"{b.name}_z"
            falling.append((body_of[name], vadr[name], float(b.size[2]), plats))
        self._falling_support = tuple(falling)

    def _block_xy_limits(self, b) -> Tuple[np.ndarray, np.ndarray]:
        """Static travel limits of a movable block's center per axis (JAX
        env.py:543-593): walk the grid row and column outward from the
        block cell until a BLOCK cell bounds it; falling blocks also keep
        the reference's ±size_scaling slide range (maze_env.py:615-633)."""
        ms = self.structure
        grid = ms.grid
        s = ms.size_scaling
        h_cells, w_cells = grid.shape
        i, j = b.row, b.col
        sx, sy = b.size[0], b.size[1]

        def free(ii, jj):
            return not MazeCell(grid[ii, jj]).is_block()

        jj = j
        while jj + 1 < w_cells and free(i, jj + 1):
            jj += 1
        x_hi = jj * s - ms.torso_x + s * 0.5 - sx
        jj = j
        while jj - 1 >= 0 and free(i, jj - 1):
            jj -= 1
        x_lo = jj * s - ms.torso_x - s * 0.5 + sx
        ii = i
        while ii + 1 < h_cells and free(ii + 1, j):
            ii += 1
        y_hi = ii * s - ms.torso_y + s * 0.5 - sy
        ii = i
        while ii - 1 >= 0 and free(ii - 1, j):
            ii -= 1
        y_lo = ii * s - ms.torso_y - s * 0.5 + sy
        if b.falling:
            x_lo = max(x_lo, b.pos[0] - b.xy_range)
            x_hi = min(x_hi, b.pos[0] + b.xy_range)
            y_lo = max(y_lo, b.pos[1] - b.xy_range)
            y_hi = min(y_hi, b.pos[1] + b.xy_range)
        return (np.array([x_lo, y_lo], dtype=np.float64),
                np.array([x_hi, y_hi], dtype=np.float64))

    def _support_inputs(self, kd, qacc0, Minv, qvel):
        """Per falling block, its z dof and the support solve's inputs
        ``(z, bottom, s, vz, a0, w, tc)`` (JAX env.py:473-491)."""
        tc = max(0.02, 2.0 * float(self.robot.timestep))
        for bodyidx, zdof, half_z, plats in self._falling_support:
            center = kd.fkr.body_pos[bodyidx]
            bpz = float(self.dynamic_model.body_pos[bodyidx][2])
            z = center[:, 2] - bpz
            bottom = bpz + z - half_z
            s = torch.zeros_like(z)
            for px, py, ox, oy, top in plats:
                over = ((torch.abs(center[:, 0] - px) < ox)
                        & (torch.abs(center[:, 1] - py) < oy))
                s = torch.maximum(s, torch.where(over, top, 0.0))
            yield zdof, (z, bottom, s, qvel[:, zdof], qacc0[:, zdof],
                         Minv[:, zdof, zdof] + 1e-12, tc)

    def support_qfrc(self, kd, qacc0: torch.Tensor, Minv: torch.Tensor,
                     qvel: torch.Tensor) -> torch.Tensor:
        """Generalized support force ``(B, nv)`` of the falling blocks (JAX
        env.py:473-491 ``support_qfrc``); zero without them."""
        from ..physics.contact import falling_support_force

        qfrc = torch.zeros_like(qvel)
        for zdof, args in self._support_inputs(kd, qacc0, Minv, qvel):
            qfrc[:, zdof] = qfrc[:, zdof] + falling_support_force(*args)
        return qfrc

    def world_extra_qfrc(self):
        """The constraint forces the engine adds to the joint limits:
        contacts and the falling blocks' support (JAX models/ant.py:201-205),
        as the engine's ``extra_qfrc(kd, qacc0, Minv, qvel)``."""
        from ..physics import contact, engine

        model, cset = self.dynamic_model, self.contact_set
        _, chain_mask, _, _ = engine.get_masks(model)

        def extra(kd, qacc0, Minv, qvel):
            qfrc = contact.contact_qfrc(model, cset, kd, qvel, qacc0, Minv,
                                        chain_mask)
            if self._falling_support:
                qfrc = qfrc + self.support_qfrc(kd, qacc0, Minv, qvel)
            return qfrc

        return extra

    def world_step(self, qpos: torch.Tensor, qvel: torch.Tensor,
                   ctrl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``robot.frame_skip`` RK4 steps of the engine world with its
        contacts and support: the dynamics of every ``USES_WORLD_ENGINE``
        robot."""
        from ..physics import engine

        extra = self.world_extra_qfrc()
        ctrl = ctrl.to(qpos.dtype)
        for _ in range(self.robot.frame_skip):
            qpos, qvel = engine.rk4_step(self.dynamic_model, qpos, qvel, ctrl,
                                         extra_qfrc=extra)
        return qpos, qvel

    def support_cases(self, kd, qacc0: torch.Tensor, Minv: torch.Tensor,
                      qvel: torch.Tensor) -> dict:
        """Per falling block (by body index), which rows its support solve
        takes, ``(B,)`` int (``contact.falling_support_case``)."""
        from ..physics.contact import falling_support_case

        bodies = [f[0] for f in self._falling_support]
        return {b: falling_support_case(*args) for b, (_, args) in zip(
            bodies, self._support_inputs(kd, qacc0, Minv, qvel))}

    def block_center(self, qpos: torch.Tensor, b: _BlockRuntime) -> torch.Tensor:
        """``(B, 3)`` current block body origin (JAX env.py:606-613)."""
        base = torch.as_tensor(b.body_pos, dtype=qpos.dtype, device=qpos.device)
        zero = torch.zeros_like(qpos[:, 0])
        disp = torch.stack([qpos[:, k] if k >= 0 else zero
                            for k in b.qpos_idx], dim=1)
        return base + disp

    def ball_center3(self, qpos: torch.Tensor, b: _BallRuntime) -> torch.Tensor:
        """``(B, 3)`` current ball body origin: the reference's
        ``get_body_com`` (JAX env.py:621-628), a free ball's qpos[adr:adr+3],
        a hinge ball's x, y with z = 0."""
        if b.kind == "free":
            adr = b.qpos_idx[0]
            return qpos[:, adr:adr + 3]
        base = torch.as_tensor(b.body_pos, dtype=qpos.dtype, device=qpos.device)
        xy = base + qpos[:, list(b.qpos_idx[:2])]
        return torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=1)

    def _object_dof_idx(self) -> Tuple[int, ...]:
        """qpos addresses of the object dofs in the reduced solve's order:
        the balls' x, y, rot, then the blocks' x, y, z slides (JAX
        env.py:594-604)."""
        if self.object_world is None:
            return ()
        idx = [i for b in self.ball_runtimes for i in b.qpos_idx]
        idx += [i for b in self.block_runtimes for i in b.qpos_idx if i >= 0]
        return tuple(idx)

    # ------------------------------------------------------------------
    # observation assembly (maze_env.py:351-369)
    # ------------------------------------------------------------------
    def _observe(self, state: EnvState) -> torch.Tensor:
        robot_obs = self.robot.observe(state.qpos, state.qvel)
        extras = []
        if self.task.OBSERVE_BALLS:
            extras += [self.ball_center3(state.qpos, b)
                       for b in self.ball_runtimes]
        if self.task.OBSERVE_BLOCKS:
            extras += [self.block_center(state.qpos, b)
                       for b in self.block_runtimes]
        time = state.t.to(self.dtype) * 0.001
        return torch.cat([robot_obs[:, :3], *extras, robot_obs[:, 3:],
                          time[:, None]], dim=1)

    # ------------------------------------------------------------------
    # batched reset / step
    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator,
              num_envs: int) -> Tuple[EnvState, torch.Tensor]:
        """``num_envs`` fresh episodes drawn from ``generator``."""
        qpos_noise, qvel_noise = self.robot.reset_noise(
            generator, num_envs, self.nq, self.nv)
        qpos0 = torch.as_tensor(self.init_qpos, dtype=self.dtype,
                                device=self.device)
        qpos = qpos0 + qpos_noise
        qvel = torch.as_tensor(self.init_qvel, dtype=self.dtype,
                               device=self.device) + qvel_noise
        if self.robot.ZERO_WORLD_DOFS_ON_RESET and self.nq > self.robot.nq:
            qpos[:, self.robot.nq:] = qpos0[self.robot.nq:]
            qvel[:, self.robot.nv:] = 0.0
        state = EnvState(
            qpos=qpos, qvel=qvel,
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device))
        return state, self._observe(state)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        if self.robot.MANUAL_COLLISION:
            new_state = self._step_manual(state, action)
            obs = self._observe(new_state)
            # the Point robot's inner reward is identically 0 (point.py:61)
            reward = self.heads.reward(obs, new_state.goal_pos)
            info = {}
        else:
            new_state, inner, info = self._step_dynamic(state, action)
            obs = self._observe(new_state)
            reward = (self.inner_reward_scaling * inner
                      + self.heads.reward(obs, new_state.goal_pos))
        terminated = self.heads.termination(obs, new_state.goal_pos)
        truncated = new_state.t >= EPISODE_LIMIT
        info = {**info, "position": new_state.qpos[:, :2]}
        return StepResult(new_state, obs, reward, terminated, truncated, info)

    def _step_dynamic(self, state: EnvState, action: torch.Tensor):
        """Ant, Swimmer and Reacher path (JAX env.py:1139-1157): the robot's
        dynamics (the engine with contacts for the Ant, the closed form for
        the Swimmer and the Reacher), then the inner reward terms
        (ant.py:71-73, swimmer.py:44-47 info parity)."""
        robot = self.robot
        action = action.to(self.dtype)
        qpos, qvel = robot.dynamics_step(self, state.qpos, state.qvel, action)
        forward, ctrl_cost = robot.inner_reward_terms(
            state.qpos[:, :2], qpos[:, :2], action)
        new_state = EnvState(qpos=qpos, qvel=qvel, t=state.t + 1,
                             goal_pos=state.goal_pos)
        info = {"reward_forward": forward, "reward_ctrl": -ctrl_cost}
        inner = robot.FORWARD_REWARD_WEIGHT * forward - ctrl_cost
        return new_state, inner, info

    def _step_manual(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Point path (maze_env.py:450-473): the JAX package's
        ``_step_manual``, its float32 branch or, for a float64 spec, its
        fidelity branch."""
        robot = self.robot
        qpos, qvel = state.qpos, state.qvel
        old_xy = qpos[:, :2]
        # robot kinematics + full-state velocity clip (point.py:44-57)
        qpos, qvel = robot.kinematic_step(qpos, qvel, action.to(self.dtype))
        if self.point_world is not None:
            qpos, qvel = self._step_fidelity(qpos, qvel)
        else:
            qpos, qvel = self._step_fast(qpos, qvel, old_xy)
        # robot wall resolution (maze_env.py:457-464)
        resolved = segments.resolve(self.walls, old_xy, qpos[:, :2],
                                    self.restitution_coef)
        qpos = torch.cat([resolved, qpos[:, 2:]], dim=1)
        return EnvState(qpos=qpos, qvel=qvel, t=state.t + 1,
                        goal_pos=state.goal_pos)

    def _step_fast(self, qpos: torch.Tensor, qvel: torch.Tensor,
                   old_xy: torch.Tensor):
        """The float32 branch (JAX env.py:1062-1123) from the kinematic
        write to the contact responses."""
        robot = self.robot
        if self.object_spec is not None:
            qpos, qvel = self._step_objects(qpos, qvel)
        # closed-form smooth residual of mj_step
        qpos, qvel = robot.residual_step(qpos, qvel)
        # without the object solve: the quasi-static push and ball at the
        # robot's post-move position, blocks first (JAX env.py:1079-1088)
        if self.object_world is None:
            if self.block_runtimes:
                qpos = self._push_blocks(qpos, qpos[:, :2])
            if self.ball_runtimes:
                qpos, qvel = self._step_balls(qpos, qvel, qpos[:, :2])
        # wall-contact ejection at the position mj_step saw (pre manual
        # resolution): the body sphere (0.5) exceeds the manual detector's
        # inflation (0.4), so pressing into a wall overlaps the geoms
        dv = segments.impedance_eject(
            self.walls, qpos[:, :2], qvel[:, :2], robot.WALL_CONTACT_MARGIN,
            robot.CONTACT_LAM, robot.timestep, robot.CONTACT_MU, old=old_xy)
        qvel = torch.cat([qvel[:, :2] + dv, qvel[:, 2:]], dim=1)
        # arrow-box tip contacts, one tip after the other (each tip sees the
        # previous tip's qvel update)
        th = qpos[:, 2]
        ct, st = torch.cos(th), torch.sin(th)
        for tbx, tby in robot.ARROW_TIPS:
            tip = qpos[:, :2] + torch.stack(
                [tbx * ct - tby * st, tbx * st + tby * ct], dim=1)
            dv3 = segments.tip_impedance_eject(
                self.walls, qpos[:, :2], tip, qvel[:, :3], th, robot.RADIUS,
                robot.CONTACT_LAM, robot.timestep, robot.BODY_MASS,
                robot.COUPLE_ARM, robot.SPIN_INERTIA_PRIME, old=old_xy)
            qvel = torch.cat([qvel[:, :3] + dv3, qvel[:, 3:]], dim=1)
        return qpos, qvel

    def _step_fidelity(self, qpos: torch.Tensor, qvel: torch.Tensor):
        """The float64 branch (JAX env.py:1024-1060): one RK4 mj_step of
        the exact replica, over the robot alone or, with hinge balls or
        x/y blocks, over the coupled robot + object world; z blocks then
        take the quasi-static push."""
        from ..physics import point_world as pw

        pwp, pwb = self.point_world
        if (self.point_ball_world is not None
                or self.point_block_world is not None):
            idx = []
            if self.point_ball_world is not None:
                idx += [i for b in self.ball_runtimes for i in b.qpos_idx]
            if self.point_block_world is not None:
                idx += [i for b in self.block_runtimes
                        for i in b.qpos_idx[:2] if i >= 0]
            at = torch.tensor(idx, device=qpos.device)
            qw = torch.cat([qpos[:, :3], qpos[:, idx]], dim=1)
            vw = torch.cat([qvel[:, :3], qvel[:, idx]], dim=1)
            qw, vw = pw.rk4_step_world(pwp, pwb, self.point_ball_world, qw,
                                       vw, self.point_block_world)
            qpos = torch.cat([qw[:, :3], qpos[:, 3:]], dim=1).index_copy(
                1, at, qw[:, 3:])
            qvel = torch.cat([vw[:, :3], qvel[:, 3:]], dim=1).index_copy(
                1, at, vw[:, 3:])
        else:
            q3, v3 = pw.rk4_step(pwp, pwb, qpos[:, :3], qvel[:, :3])
            qpos = torch.cat([q3, qpos[:, 3:]], dim=1)
            qvel = torch.cat([v3, qvel[:, 3:]], dim=1)
            if self.ball_runtimes:
                qpos, qvel = self._step_balls(qpos, qvel, qpos[:, :2])
        if self.block_runtimes and self.point_block_world is None:
            qpos = self._push_blocks(qpos, qpos[:, :2])
        return qpos, qvel

    # ------------------------------------------------------------------
    # the quasi-static object model (JAX env.py:641-851), batched; the
    # plain version of the quasi rows of the CUDA Point kernels
    # (csrc/point_lane.cu point_quasi_*), which repeat these operations in
    # this order
    # ------------------------------------------------------------------
    def _np_dtype(self):
        return np.float64 if self.dtype == torch.float64 else np.float32

    def _c(self, v: float) -> float:
        """``v`` rounded to the spec's dtype, as a Python float (a constant
        that JAX keeps in an array of the spec's dtype)."""
        return float(self._np_dtype()(v))

    def _push_blocks(self, qpos: torch.Tensor,
                     robot_xy: torch.Tensor) -> torch.Tensor:
        """Quasi-static push of near-massless blocks by the robot disc (JAX
        env.py:641-698): the robot disc's overlap with a block's AABB moves
        the block along its slides, clamped to its travel limits (inside
        the AABB along the axis of least exit depth, the first of equal
        ones); then each overlapping block pair is separated
        (:meth:`_separate_blocks`).  qvel is left as it is."""
        r = self.robot.RADIUS if self.robot.RADIUS is not None else 0.5
        x, y = robot_xy[:, 0], robot_xy[:, 1]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        q = list(qpos.unbind(1))
        for b in self.block_runtimes:
            ix, iy = b.qpos_idx[0], b.qpos_idx[1]
            cx = self._c(b.body_pos[0]) + (q[ix] if ix >= 0 else zero)
            cy = self._c(b.body_pos[1]) + (q[iy] if iy >= 0 else zero)
            hx, hy = self._c(b.half[0]), self._c(b.half[1])
            lox, hix = cx - hx, cx + hx
            loy, hiy = cy - hy, cy + hy
            clx = torch.minimum(torch.maximum(x, lox), hix)
            cly = torch.minimum(torch.maximum(y, loy), hiy)
            dx, dy = x - clx, y - cly
            dist = torch.sqrt(dx * dx + dy * dy + 1e-12)
            overlap = r - dist
            far = dist > 1e-6
            nx = torch.where(far, -dx / dist, zero)
            ny = torch.where(far, -dy / dist, zero)
            # inside the AABB: out along the least exit depth (argmin over
            # the four, the first of equal ones)
            pen0, pen1, pen2, pen3 = hix - x, x - lox, hiy - y, y - loy
            use_x = torch.minimum(pen0, pen1) <= torch.minimum(pen2, pen3)
            nix = torch.where(use_x, torch.where(pen0 <= pen1, one, -one), zero)
            niy = torch.where(use_x, zero, torch.where(pen2 <= pen3, one, -one))
            nx = torch.where(far, nx, nix)
            ny = torch.where(far, ny, niy)
            push = torch.where(overlap > 0, overlap, zero)
            for k, (c, n, i) in enumerate(((cx, nx, ix), (cy, ny, iy))):
                if i >= 0:
                    newc = torch.clamp(c + push * n * float(b.axis_mask[k]),
                                       float(b.xy_lo[k]), float(b.xy_hi[k]))
                    q[i] = newc - self._c(b.body_pos[k])
        blocks = self.block_runtimes
        for i in range(len(blocks)):
            for j in range(i + 1, len(blocks)):
                self._separate_blocks(q, blocks[i], blocks[j])
        return torch.stack(q, dim=1)

    def _separate_blocks(self, q: list, bi: _BlockRuntime,
                         bj: _BlockRuntime) -> None:
        """Project two overlapping blocks apart along the axis of least
        penetration, split evenly where both slide on it (JAX
        env.py:700-734); updates the columns ``q`` in place."""
        zero = torch.zeros_like(q[0])

        def center(b):
            return [self._c(b.body_pos[a])
                    + (q[b.qpos_idx[a]] if b.qpos_idx[a] >= 0 else zero)
                    for a in range(2)]

        ci, cj = center(bi), center(bj)
        f = self._np_dtype()
        half = [float(f(bi.half[a]) + f(bj.half[a])) for a in range(2)]
        pen = [half[a] - torch.abs(ci[a] - cj[a]) for a in range(2)]
        overlapping = (pen[0] > 0) & (pen[1] > 0)
        use_x = pen[0] <= pen[1]
        for axis in range(2):
            sel = overlapping & (use_x if axis == 0 else ~use_x)
            d = torch.where(pen[axis] > 0, pen[axis], zero)
            sgn = torch.sign(cj[axis] - ci[axis])
            sgn = torch.where(sgn == 0, 1.0, sgn)
            mi = 1.0 if bi.qpos_idx[axis] >= 0 else 0.0
            mj = 1.0 if bj.qpos_idx[axis] >= 0 else 0.0
            tot = mi + mj
            if tot == 0:
                continue
            for b, c, share, s in ((bi, ci, mi / tot, -1.0),
                                   (bj, cj, mj / tot, 1.0)):
                idx = b.qpos_idx[axis]
                if idx < 0:
                    continue
                move = torch.where(sel, d * share, zero) * sgn
                newc = torch.clamp(c[axis] - move if s < 0 else c[axis] + move,
                                   float(b.xy_lo[axis]), float(b.xy_hi[axis]))
                q[idx] = newc - self._c(b.body_pos[axis])

    def _step_balls(self, qpos: torch.Tensor, qvel: torch.Tensor,
                    robot_xy: torch.Tensor):
        """The kick/roll/bounce ball (JAX env.py:787-851): the robot's body
        sphere overlapping a ball adds ``overlap * KICK`` of velocity away
        from the robot; the ball moves by ``vel * dt``, its velocity decays
        by ``1 - DECAY``, its move is resolved against the ball-inflated
        walls with restitution (the robot's manual resolution), and a
        bounce steers its velocity along the resolved move, scaled by the
        restitution."""
        dt = self.robot.dt
        rest = self.restitution_coef
        x, y = robot_xy[:, 0], robot_xy[:, 1]
        q = list(qpos.unbind(1))
        v = list(qvel.unbind(1))
        for ob in self.ball_runtimes:
            xi, yi = ob.qpos_idx[0], ob.qpos_idx[1]
            bpx, bpy = self._c(ob.body_pos[0]), self._c(ob.body_pos[1])
            bx, by = bpx + q[xi], bpy + q[yi]
            vx, vy = v[xi], v[yi]
            dx, dy = bx - x, by - y
            dist = torch.sqrt(dx * dx + dy * dy + 1e-12)
            overlap = (self.ROBOT_GEOM_R + ob.size) - dist
            hit = overlap > 0.0
            vx = torch.where(hit, vx + dx / dist * overlap * self.BALL_KICK_GAIN,
                             vx)
            vy = torch.where(hit, vy + dy / dist * overlap * self.BALL_KICK_GAIN,
                             vy)
            old = torch.stack([bx, by], dim=1)
            bx = bx + vx * dt
            by = by + vy * dt
            vx = vx * (1.0 - self.BALL_ROLL_DECAY)
            vy = vy * (1.0 - self.BALL_ROLL_DECAY)
            res = segments.resolve(self.objball_walls, old,
                                   torch.stack([bx, by], dim=1), rest)
            rx, ry = res[:, 0], res[:, 1]
            bounced = (torch.abs(rx - bx) > 1e-7) | (torch.abs(ry - by) > 1e-7)
            mx, my = rx - old[:, 0], ry - old[:, 1]
            mnorm = torch.sqrt(mx * mx + my * my + 1e-12)
            speed = torch.sqrt(vx * vx + vy * vy)
            steer = bounced & (mnorm > 1e-6)
            vx = torch.where(steer, mx / mnorm * speed * rest, vx)
            vy = torch.where(steer, my / mnorm * speed * rest, vy)
            q[xi], q[yi] = rx - bpx, ry - bpy
            v[xi], v[yi] = vx, vy
        return torch.stack(q, dim=1), torch.stack(v, dim=1)

    def _step_objects(self, qpos: torch.Tensor, qvel: torch.Tensor):
        """The objects' RK4 step (``object_lanes.object_step_lanes``), from
        the post-teleport, pre-residual robot pose with the clipped
        velocities: what the reference's mj_step saw (JAX env.py:
        1062-1075).  The robot's dofs are left as they are."""
        idx = self._object_dof_idx()
        rq = tuple(qpos[:, k] for k in range(3))
        rv = tuple(qvel[:, k] for k in range(3))
        oq, ov = object_lanes.object_step_lanes(
            self.object_spec, rq, rv, tuple(qpos[:, i] for i in idx),
            tuple(qvel[:, i] for i in idx))
        at = torch.tensor(idx, device=qpos.device)
        return (qpos.index_copy(1, at, torch.stack(oq, dim=1)),
                qvel.index_copy(1, at, torch.stack(ov, dim=1)))

    # ------------------------------------------------------------------
    # spaces / metadata (host side)
    # ------------------------------------------------------------------
    def observation_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Parity with MazeEnv._get_obs_space (maze_env.py:235-246)."""
        high = np.full(self.obs_dim, np.inf, dtype=np.float64)
        low = -high
        r_low, r_high = self.robot.obs_bounds()
        n = len(r_high)
        high[:n] = r_high
        low[:n] = r_low
        xmin, xmax, ymin, ymax = self.structure.xy_limits()
        low[0], high[0], low[1], high[1] = xmin, xmax, ymin, ymax
        return low, high

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.robot.action_bounds()
