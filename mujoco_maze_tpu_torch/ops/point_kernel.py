"""The Point step and rollout kernels' data, and their plain PyTorch versions.

``spec_from_env`` is the counterpart of ``mujoco_maze_tpu/ops/
point_pallas.py::spec_from_env``.  Where the Pallas kernel baked walls,
goals and objects into the program at trace time, the CUDA kernels
(``csrc/point_lane.cu``, with ``csrc/point_objects.cuh`` in the object
worlds) take them as runtime tables, so one binary serves every Point
maze:

* ``walls (W, 4)`` float32: ``p1x, p1y, p2x, p2y`` of each valid segment;
* ``goals (G, 9)`` float32: ``pos (3), dim_mask (3), threshold², reward
  scale, valid``;
* in the object worlds, ``obj_table`` float32: the reduced object solve's
  wall boxes, balls and blocks with their contact constants, laid out by
  :func:`object_table` (the layout ``csrc/point_objects.cuh`` reads); or,
  for a Point robot without ``USES_POINT_WORLD``, ``quasi_table``: the
  blocks, the ball and the ball-inflated walls of the quasi-static rows
  (:func:`quasi_table`, read by ``quasi_rows`` in ``csrc/point_lane.cu``);
* the scalars, passed by value in POD structs (``lane_env.PointParams``,
  ``lane_env.ObjParams``).

Beside them are the plain versions of both kernels.  ``point_step_plain``
composes the env step as the JAX package's XLA path does
(``models/point.py`` + ``ops/segments.py`` + the task heads).
``point_rollout_plain`` draws the same Philox4x32-10 stream as the rollout
kernel, in int64 torch arithmetic masked to 32 bits, so the two can be
compared on one seed.  The tests run the plain versions; on a card the
main path runs the kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..envs.env import EPISODE_LIMIT, EnvState, MazeEnvSpec
from . import object_lanes as ol
from .philox import philox4x32, philox_words, uniform24  # noqa: F401

Tensors5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]

REWARD_TYPES = {"none": 0, "dist": 1, "goal": 2}


class PointKernelSpec(NamedTuple):
    """Device tables + scalars of one Point maze (names as in the Pallas
    ``PointKernelSpec``)."""

    env_spec: MazeEnvSpec      # the plain versions step through it
    walls: torch.Tensor        # (W, 4) float32 on the spec's device
    goals: torch.Tensor        # (G, 9) float32 on the spec's device
    reward_type: str           # "dist" | "goal" | "none"
    penalty: float
    scale: float
    restitution: float
    com_offset: float          # centrifugal residual arm (models/point.py)
    eject_margin: float
    eject_lam: float           # impedance rate 1/tc_eff
    eject_mu: float            # slide friction
    dt: float
    episode_limit: int
    radius: float              # manual-collision inflation of the segments
    body_mass: float
    couple_arm: float
    spin_inertia: float        # I' = I - a^2/m
    arrow_tips: tuple          # ((tx, ty), (tx, ty)) leading corners
    vel_limit: float
    # object worlds (0, None, () for plain mazes)
    n_world: int = 0           # world dofs after the robot's 3
    object_spec: Optional[ol.ObjectLanesSpec] = None
    object_dof_idx: tuple = () # qpos address of each object dof, solve order
    obj_table: Optional[torch.Tensor] = None   # object_table(), on the device
    obs_offset: int = 0        # 0: heads on the robot; 3: the first object
    # the heads' anchor when obs_offset == 3 (_first_object_pos,
    # point_pallas.py:370): base (3) and the object ordinal added to each
    # component (-1: none)
    head_base: tuple = (0.0, 0.0, 0.0)
    head_dof: tuple = (-1, -1, -1)
    max_rows: int = 0          # R: candidate rows of one forward evaluation
    # object worlds without the object solve (a Point robot without
    # USES_POINT_WORLD): the quasi-static push and kick/roll/bounce ball,
    # laid out by quasi_table() (the layout csrc/point_lane.cu reads; the
    # heads' anchor in its header, through qpos addresses), and its counts
    # of blocks, balls and ball-wall segments
    quasi_table: Optional[torch.Tensor] = None
    quasi_counts: tuple = (0, 0, 0)


def goal_table(spec: MazeEnvSpec) -> torch.Tensor:
    """The goals ``(G, 9)`` float32 as the kernels read them: pos (3),
    dim_mask (3), threshold², reward scale, valid."""
    g = spec.heads.goals
    return torch.cat([
        g.pos, g.dim_mask, (g.threshold * g.threshold)[:, None],
        g.reward_scale[:, None], g.valid.to(torch.float32)[:, None],
    ], dim=1).contiguous()


def spec_from_env(spec: MazeEnvSpec) -> PointKernelSpec:
    """Lower a plain-maze Point :class:`MazeEnvSpec` to kernel tables."""
    robot = spec.robot
    if robot.NAME != "Point" or len(robot.ARROW_TIPS) != 2:
        raise NotImplementedError("the Point kernels take the Point robot only")
    # the rollout kernel draws a reset as noise alone (point_pallas.py:
    # 592-612); that equals spec.reset only for a zero initial state
    if np.any(spec.init_qpos != 0.0) or np.any(spec.init_qvel != 0.0):
        raise ValueError("the Point kernels assume a zero initial state")
    w = spec.walls
    walls = torch.cat([w.p1, w.p2], dim=1)[w.mask].contiguous()
    goals = goal_table(spec)
    task = spec.task
    if spec.dtype != torch.float32:
        raise NotImplementedError(
            "the Point kernels are float32; a float64 spec steps through "
            "MazeEnvSpec.step (the fidelity path)")
    obj = {}
    if spec.object_spec is not None:
        obj = _object_fields(spec)
    elif spec.nq != robot.nq:
        obj = _quasi_fields(spec)
    return PointKernelSpec(
        env_spec=spec,
        walls=walls,
        goals=goals,
        reward_type=task.REWARD_TYPE,
        penalty=float(task.PENALTY or 0.0),
        scale=float(task.scale),
        restitution=float(spec.restitution_coef),
        com_offset=float(robot.COM_OFFSET),
        eject_margin=float(robot.WALL_CONTACT_MARGIN),
        eject_lam=float(robot.CONTACT_LAM),
        eject_mu=float(robot.CONTACT_MU),
        dt=float(robot.timestep),
        episode_limit=EPISODE_LIMIT,
        radius=float(robot.RADIUS),
        body_mass=float(robot.BODY_MASS),
        couple_arm=float(robot.COUPLE_ARM),
        spin_inertia=float(robot.SPIN_INERTIA_PRIME),
        arrow_tips=tuple(tuple(float(c) for c in tip) for tip in robot.ARROW_TIPS),
        vel_limit=float(robot.VELOCITY_LIMITS),
        **obj,
    )


# ---------------------------------------------------------------------------
# the object table of csrc/point_objects.cuh
# ---------------------------------------------------------------------------
# Bounds of the one build (csrc/point_objects.cuh kMax*): the 27 Point
# object worlds have at most 6 object dofs, 3 blocks, 1 ball.
MAX_OBJ_DOFS = 6
MAX_BLOCKS = 3
MAX_BALLS = 1
# Layout, in floats: a header (masses (6, padded with 1), gravity a0 (6),
# each dof's qpos address (6, -1 padding), the heads' base (3) and object
# ordinals (3)); the wall boxes (W x 6: center, half extents); the ball;
# the blocks.  Each contact class is 6 floats (object_lanes.Imp).
HEAD_FLOATS = 24
WALL_FLOATS = 6
BALL_FLOATS = 25      # bx, by, r, dof, r - sphere_z, sphere_r + r,
                      # r - arrow_zc, Imp wall, floor, robot
BLOCK_FIXED = 61      # body (3), half (3), dofs x y z (3), half z + arrow
                      # half z, Imp robot, wall, ball, limit, pair x 3,
                      # limit lo + margin (3), hi - margin (3), limited (3);
                      # then one reach flag per wall


def object_table(ks: ol.ObjectLanesSpec, dof_idx, head_base, head_dof):
    """The float32 table and offsets ``(table, off_walls, off_ball,
    off_blocks, block_stride)`` of an object world."""
    F = ol.F
    W = ks.wb_c.shape[0]
    if (ks.nd > MAX_OBJ_DOFS or len(ks.blocks) > MAX_BLOCKS
            or len(ks.balls) > MAX_BALLS):
        raise NotImplementedError(
            f"{ks.nd} object dofs, {len(ks.blocks)} blocks and "
            f"{len(ks.balls)} balls exceed the Point kernels' bounds")
    pad = MAX_OBJ_DOFS - ks.nd
    head = (list(ks.masses) + [1.0] * pad
            + list(ol.gravity(ks)) + [0.0] * pad
            + list(dof_idx) + [-1] * pad
            + list(head_base) + list(head_dof))
    walls = np.concatenate([ks.wb_c, ks.wb_h], axis=1).reshape(-1)
    ball = []
    for bl in ks.balls:
        imp = ol.ball_imps(ks, bl)
        ball = ([bl.body_pos[0], bl.body_pos[1], bl.r, bl.dof,
                 bl.r - ks.sphere_z, ks.sphere_r + bl.r,
                 bl.r - 0.5 * (ks.arrow_z_lo + ks.arrow_z_hi)]
                + list(imp["wall"]) + list(imp["floor"]) + list(imp["robot"]))
    blocks = []
    margin = np.float32(ol.LIM_MARGIN)
    for bk in ks.blocks:
        imp = ol.block_imps(ks, bk)
        pairs = [c for p in imp["pair"] for c in p]
        pairs += [0.0] * (6 * MAX_BLOCKS - len(pairs))
        ball_imp = list(imp["ball"][0]) if imp["ball"] else [0.0] * 6
        lims = [None] * 3 if bk.lim is None else list(bk.lim)
        lo_m = [float(np.float32(F(lim[0])) + margin) if lim else 0.0
                for lim in lims]
        hi_m = [float(np.float32(F(lim[1])) - margin) if lim else 0.0
                for lim in lims]
        rec = (list(bk.body_pos) + list(bk.half)
               + [bk.dof_x, bk.dof_y, bk.dof_z]
               + [bk.half[2] + 0.5 * (ks.arrow_z_hi - ks.arrow_z_lo)]
               + list(imp["robot"]) + list(imp["wall"]) + ball_imp
               + list(imp["limit"]) + pairs + lo_m + hi_m
               + [1.0 if lim else 0.0 for lim in lims])
        assert len(rec) == BLOCK_FIXED
        blocks += rec + [1.0 if w in bk.wall_idx else 0.0 for w in range(W)]
    off_walls = HEAD_FLOATS
    off_ball = off_walls + WALL_FLOATS * W
    off_blocks = off_ball + len(ball)
    table = np.asarray(head + list(walls) + ball + blocks, dtype=np.float32)
    return table, off_walls, off_ball, off_blocks, BLOCK_FIXED + W


def _object_fields(spec: MazeEnvSpec) -> dict:
    """The object-world fields of :class:`PointKernelSpec`."""
    ks = spec.object_spec
    dof_idx = spec._object_dof_idx()
    if len(dof_idx) != spec.nq - spec.robot.nq:
        raise NotImplementedError("world dofs outside the object solve")
    offset = spec.task.OBS_OFFSET
    base, hdof = (0.0, 0.0, 0.0), (-1, -1, -1)
    if offset == 3:
        # the first observed object: balls precede blocks in the obs
        if spec.task.OBSERVE_BALLS and ks.balls:
            bl = ks.balls[0]
            base = (bl.body_pos[0], bl.body_pos[1], 0.0)
            hdof = (bl.dof, bl.dof + 1, -1)
        else:
            bk = ks.blocks[0]
            base = bk.body_pos
            hdof = (bk.dof_x, bk.dof_y, bk.dof_z)
    table, *_ = object_table(ks, dof_idx, base, hdof)
    return dict(
        n_world=spec.nq - spec.robot.nq, object_spec=ks,
        object_dof_idx=tuple(dof_idx),
        obj_table=torch.as_tensor(table, device=spec.device),
        obs_offset=offset, head_base=tuple(float(b) for b in base),
        head_dof=hdof, max_rows=ol.row_count(ks))


# ---------------------------------------------------------------------------
# the quasi-static table of csrc/point_lane.cu (object worlds without the
# object solve)
# ---------------------------------------------------------------------------
# Bounds of the one build (csrc/point_lane.cu kQuasi*): the 27 Point
# object tasks, with a Point robot without the object solve, have at most
# 3 blocks, 1 ball, 26 ball-inflated wall segments and 9 world dofs.
QUASI_MAX_BLOCKS = 3
QUASI_MAX_BALLS = 1
QUASI_MAX_OBJWALLS = 26
QUASI_MAX_WORLD = 9
# Layout, in floats: a header (the heads' base (3) and qpos addresses (3),
# the push radius, the kick gain, 1 - the roll decay, padding to 16); per
# block 16 (body_pos 3, half 2, axis_mask 2, xy_lo 2, xy_hi 2, qpos
# addresses x y z 3, padding 2); per ball 8 (body_pos 2, robot_geom_r +
# size, qpos addresses x y 2, padding 3); the ball walls 4 each.
QUASI_HEAD = 16
QUASI_BLOCK = 16
QUASI_BALL = 8


def quasi_table(spec: MazeEnvSpec):
    """The float32 table of the quasi-static rows of ``spec``, each
    constant the float32 value the plain version
    (``MazeEnvSpec._push_blocks`` / ``_step_balls``) computes with, and
    its counts ``(blocks, balls, ball-wall segments)``; raises above the
    bounds of the one build."""
    f = np.float32
    blocks, balls = spec.block_runtimes, spec.ball_runtimes
    ow = spec.objball_walls
    walls = torch.cat([ow.p1, ow.p2], dim=1)[ow.mask].cpu().numpy()
    n_world = spec.nq - spec.robot.nq
    if (len(blocks) > QUASI_MAX_BLOCKS or len(balls) > QUASI_MAX_BALLS
            or walls.shape[0] > QUASI_MAX_OBJWALLS
            or n_world > QUASI_MAX_WORLD):
        raise NotImplementedError(
            f"{len(blocks)} blocks, {len(balls)} balls, {walls.shape[0]} "
            f"ball-wall segments and {n_world} world dofs exceed the Point "
            f"kernels' quasi-static bounds ({QUASI_MAX_BLOCKS}, "
            f"{QUASI_MAX_BALLS}, {QUASI_MAX_OBJWALLS}, {QUASI_MAX_WORLD})")
    base, qadr = (0.0, 0.0, 0.0), (-1, -1, -1)
    if spec.task.OBS_OFFSET == 3:
        # the first observed object: balls precede blocks in the obs; a
        # ball's z is 0, a block's its body z plus its z slide
        if spec.task.OBSERVE_BALLS and balls:
            base = (balls[0].body_pos[0], balls[0].body_pos[1], 0.0)
            qadr = (balls[0].qpos_idx[0], balls[0].qpos_idx[1], -1)
        else:
            base, qadr = blocks[0].body_pos, blocks[0].qpos_idx
    head = ([float(f(b)) for b in base] + [float(a) for a in qadr]
            + [float(spec.robot.RADIUS), spec.BALL_KICK_GAIN,
               float(f(1.0) - f(spec.BALL_ROLL_DECAY))])
    head += [0.0] * (QUASI_HEAD - len(head))
    rows = []
    for b in blocks:
        rec = ([float(f(x)) for x in b.body_pos]
               + [float(f(x)) for x in b.half[:2]]
               + [float(x) for x in b.axis_mask[:2]]
               + [float(x) for x in b.xy_lo] + [float(x) for x in b.xy_hi]
               + [float(i) for i in b.qpos_idx])
        rows += rec + [0.0] * (QUASI_BLOCK - len(rec))
    for b in balls:
        rec = ([float(f(x)) for x in b.body_pos]
               + [float(f(spec.ROBOT_GEOM_R + b.size))]
               + [float(i) for i in b.qpos_idx[:2]])
        rows += rec + [0.0] * (QUASI_BALL - len(rec))
    table = np.asarray(head + rows + list(walls.reshape(-1)), dtype=np.float32)
    return table, (len(blocks), len(balls), walls.shape[0])


def _quasi_fields(spec: MazeEnvSpec) -> dict:
    """The quasi-static fields of :class:`PointKernelSpec` (``spec_from_env``
    of ``point_pallas`` with ``object_spec`` None)."""
    table, counts = quasi_table(spec)
    return dict(
        n_world=spec.nq - spec.robot.nq, obs_offset=spec.task.OBS_OFFSET,
        head_base=tuple(float(x) for x in table[:3]),
        quasi_table=torch.as_tensor(table, device=spec.device),
        quasi_counts=counts)


# ---------------------------------------------------------------------------
# plain version of the step kernel
# ---------------------------------------------------------------------------
def point_step_plain(ks: PointKernelSpec, qpos: torch.Tensor,
                     qvel: torch.Tensor, t: torch.Tensor,
                     actions: torch.Tensor) -> Tensors5:
    """``(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one step, no reset — what the step kernel computes."""
    res = ks.env_spec.step(EnvState(qpos=qpos, qvel=qvel, t=t), actions)
    return (res.state.qpos, res.state.qvel, res.state.t, res.reward,
            res.terminated)


# ---------------------------------------------------------------------------
# the rollout kernel's random stream
# ---------------------------------------------------------------------------
def rollout_draws(env_index: torch.Tensor, step: int, seed: int):
    """The eight uniforms an env draws at one rollout step: two actions,
    three qpos and three qvel reset values.  Counter ``(env, step, block,
    0)``, key ``(seed, 0)``, blocks 0 and 1 (four words each)."""
    words = philox_words(env_index, step, seed, range(2))
    act = torch.stack([uniform24(words[0], -1.0, 1.0),
                       uniform24(words[1], -0.25, 0.25)], dim=1)
    q_r = torch.stack([uniform24(w, -0.1, 0.1) for w in words[2:5]], dim=1)
    v_r = torch.stack([uniform24(w, 0.0, 0.1) for w in words[5:8]], dim=1)
    return act, q_r, v_r


def point_rollout_plain(ks: PointKernelSpec, qpos: torch.Tensor,
                        qvel: torch.Tensor, t: torch.Tensor, seed: int,
                        num_steps: int) -> Tensors5:
    """Plain version of the rollout kernel: ``num_steps`` random-policy
    steps with branch-free auto-reset.  Returns the final
    ``(qpos, qvel, t)`` and the per-env reward sums ``(B,)`` float32 and
    episode counts ``(B,)`` int32.  A reset puts the world dofs at 0, at
    rest, with no draws of their own (point_pallas.py:599-612)."""
    env_index = torch.arange(qpos.shape[0], dtype=torch.int64,
                             device=qpos.device)
    rew = torch.zeros(qpos.shape[0], dtype=torch.float32, device=qpos.device)
    eps = torch.zeros(qpos.shape[0], dtype=torch.int32, device=qpos.device)
    world = torch.zeros((qpos.shape[0], ks.n_world), dtype=torch.float32,
                        device=qpos.device)
    for step in range(num_steps):
        act, q_r, v_r = rollout_draws(env_index, step, seed)
        q_r = torch.cat([q_r, world], dim=1)
        v_r = torch.cat([v_r, world], dim=1)
        qpos, qvel, t, reward, term = point_step_plain(ks, qpos, qvel, t, act)
        done = term | (t >= ks.episode_limit)
        qpos = torch.where(done[:, None], q_r, qpos)
        qvel = torch.where(done[:, None], v_r, qvel)
        t = torch.where(done, torch.zeros_like(t), t)
        rew = rew + reward
        eps = eps + done.to(torch.int32)
    return qpos, qvel, t, rew, eps


# ---------------------------------------------------------------------------
# checks of the object worlds: states that touch the objects, and the
# plain version's active rows
# ---------------------------------------------------------------------------
def object_states(spec: MazeEnvSpec, n: int, seed: int):
    """``(qpos, qvel, t)`` numpy arrays of ``n`` states of an object world
    that touch its objects: the robot within reach of a ball or a block
    (in turn), heading at it or across, moving towards it; every fourth
    env's blocks at a travel limit, the others' anywhere in their travel;
    a falling block perched, at the floor or in between; ``t`` spread over
    the episode."""
    rng = np.random.RandomState(seed)
    ks = spec.object_spec
    idx = spec._object_dof_idx()
    qpos = np.zeros((n, spec.nq), np.float32)
    qvel = np.zeros((n, spec.nv), np.float32)
    objs = list(ks.balls) + list(ks.blocks)
    for e in range(n):
        oq = np.zeros(ks.nd)
        for bl in ks.balls:
            oq[bl.dof:bl.dof + 2] = rng.uniform(-0.6, 0.6, 2)
        for bk, rt in zip(ks.blocks, spec.block_runtimes):
            for a, d in enumerate((bk.dof_x, bk.dof_y)):
                if d < 0:
                    continue
                lo = float(rt.xy_lo[a]) - bk.body_pos[a]
                hi = float(rt.xy_hi[a]) - bk.body_pos[a]
                if e % 4 == 3:
                    oq[d] = rng.choice([lo, hi]) + rng.uniform(-0.02, 0.02)
                else:
                    oq[d] = rng.uniform(max(lo, -1.0), min(hi, 1.0))
            if bk.dof_z >= 0:
                zlo = bk.lim[2][0]
                oq[bk.dof_z] = rng.choice([0.0, zlo, rng.uniform(zlo, 0.0)])
        ov = rng.uniform(-0.5, 0.5, ks.nd)
        o = objs[e % len(objs)]
        if isinstance(o, ol.BallL):
            c = np.asarray(o.body_pos) + oq[o.dof:o.dof + 2]
            size = o.r
        else:
            c = np.array([o.body_pos[a] + (oq[d] if d >= 0 else 0.0)
                          for a, d in enumerate((o.dof_x, o.dof_y))])
            size = max(o.half[0], o.half[1])
        ang = rng.uniform(-np.pi, np.pi)
        reach = size + rng.uniform(0.2, 1.4)
        qpos[e, :3] = (c[0] - reach * np.cos(ang), c[1] - reach * np.sin(ang),
                       ang + rng.uniform(-0.5, 0.5))
        speed = rng.uniform(0.3, 2.0)
        qvel[e, :3] = (speed * np.cos(ang), speed * np.sin(ang),
                       rng.uniform(-0.5, 0.5))
        qpos[e, list(idx)] = oq
        qvel[e, list(idx)] = ov
    t = rng.randint(0, EPISODE_LIMIT, n).astype(np.int32)
    return qpos, qvel, t


def object_active_plain(ks: PointKernelSpec, qpos: torch.Tensor,
                        qvel: torch.Tensor, actions: torch.Tensor):
    """The plain version's active candidate rows of one step's four
    forward evaluations, ``(B, 4, R)`` bool: what the step kernel's
    ``trace`` holds as bits."""
    spec = ks.env_spec
    qp, qv = spec.robot.kinematic_step(qpos, qvel, actions)
    idx = list(ks.object_dof_idx)
    active = []
    ol.object_step_lanes(ks.object_spec, tuple(qp[:, k] for k in range(3)),
                         tuple(qv[:, k] for k in range(3)),
                         tuple(qp[:, i] for i in idx),
                         tuple(qv[:, i] for i in idx), active)
    return torch.stack(active, dim=0).permute(2, 0, 1)


def trace_bits(trace: torch.Tensor, rows: int) -> torch.Tensor:
    """The step kernel's trace ``(B, 4, words)`` int32 as ``(B, 4, rows)``
    bool."""
    words = trace.to(torch.int64) & 0xFFFFFFFF
    bits = torch.arange(32, device=trace.device)
    return ((words[..., None] >> bits) & 1).flatten(-2)[..., :rows].bool()


# ---------------------------------------------------------------------------
# checks of the quasi-static rows: states that touch the objects
# ---------------------------------------------------------------------------
def quasi_states(spec: MazeEnvSpec, n: int, seed: int):
    """``(qpos, qvel, t, actions)`` numpy arrays of ``n`` states and
    actions of an object world without the object solve that exercise the
    quasi-static rows, one kind of contact per env in turn: the robot disc
    overlapping a block's face; the robot's centre inside a block, at its
    centre or on a diagonal (equal exit depths: the tie rule) or anywhere;
    a block at or past a travel limit; two blocks overlapping (where there
    are two); the ball overlapping the robot; the ball headed into a wall
    segment, or at one of its ends (a corner: the give-up); ``t`` spread
    over the episode.  The actions hold the robot still (forward gain 0)
    in half the envs, so that the contact survives the kinematic write."""
    rng = np.random.RandomState(seed)
    blocks, balls = spec.block_runtimes, spec.ball_runtimes
    r = float(spec.robot.RADIUS)
    qpos = np.zeros((n, spec.nq), np.float64)
    qvel = np.zeros((n, spec.nv), np.float64)
    ow = spec.objball_walls
    segs = torch.cat([ow.p1, ow.p2], dim=1)[ow.mask].cpu().numpy()
    kinds = []
    for b in range(len(blocks)):
        kinds += [("face", b), ("inside", b), ("limit", b)]
    if len(blocks) > 1:
        kinds += [("pair", 0)]
    for b in range(len(balls)):
        kinds += [("kick", b), ("wall", b), ("corner", b)]

    def center(b, q):
        return np.array([b.body_pos[a] + (q[b.qpos_idx[a]] if b.qpos_idx[a] >= 0
                                          else 0.0) for a in range(2)])

    for e in range(n):
        q, v = qpos[e], qvel[e]
        for b in blocks:
            for a in range(2):
                i = b.qpos_idx[a]
                if i >= 0:
                    lo = float(b.xy_lo[a]) - b.body_pos[a]
                    hi = float(b.xy_hi[a]) - b.body_pos[a]
                    q[i] = rng.uniform(max(lo, -1.0), min(hi, 1.0))
            if b.qpos_idx[2] >= 0:
                q[b.qpos_idx[2]] = rng.uniform(-1.0, 0.0)
        v[3:] = rng.uniform(-1.0, 1.0, spec.nv - 3)
        kind, k = kinds[e % len(kinds)]
        ang = rng.uniform(-np.pi, np.pi)
        if kind in ("face", "inside", "limit"):
            b = blocks[k]
            if kind == "limit":
                for a in range(2):
                    i = b.qpos_idx[a]
                    if i >= 0:
                        lim = float((b.xy_lo, b.xy_hi)[rng.randint(2)][a])
                        q[i] = lim - b.body_pos[a] + rng.choice(
                            [0.0, rng.uniform(-0.05, 0.05)])
            c = center(b, q)
            h = np.asarray(b.half[:2])
            if kind == "inside":
                mode = rng.randint(3)
                if mode == 0:
                    p = c.copy()
                elif mode == 1:
                    s = rng.uniform(0.0, min(h))
                    p = c + s * np.array([rng.choice([-1, 1]),
                                          rng.choice([-1, 1])])
                else:
                    p = c + rng.uniform(-1, 1, 2) * h
            else:
                a = rng.randint(2)
                side = rng.choice([-1.0, 1.0])
                p = c + rng.uniform(-1, 1, 2) * h
                p[a] = c[a] + side * (h[a] + rng.uniform(0.0, r))
            q[:2] = p
        elif kind == "pair":
            i, j = rng.choice(len(blocks), 2, replace=False)
            bi, bj = blocks[i], blocks[j]
            cj = center(bj, q)
            target = cj + rng.uniform(-1, 1, 2) * np.asarray(bj.half[:2])
            for a in range(2):
                if bi.qpos_idx[a] >= 0:
                    q[bi.qpos_idx[a]] = target[a] - bi.body_pos[a]
            ci = center(bi, q)
            q[:2] = ci + rng.uniform(2.5, 4.0) * np.array([np.cos(ang),
                                                           np.sin(ang)])
        else:
            b = balls[k]
            xi, yi = b.qpos_idx[0], b.qpos_idx[1]
            if kind == "kick":
                c = np.asarray(b.body_pos) + rng.uniform(-0.6, 0.6, 2)
                d = rng.uniform(0.0, spec.ROBOT_GEOM_R + b.size)
                q[:2] = c - d * np.array([np.cos(ang), np.sin(ang)])
            else:
                s = segs[rng.randint(len(segs))]
                p1, p2 = s[:2], s[2:]
                w = 0.0 if kind == "corner" else rng.uniform(0.1, 0.9)
                if kind == "corner" and rng.randint(2):
                    w = 1.0
                p = p1 + w * (p2 - p1)
                tang = (p2 - p1) / (np.linalg.norm(p2 - p1) + 1e-12)
                nrm = np.array([-tang[1], tang[0]]) * rng.choice([-1.0, 1.0])
                c = p + nrm * rng.uniform(0.01, 0.15)
                speed = rng.uniform(3.0, 10.0)
                vdir = -nrm + rng.uniform(-0.5, 0.5) * tang
                vdir /= np.linalg.norm(vdir)
                v[xi], v[yi] = speed * vdir
                q[:2] = c + 3.0 * nrm
            q[xi], q[yi] = c[0] - b.body_pos[0], c[1] - b.body_pos[1]
        q[2] = ang
        v[:3] = rng.uniform(-0.5, 0.5, 3)
    t = rng.randint(0, EPISODE_LIMIT, n).astype(np.int32)
    act = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.25, 0.25, n)], 1)
    act[::2, 0] = 0.0
    return (qpos.astype(np.float32), qvel.astype(np.float32), t,
            act.astype(np.float32))
