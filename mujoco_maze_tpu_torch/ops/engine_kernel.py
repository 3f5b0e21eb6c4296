"""The generic engine step kernel's data, and its plain PyTorch version.

Counterpart of ``mujoco_maze_tpu/ops/engine_pallas.py``: the step of any
robot composed through the extension API (``Robot.USES_WORLD_ENGINE`` with
``build_bodies``) that has no kernel of its own — frame_skip RK4 steps of
the composed world model with contacts, joint limits, fluid drag and the
falling blocks' support, then the locomotion reward and the task heads.
The JAX package generated its Pallas kernel from the ``RigidModel`` at
trace time (``lane_engine.py``); the CUDA kernel (``csrc/engine_lane.cu``)
reads the model and the world from runtime tables instead, packed into one
float32 buffer by :func:`engine_table`, so one build serves every model
within its compile-time caps:

* ``body (nb, 34)``: parent, first joint, joint count, offset in the
  parent (3), frame in the parent (3x3 row-major), mass, com (3), inertia
  about the com (xx, yy, zz, xy, xz, yz), the bit set of the dofs on the
  body's root path (exact in float32 for nv <= 24), and the fluid model's
  constants: 3 pi d nu, pi d^3 nu, the quadratic force (3) and torque (3)
  coefficients;
* ``jnt (nj, 12)``: type, qpos address, dof address, axis (3), anchor in
  the body (3), limited (a limited hinge or slide), range lo, hi;
* ``dof (nv, 5)``: body, armature, damping, and the first and one-past-last
  dof of its kinematic tree (M is block diagonal over the trees);
* ``act (nu, 4)``: dof, gear, ctrl lo, ctrl hi;
* ``sph (S, 14)``: every test sphere: body, local centre (3), radius,
  margin, margin against the floor, friction, solimp (3), solref time
  constant (clamped to 2 dt), solref damping ratio, and its index among
  the spheres that meet the static world (-1: none);
* ``box (nbox, 7)``: the static boxes, centre (3), half (3), margin;
* ``dbox (D, 7)``: the moving boxes, body, centre in the body (3), half
  (3);
* ``spair (P, 9)``: the sphere-sphere pairs (the JAX ``pair_i``/``pair_j``:
  a robot's sphere and an object ball's, or two unrelated bodies' of one
  robot): sphere i, sphere j, and the pair's mixed constants (JAX
  contact.py:438-441): the margins summed, the larger friction, solimp
  (3) and the solref time constant (clamped) and damping ratio averaged;
* ``pair (Q, 9)``: the sphere-vs-moving-box pairs (the JAX ``qpair_s``/
  ``qpair_b``): sphere, moving box, and the pair's mixed constants (JAX
  contact.py:474-477), in ``spair``'s columns;
* ``fall (F, 6)``: the falling blocks: body, z dof, half height, first
  platform row, platform count, the body's rest height;
* ``plat (P, 5)``: their platforms: x, y, half x + block half x, half y +
  block half y, top (JAX env.py:430-469);
* ``goal (G, 9)``: as for the Point.

The scalars go by value in a POD struct (``lane_env.EngineParams``).

Beside them is the plain version, :func:`engine_step_plain`: frame_skip
``physics/engine.rk4_step`` steps with ``physics/contact.contact_qfrc``
and the env's falling support, the locomotion reward and the heads, batch
first, on any device.  The JAX package's lane form (``lane_engine.py``)
has no twin here: the port's engine equals the JAX engine
(``tests/test_torch_ant_engine.py``), and the tests hold this plain
version against both JAX forms.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..envs.env import EPISODE_LIMIT, MazeEnvSpec
from ..maze.cells import MazeCell
from ..physics import contact, engine
from ..physics.contact import CONTACT_SOLVER_ITERS
from ..physics.model import BALL, FREE, HINGE, SLIDE, _quat_to_mat_np
from .ant_kernel import _ant_pose, _box_dist, _place_blocks, _sphere_offsets
from .point_kernel import Tensors5, goal_table

# "spair" holds the sphere-sphere pairs, "pair" the sphere-vs-moving-box
# pairs (see above)
TABLES = ("body", "jnt", "dof", "act", "sph", "box", "dbox", "spair", "pair",
          "fall", "plat", "goal")
TABLE_COLS = {"body": 34, "jnt": 12, "dof": 5, "act": 4, "sph": 14, "box": 7,
              "dbox": 7, "spair": 9, "pair": 9, "fall": 6, "plat": 5,
              "goal": 9}
# Floats one active contact keeps in the wrapper's scratch: its three rows
# of J over the nv dofs, aref - a0, R and the denominator per row, the
# forces (3) and the friction (kRowFixed in csrc/engine_lane.cu).
ROW_FIXED = 13
_NVJ = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}


def row_floats(nv: int) -> int:
    """Scratch floats of one active contact at ``nv`` dofs."""
    return 3 * nv + ROW_FIXED


class EngineKernelSpec(NamedTuple):
    """Device tables + scalars of one engine world (the fields of the JAX
    ``EngineEnvKernelSpec``; its ``LaneWorld`` is the packed tables)."""

    env_spec: MazeEnvSpec      # the plain version steps through its model
    packed: torch.Tensor       # all tables, float32, on the spec's device
    offsets: dict              # table name -> (offset, rows, cols)
    nq: int
    nv: int
    nu: int
    reward_type: str
    penalty: float
    scale: float
    inner_scale: float
    frame_skip: int
    episode_limit: int
    solver_iters: int
    fwd_weight: float
    ctrl_cost: float
    obs_offset: int
    head_qadr: tuple           # qpos indices of the heads' anchor (-1: none)
    head_base: tuple           # offsets added to the anchor's components
    timestep: float
    dt_outer: float            # float32(timestep * frame_skip)
    n_cand: int                # candidate contacts of a forward evaluation
    n_static: int              # test spheres that meet the static world
    n_limits: int              # limited hinges and slides
    dynamic_goals: bool = False

    def table(self, name: str) -> np.ndarray:
        """One table as a numpy float32 array (rows, cols)."""
        off, rows, cols = self.offsets[name]
        flat = self.packed[off:off + rows * cols].detach().cpu().numpy()
        return flat.reshape(rows, cols)

    @property
    def trace_words(self) -> int:
        """32-bit words of one forward evaluation's trace."""
        return 3 * ((self.n_cand + 31) // 32) + 1


def _trees(model) -> list:
    """Per kinematic tree with dofs, its dof list (engine body order)."""
    root_of = []
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        root_of.append(i if p < 0 else root_of[p])
    trees: dict = {}
    for j in range(model.njnt):
        va = int(model.jnt_dofadr[j])
        trees.setdefault(root_of[int(model.jnt_body[j])], []).extend(
            range(va, va + _NVJ[int(model.jnt_type[j])]))
    return [sorted(d) for d in trees.values()]


def _chain_bits(model) -> list:
    """Per body, the bit set of the dofs on its root path."""
    bits = []
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        b = bits[p] if p >= 0 else 0
        for j in range(model.njnt):
            if int(model.jnt_body[j]) == i:
                va = int(model.jnt_dofadr[j])
                for d in range(va, va + _NVJ[int(model.jnt_type[j])]):
                    b |= 1 << d
        bits.append(b)
    return bits


def _check_model(model) -> None:
    if np.any(model.body_parent >= np.arange(model.nbody)):
        raise NotImplementedError(
            "the generic engine kernel needs parents before children")
    if model.nv > 24:
        raise NotImplementedError(
            f"nv = {model.nv}: the engine tables' dof bit sets hold 24 dofs")
    for dofs in _trees(model):
        if dofs != list(range(dofs[0], dofs[-1] + 1)):
            raise NotImplementedError(
                "the generic engine kernel needs each kinematic tree's dofs "
                "in one contiguous range")
    for j in range(model.njnt):
        jb = [k for k in range(model.njnt)
              if int(model.jnt_body[k]) == int(model.jnt_body[j])]
        if jb != list(range(jb[0], jb[-1] + 1)):
            raise NotImplementedError("a body's joints must be consecutive")


def engine_table(spec: MazeEnvSpec, device) -> Tuple[torch.Tensor, dict]:
    """The packed float32 tables of an engine world on ``device``, and
    each table's ``(offset, rows, cols)``."""
    model, cs = spec.dynamic_model, spec.contact_set
    _check_model(model)
    ts = float(model.timestep)
    tc_min = np.float32(2.0 * ts)
    chain = _chain_bits(model)
    first_jnt = {}
    for j in range(model.njnt):
        first_jnt.setdefault(int(model.jnt_body[j]), j)
    visc, rho = float(model.viscosity), float(model.fluid_density)
    body = np.zeros((model.nbody, TABLE_COLS["body"]))
    for b in range(model.nbody):
        I = model.body_inertia[b]
        nj = int(np.sum(model.jnt_body == b))
        box = 2.0 * np.asarray(model.body_fluid_box[b], np.float64)
        diam = float(np.mean(box))
        fluid = np.zeros(8)
        if model.body_mass[b] > 0:
            if visc > 0:
                fluid[0] = 3.0 * np.pi * diam * visc
                fluid[1] = np.pi * diam ** 3 * visc
            if rho > 0:
                fluid[2:5] = [0.5 * rho * box[(k + 1) % 3] * box[(k + 2) % 3]
                              for k in range(3)]
                fluid[5:8] = [rho * box[k] * (box[(k + 1) % 3] ** 4
                                              + box[(k + 2) % 3] ** 4) / 64.0
                              for k in range(3)]
        body[b] = [model.body_parent[b], first_jnt.get(b, 0), nj,
                   *model.body_pos[b],
                   *_quat_to_mat_np(model.body_quat[b]).reshape(-1),
                   model.body_mass[b], *model.body_com[b],
                   I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2],
                   chain[b], *fluid]
    jnt = np.zeros((model.njnt, TABLE_COLS["jnt"]))
    for j in range(model.njnt):
        jt = int(model.jnt_type[j])
        lim = bool(model.jnt_limited[j]) and jt in (HINGE, SLIDE)
        jnt[j] = [jt, model.jnt_qposadr[j], model.jnt_dofadr[j],
                  *model.jnt_axis[j], *model.jnt_pos[j], float(lim),
                  *model.jnt_range[j]]
    dof = np.zeros((model.nv, TABLE_COLS["dof"]))
    for dofs in _trees(model):
        for d in dofs:
            dof[d, 3:] = [dofs[0], dofs[-1] + 1]
    for j in range(model.njnt):
        va = int(model.jnt_dofadr[j])
        for d in range(va, va + _NVJ[int(model.jnt_type[j])]):
            dof[d, 0] = model.jnt_body[j]
    dof[:, 1] = model.dof_armature
    dof[:, 2] = model.dof_damping
    act = np.stack([model.act_dofadr, model.act_gear,
                    model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]], 1)
    static = np.nonzero(cs.sph_vs_static)[0]
    static_of = np.full(len(cs.sph_body), -1.0)
    static_of[static] = np.arange(len(static))
    sph = np.concatenate([
        cs.sph_body[:, None], cs.sph_local, cs.sph_radius[:, None],
        cs.sph_margin[:, None], (cs.sph_margin + cs.floor_margin)[:, None],
        cs.sph_friction[:, None], cs.sph_solimp,
        np.maximum(cs.sph_solref[:, 0].astype(np.float32), tc_min)[:, None],
        cs.sph_solref[:, 1:2], static_of[:, None]],
        axis=1).reshape(-1, TABLE_COLS["sph"])
    box = np.concatenate([cs.box_center, cs.box_half, cs.box_margin[:, None]],
                         axis=1).reshape(-1, 7)
    dbox = np.concatenate([cs.dbox_body[:, None], cs.dbox_local, cs.dbox_half],
                          axis=1).reshape(-1, 7)
    def mixed(i, j, margin, friction, solimp, solref):
        """A pair table: i, j, then the pair's mixed constants."""
        srf = (solref[0] + solref[1]) / 2
        return np.concatenate([
            i[:, None], j[:, None], (margin[0] + margin[1])[:, None],
            np.maximum(*friction)[:, None], (solimp[0] + solimp[1]) / 2,
            np.maximum(srf[:, 0].astype(np.float32), tc_min)[:, None],
            srf[:, 1:2]], axis=1).reshape(-1, 9)

    pi, pj = cs.pair_i, cs.pair_j
    spair = mixed(pi, pj, (cs.sph_margin[pi], cs.sph_margin[pj]),
                  (cs.sph_friction[pi], cs.sph_friction[pj]),
                  (cs.sph_solimp[pi], cs.sph_solimp[pj]),
                  (cs.sph_solref[pi], cs.sph_solref[pj]))
    qs, qb = cs.qpair_s, cs.qpair_b
    pair = mixed(qs, qb, (cs.sph_margin[qs], cs.dbox_margin[qb]),
                 (cs.sph_friction[qs], cs.dbox_friction[qb]),
                 (cs.sph_solimp[qs], cs.dbox_solimp[qb]),
                 (cs.sph_solref[qs], cs.dbox_solref[qb]))
    fall, plat = [], []
    for bodyidx, zdof, half_z, plats in spec._falling_support:
        fall.append([bodyidx, zdof, half_z, len(plat), len(plats),
                     model.body_pos[bodyidx][2]])
        plat.extend(plats)
    tabs = dict(body=body, jnt=jnt, dof=dof, act=act, sph=sph, box=box,
                dbox=dbox, spair=spair, pair=pair,
                fall=np.asarray(fall, np.float64).reshape(-1, 6),
                plat=np.asarray(plat, np.float64).reshape(-1, 5),
                goal=goal_table(spec).cpu().numpy())
    offsets, parts, off = {}, [], 0
    for name in TABLES:
        a = np.asarray(tabs[name], dtype=np.float32)
        offsets[name] = (off, a.shape[0], TABLE_COLS[name])
        parts.append(a.reshape(-1))
        off += a.size
    return torch.as_tensor(np.concatenate(parts), device=device), offsets


def _head_anchor(spec: MazeEnvSpec):
    """The heads' anchor (JAX engine_pallas.py:78-98): the robot's qpos[:3];
    else the first ball's centre (a free ball's qpos[adr:adr+3], a hinge
    ball's x and y on its rest position at z = 0); else the first block's
    centre (its slides on its rest position)."""
    if spec.task.OBS_OFFSET == 0:
        return (0, 1, 2), (0.0, 0.0, 0.0)
    if spec.ball_runtimes:
        ob = spec.ball_runtimes[0]
        if ob.kind == "free":
            a = ob.qpos_idx[0]
            return (a, a + 1, a + 2), (0.0, 0.0, 0.0)
        return ((ob.qpos_idx[0], ob.qpos_idx[1], -1),
                (float(ob.body_pos[0]), float(ob.body_pos[1]), 0.0))
    if not spec.block_runtimes:
        raise NotImplementedError(
            "the generic engine kernel's heads read the robot, the first "
            "ball or the first block")
    b = spec.block_runtimes[0]
    return tuple(b.qpos_idx[:3]), tuple(float(x) for x in b.body_pos)


def spec_from_env(spec: MazeEnvSpec) -> EngineKernelSpec:
    """Lower an engine-world :class:`MazeEnvSpec` to kernel tables (JAX
    ``engine_pallas.spec_from_env``)."""
    robot = spec.robot
    if not getattr(robot, "USES_WORLD_ENGINE", False):
        raise NotImplementedError(
            f"the generic engine kernel serves engine-world robots, not "
            f"{robot.NAME}")
    cs = spec.contact_set
    if spec.task.sample_goals():
        raise NotImplementedError(
            "per-episode goal sampling (the goal operand) is not ported yet "
            "(ROADMAP queue 1 item 8)")
    head_qadr, head_base = _head_anchor(spec)
    packed, offsets = engine_table(spec, spec.device)
    model = spec.dynamic_model
    task = spec.task
    n_lim = sum(1 for j in range(model.njnt) if model.jnt_limited[j]
                and int(model.jnt_type[j]) in (HINGE, SLIDE))
    return EngineKernelSpec(
        env_spec=spec, packed=packed, offsets=offsets,
        nq=int(model.nq), nv=int(model.nv), nu=int(robot.action_dim),
        reward_type=task.REWARD_TYPE, penalty=float(task.PENALTY or 0.0),
        scale=float(task.scale), inner_scale=float(spec.inner_reward_scaling),
        frame_skip=int(robot.frame_skip), episode_limit=EPISODE_LIMIT,
        solver_iters=CONTACT_SOLVER_ITERS,
        fwd_weight=float(getattr(robot, "FORWARD_REWARD_WEIGHT", 1.0)),
        ctrl_cost=float(getattr(robot, "CTRL_COST_WEIGHT", 0.0)),
        obs_offset=int(task.OBS_OFFSET), head_qadr=head_qadr,
        head_base=head_base, timestep=float(model.timestep),
        dt_outer=float(np.float32(model.timestep * robot.frame_skip)),
        n_cand=contact.candidate_count(cs),
        n_static=int(np.sum(cs.sph_vs_static)), n_limits=n_lim,
    )


# ---------------------------------------------------------------------------
# plain version of the step kernel
# ---------------------------------------------------------------------------
def engine_step_plain(ks: EngineKernelSpec, qpos: torch.Tensor,
                      qvel: torch.Tensor, t: torch.Tensor,
                      actions: torch.Tensor) -> Tensors5:
    """``(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: frame_skip RK4 steps of the engine with contacts and
    the support, the inner reward ``fwd_weight ‖Δxy‖ / dt - ctrl_cost
    ‖a‖²`` on the raw action, ``t + 1``, and the heads at the anchor — what
    the step kernel computes (JAX engine_pallas.py:156-174)."""
    spec = ks.env_spec
    ctrl = actions.to(qpos.dtype)
    q, v = spec.world_step(qpos, qvel, ctrl)
    vel = (q[:, :2] - qpos[:, :2]) / ks.dt_outer
    forward = torch.sqrt(torch.sum(vel * vel, dim=1))
    inner = ks.fwd_weight * forward - ks.ctrl_cost * torch.sum(ctrl * ctrl, dim=1)
    # the heads read (x, y, z) at obs[obs_offset:]: the anchor's
    # coordinates on their rest offsets (0 where the anchor has no dof)
    anchor = torch.stack([(q[:, a] if a >= 0 else torch.zeros_like(q[:, 0]))
                          + base for a, base in zip(ks.head_qadr, ks.head_base)],
                         dim=1)
    obs = torch.cat([anchor.new_zeros(anchor.shape[0], ks.obs_offset), anchor],
                    dim=1)
    reward = ks.inner_scale * inner + spec.heads.reward(obs)
    return q, v, t + 1, reward, spec.heads.termination(obs)


# ---------------------------------------------------------------------------
# the plain version's active sets, laid out as the kernel's trace
# ---------------------------------------------------------------------------
def active_trace(ks: EngineKernelSpec, qpos: torch.Tensor, qvel: torch.Tensor,
                 actions: torch.Tensor) -> torch.Tensor:
    """The plain version's active contacts, joint limits and support rows at
    each forward evaluation of one env step, laid out as the kernel's
    trace (``EngineStep(..., trace=True)``): ``(B, 4 * frame_skip,
    trace_words)`` int32.  Per evaluation, with ``n = ceil(C / 32)`` for
    the ``C`` candidates in ``contact._detect``'s order: n words of active
    bits, n of those whose sphere centre lies inside its box, n of those
    whose tangent frame is built off the x axis (|n_x| < 0.5), then one
    word: bit k for the k-th limited joint whose limit is violated, and the
    support rows of falling block f at bits 24 + 2 f (0 none, 1 the
    platform's, 2 the limit's, 3 both)."""
    spec = ks.env_spec
    model, cs = spec.dynamic_model, spec.contact_set
    _, chain_mask, _, _ = engine.get_masks(model)
    extra = spec.world_extra_qfrc()
    C = engine._consts(model, qpos)
    B, nw = qpos.shape[0], (ks.n_cand + 31) // 32
    bits = torch.arange(ks.n_cand, device=qpos.device)
    out = torch.zeros(B, 4 * ks.frame_skip, ks.trace_words, dtype=torch.int64,
                      device=qpos.device)
    cases = []

    def extra_rec(kd, qacc0, Minv, v):
        word = torch.zeros(B, dtype=torch.int64, device=qpos.device)
        for f, case in enumerate(spec.support_cases(kd, qacc0, Minv, v).values()):
            word = word | (case.to(torch.int64) << (24 + 2 * f))
        cases.append(word)
        return extra(kd, qacc0, Minv, v)

    rnd = np.float32
    h = float(rnd(model.timestep))
    ctrl = actions.to(qpos.dtype)
    ev = 0
    for _ in range(ks.frame_skip):
        zero_v = torch.zeros_like(qvel)
        prev_v, prev_a, acc_v, acc_a = qvel, zero_v, zero_v, zero_v
        for hs, w in ((0.0, 1.0), (h / 2, 2.0), (h / 2, 2.0), (h, 1.0)):
            hs = float(rnd(hs))
            q_s = engine.integrate_pos(model, qpos, prev_v, hs)
            v_s = qvel + prev_a * hs
            if ks.n_cand:
                kd = engine.kin_dyn(model, q_s, v_s)
                dist, _, normal, margin, inside = contact._detect(
                    cs, contact._consts(model, cs, chain_mask, q_s), kd)
                act = dist < margin
                for w0, flag in ((0, act), (nw, act & inside),
                                 (2 * nw, act & (normal[..., 0].abs() < 0.5))):
                    words = torch.zeros(B, nw, dtype=torch.int64,
                                        device=qpos.device)
                    words.index_add_(1, bits // 32,
                                     flag.to(torch.int64) << (bits % 32))
                    out[:, ev, w0:w0 + nw] = words
            qd = q_s[:, C.lim_qadr]
            on = (qd > C.lim_hi) | (qd < C.lim_lo)
            k = torch.arange(on.shape[1], device=qpos.device)
            a_s = engine.forward(model, q_s, v_s, ctrl, extra_rec)
            out[:, ev, -1] = (on.to(torch.int64) << k).sum(dim=1) | cases[-1]
            prev_v, prev_a = v_s, a_s
            acc_v = acc_v + w * v_s
            acc_a = acc_a + w * a_s
            ev += 1
        qpos = engine.integrate_pos(model, qpos, acc_v / 6.0, h)
        qvel = qvel + (acc_a / 6.0) * h
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


# ---------------------------------------------------------------------------
# states for checks and measurement (not on the main path)
# ---------------------------------------------------------------------------
def sphere_robot_states(spec: MazeEnvSpec, num_envs: int, seed: int):
    """``(qpos (B, nq), qvel (B, nv), t (B,))`` numpy states from a seed for
    a robot whose root is a sphere on x, y and z slides (qpos 0-2; the
    Roller of ``examples/custom_robot.py``), for checks of the step
    against the world.

    The movable blocks are drawn as ``ant_kernel.block_states`` draws
    them (at, beyond and between their travel limits; the Fall block
    perched, over the chasm and between).  The sphere rests on the floor
    of a walkable cell (its bottom within ±0.01 of the floor's height) in
    a third of the envs against a block's face, in a third against a wall
    of its cell (between 0.02 short of the face and 0.02 into it), and
    anywhere in the rest.  The robot's other coordinates are its rest pose
    plus U(±0.1) (quaternions renormalised).  qvel ~ N(0, 0.3) on every
    dof; t uniform over the episode."""
    rng = np.random.RandomState(seed)
    ms = spec.structure
    model, cs = spec.dynamic_model, spec.contact_set
    (s0,) = [s for s in range(len(cs.sph_body)) if cs.sph_body[s] == 0][:1]
    r = float(cs.sph_radius[s0])
    radius = np.array([r])
    s, half = ms.size_scaling, ms.size_scaling / 2
    grid = ms.grid
    blocks = spec.block_runtimes
    nq_r = spec.robot.nq

    def walkable(i, j):
        if not (0 <= i < grid.shape[0] and 0 <= j < grid.shape[1]):
            return False
        cell = MazeCell(grid[i, j])
        return not cell.is_block() and not cell.is_chasm()

    def cell_of(x, y):
        return (int(np.floor((y + ms.torso_y) / s + 0.5)),
                int(np.floor((x + ms.torso_x) / s + 0.5)))

    free = [(i, j) for i in range(grid.shape[0]) for j in range(grid.shape[1])
            if walkable(i, j)]
    qpos = np.tile(model.qpos0, (num_envs, 1))
    qpos[:, 3:nq_r] += rng.uniform(-0.1, 0.1, (num_envs, nq_r - 3))
    for j in range(model.njnt):
        a = int(model.jnt_qposadr[j]) + (3 if model.jnt_type[j] == FREE else 0)
        if int(model.jnt_type[j]) in (FREE, BALL) and a < nq_r:
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    rest_z = float(model.body_pos[0][2])
    for e in range(num_envs):
        centers = _place_blocks(spec, qpos[e], rng, e)
        for attempt in range(100):
            mode = e % 3 if attempt < 50 else 2
            if mode == 0 and blocks:
                bi = rng.randint(len(blocks))
                bc, bh = centers[bi], blocks[bi].half
                k = rng.randint(2)
                sign = (-1.0, 1.0)[rng.randint(2)]
                xy = bc[:2] + rng.uniform(-bh[:2], bh[:2])
                xy[k] = bc[k] + sign * (bh[k] + r + rng.uniform(-0.02, 0.02))
            else:
                i, j = free[rng.randint(len(free))]
                cx, cy = j * s - ms.torso_x, i * s - ms.torso_y
                xy = np.array([cx + rng.uniform(-half + r, half - r),
                               cy + rng.uniform(-half + r, half - r)])
                walls = [(di, dj) for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0))
                         if 0 <= i + di < grid.shape[0]
                         and 0 <= j + dj < grid.shape[1]
                         and MazeCell(grid[i + di, j + dj]).is_block()]
                if mode == 1 and walls:
                    di, dj = walls[rng.randint(len(walls))]
                    k, sign = (0, dj) if dj else (1, di)
                    xy[k] = ((cx, cy)[k]
                             + sign * (half - r + rng.uniform(-0.02, 0.02)))
            if not walkable(*cell_of(*xy)):
                continue
            c = np.array([xy[0], xy[1], ms.height_offset + r
                          + rng.uniform(-0.01, 0.01)])
            if len(cs.box_center) and _box_dist(
                    c[None], radius, cs.box_center, cs.box_half).min() < -0.02:
                continue
            if any(_box_dist(c[None], radius, bc, b.half).min() < -0.02
                   for bc, b in zip(centers, blocks)):
                continue
            qpos[e, :3] = [xy[0], xy[1], c[2] - rest_z]
            break
        else:
            raise RuntimeError(f"no placement for env {e} of {num_envs}")
    qvel = rng.normal(0.0, 0.3, (num_envs, model.nv))
    t = rng.randint(0, EPISODE_LIMIT, num_envs)
    return (qpos.astype(np.float32), qvel.astype(np.float32),
            t.astype(np.int32))


def ball_states(spec: MazeEnvSpec, num_envs: int, seed: int):
    """``(qpos (B, nq), qvel (B, nv), t (B,))`` numpy states from a seed for
    an engine world with a free object ball (a SmallBilliard task), for
    checks of the sphere-sphere rows and the ball's free tree.

    The robot is drawn as :func:`sphere_robot_states` draws a robot on
    slides (the Roller); the Ant as ``ant_kernel.contact_states`` draws it
    (its lowest test sphere within ±0.01 of the floor), near the centre of
    a free cell, no test sphere more than 0.02 into a wall.  The first
    ball then rests on the floor (its sphere's bottom within ±0.01 of it;
    the sphere sits off the body origin, so the origin turns with the
    ball's random orientation): in a quarter of the envs against the robot
    (its sphere's centre at the sum of the radii less -0.02 to 0.15, at
    most half the robot sphere's radius, from a robot test sphere's, and
    no other robot sphere more than 0.02 into it), in a quarter against a wall face of
    its cell or in a corner (its sphere between 0.02 short of each face
    and 0.02 into it), in a quarter within half the goal threshold of the
    first goal (terminated), and anywhere in a free cell in the rest;
    never overlapping a static box by more than 0.02.  Its qvel: x, y
    ~ N(0, 1), z ~ N(0, 0.1), spin ~ N(0, 3) about each axis; the robot's
    qvel ~ N(0, 0.3); t uniform over the episode."""
    rng = np.random.RandomState(seed)
    ms = spec.structure
    model, cs = spec.dynamic_model, spec.contact_set
    ob = spec.ball_runtimes[0]
    a = ob.qpos_idx[0]
    ball_body = int(model.jnt_body[[int(x) for x in model.jnt_qposadr].index(a)])
    (s_b,) = [k for k in range(len(cs.sph_body)) if cs.sph_body[k] == ball_body]
    r_b = float(cs.sph_radius[s_b])
    local_b = np.asarray(cs.sph_local[s_b], np.float64)  # off the origin
    # the world's bodies (one a block, one a ball) follow the robot's
    n_robot = (model.nbody - len(spec.block_runtimes)
               - len(spec.ball_runtimes))
    robot_sph = [k for k in range(len(cs.sph_body))
                 if cs.sph_body[k] < n_robot and cs.sph_radius[k] > 0]
    s, half = ms.size_scaling, ms.size_scaling / 2
    grid = ms.grid

    def walkable(i, j):
        return (0 <= i < grid.shape[0] and 0 <= j < grid.shape[1]
                and not MazeCell(grid[i, j]).is_block()
                and not MazeCell(grid[i, j]).is_chasm())

    free = [(i, j) for i in range(grid.shape[0]) for j in range(grid.shape[1])
            if walkable(i, j)]
    if spec.robot.NAME == "Ant":
        qpos = _ant_pose(model, num_envs, rng)
        c = _sphere_offsets(spec, qpos)[:, robot_sph]
        r = cs.sph_radius[robot_sph]
        qpos[:, 2] = (-(c[..., 2] - r).min(axis=1)
                      + rng.uniform(-0.01, 0.01, num_envs))
        for e in range(num_envs):
            for _ in range(100):
                i, j = free[rng.randint(len(free))]
                qpos[e, :2] = [j * s - ms.torso_x + rng.uniform(-0.2, 0.2),
                               i * s - ms.torso_y + rng.uniform(-0.2, 0.2)]
                ce = c[e] + qpos[e, :3]
                if not len(cs.box_center) or _box_dist(
                        ce, r, cs.box_center, cs.box_half).min() >= -0.02:
                    break
            else:
                raise RuntimeError(f"no Ant placement for env {e}")
        qvel = rng.normal(0.0, 0.3, (num_envs, model.nv))
        t = rng.randint(0, EPISODE_LIMIT, num_envs)
    else:
        qpos, qvel, t = sphere_robot_states(spec, num_envs, seed)
        qpos, qvel = qpos.astype(np.float64), qvel.astype(np.float64)
    fkr = engine.fk(model, torch.as_tensor(qpos))
    R = torch.stack(fkr.body_rot, 1).numpy()
    P = torch.stack(fkr.body_pos, 1).numpy()
    sb = cs.sph_body[robot_sph]
    centres = P[:, sb] + np.einsum("bsij,sj->bsi", R[:, sb],
                                   cs.sph_local[robot_sph])
    goal = spec.task.goals[0]
    radius = np.array([r_b])
    for e in range(num_envs):
        for attempt in range(200):
            mode = e % 4 if attempt < 100 else 3
            cz = r_b + rng.uniform(-0.01, 0.01)
            if mode == 0:
                k = rng.randint(len(robot_sph))
                r_k = cs.sph_radius[robot_sph[k]]
                reach = r_k + r_b - rng.uniform(-0.02, min(0.15, r_k / 2))
                dz = centres[e, k, 2] - cz
                if reach <= abs(dz):
                    continue
                ang = rng.uniform(0.0, 2 * np.pi)
                xy = centres[e, k, :2] + np.sqrt(reach ** 2 - dz ** 2) * np.array(
                    [np.cos(ang), np.sin(ang)])
            elif mode == 2:
                ang = rng.uniform(0.0, 2 * np.pi)
                xy = np.asarray(goal.pos[:2]) + rng.uniform(
                    0.0, 0.5 * goal.threshold) * np.array([np.cos(ang), np.sin(ang)])
            else:
                i, j = free[rng.randint(len(free))]
                cx, cy = j * s - ms.torso_x, i * s - ms.torso_y
                xy = np.array([cx + rng.uniform(-half + r_b, half - r_b),
                               cy + rng.uniform(-half + r_b, half - r_b)])
                if mode == 1:
                    walls = [(di, dj) for di, dj in ((0, 1), (0, -1), (1, 0),
                                                     (-1, 0))
                             if not walkable(i + di, j + dj)]
                    if not walls:
                        continue
                    rng.shuffle(walls)
                    for di, dj in walls[:1 + rng.randint(2)]:
                        kk, sign = (0, dj) if dj else (1, di)
                        xy[kk] = ((cx, cy)[kk] + sign
                                  * (half - r_b + rng.uniform(-0.02, 0.02)))
            if not walkable(int(np.floor((xy[1] + ms.torso_y) / s + 0.5)),
                            int(np.floor((xy[0] + ms.torso_x) / s + 0.5))):
                continue
            c = np.array([[xy[0], xy[1], cz]])
            if len(cs.box_center) and _box_dist(
                    c, radius, cs.box_center, cs.box_half).min() < -0.02:
                continue
            gap = (np.linalg.norm(centres[e] - c, axis=1)
                   - cs.sph_radius[robot_sph] - r_b)
            if mode == 0:
                gap[k] = 0.0
            if gap.min() < -0.02:
                continue
            quat = rng.normal(size=4)
            quat /= np.linalg.norm(quat)
            qpos[e, a:a + 3] = c[0] - _quat_to_mat_np(quat) @ local_b
            qpos[e, a + 3:a + 7] = quat
            break
        else:
            raise RuntimeError(f"no ball placement for env {e} of {num_envs}")
    va = int(model.jnt_dofadr[[int(x) for x in model.jnt_qposadr].index(a)])
    qvel[:, va:va + 2] = rng.normal(0.0, 1.0, (num_envs, 2))
    qvel[:, va + 2] = rng.normal(0.0, 0.1, num_envs)
    qvel[:, va + 3:va + 6] = rng.normal(0.0, 3.0, (num_envs, 3))
    return (qpos.astype(np.float32), qvel.astype(np.float32),
            np.asarray(t).astype(np.int32))
