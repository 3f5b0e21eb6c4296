"""The Ant step and rollout kernels' data, and their plain PyTorch versions.

``spec_from_env`` is the counterpart of ``mujoco_maze_tpu/ops/
ant_pallas.py::spec_from_env`` with ``ant_math.consts_from_model`` and
``ant_math.world_from_spec``, for every Ant maze: object-free, with
movable blocks, or with one free object ball.
Where the Pallas kernel baked the model and the maze into the program at
trace time, the CUDA kernels (``csrc/ant_lane.cuh``) take them as runtime
tables, packed into one float32 buffer, so one build serves every such
Ant maze:

* ``body (13, 20)``: parent, hinge dof (-1: welded), the two hinge dofs on
  the root path (-1 padded), body offset (3), hinge axis (3), mass, com
  (3), inertia about the com (xx, yy, zz, xy, xz, yz);
* ``dof (14, 5)``: the ant's dofs: armature, damping, limited, range lo,
  range hi;
* ``act (8, 4)``: dof, gear, ctrl lo, ctrl hi;
* ``sph (S, 13)``: the test spheres that meet the world: body, local
  centre (3), radius, margin, margin against the floor, friction, solimp
  (3), solref time constant (clamped to 2 dt), solref damping ratio;
* ``box (nbox, 7)``: the static boxes (walls, then platforms), centre
  (3), half (3), margin;
* ``goals (G, 9)``: as for the Point;
* ``qpos0 (nq)``: the reset pose;
* ``wdof (nw, 7)``: the world (slide) dofs after the ant's 14: axis (0-2),
  block mass, 1 / mass, limited, range lo, range hi, and the dof's
  diagonal of M^-1 rounded as the engine's float32 Cholesky rounds it
  (M is diagonal there: ``(1 / r) / r`` with ``r = m / sqrt(m)``);
* ``blk (nblk, 11)``: the movable blocks: base (3), half (3), first dof,
  dof count, falling z dof (-1: none), first platform row, platform
  count;
* ``plat (P, 5)``: the platforms under the falling blocks: x, y, half x
  + block half x, half y + block half y, top (JAX env.py:430-469);
* ``qpair (nblk * S, 7)``: per block and sphere, the pair's mixed
  constants (JAX contact.py:474-477): margin, friction, solimp (3),
  solref time constant (clamped to 2 dt), solref damping ratio;
* ``ball (nball, 16)``: the free object ball (JAX ``ant_math.AntBall``):
  qpos address, dof address, radius, mass, com (3; its sphere's centre in
  the body frame), isotropic inertia about the com, margin, margin against
  the floor, friction, solimp (3), solref time constant (clamped to 2 dt),
  solref damping ratio;
* ``bpair (nball * S, 7)``: per test sphere, its pair with the ball's
  sphere, mixed as ``qpair`` (JAX contact.py:438-441): margins summed,
  friction the max, solimp and solref the mean.

The scalars go by value in a POD struct (``lane_env.AntParams``).

Beside them are the plain versions of both kernels.  ``ant_step_plain``
is the env step through the batched engine (``spec.step``), as the JAX
package's XLA path steps it.  ``ant_rollout_plain`` draws the rollout
kernel's Philox4x32-10 stream and steps through the same engine.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..envs.env import EPISODE_LIMIT, EnvState, MazeEnvSpec
from ..maze.cells import MazeCell
from ..models.ant import AntRobot
from ..physics import contact, engine
from ..physics.contact import CONTACT_SOLVER_ITERS
from ..physics.model import FREE, HINGE, SLIDE, _quat_to_mat_np
from .philox import normal_box_muller, philox_words, uniform24
from .point_kernel import Tensors5, goal_table

# compile-time bounds of csrc/ant_lane.cuh
MAX_SPHERES = 40          # kMaxSph
MAX_BOXES = 128           # 32 x kBoxWords
MAX_WORLD_DOFS = 6        # kBlockWorldDofs
MAX_BLOCKS = 3            # kBlockWorldBlocks
MAX_BALLS = 1             # kBallWorldBalls
NB, NV, NQ, NU = 13, 14, 15, 8   # the ant's bodies, dofs, coordinates, actuators
TABLES = ("body", "dof", "act", "sph", "box", "goals", "qpos0", "wdof", "blk",
          "plat", "qpair", "ball", "bpair")
TABLE_COLS = {"wdof": 7, "blk": 11, "plat": 5, "qpair": 7, "ball": 16,
              "bpair": 7}


class AntKernelSpec(NamedTuple):
    """Device tables + scalars of one Ant maze."""

    env_spec: MazeEnvSpec      # the plain versions step through it
    packed: torch.Tensor       # all tables, float32, on the spec's device
    offsets: dict              # table name -> (offset, rows, cols)
    reward_type: str
    penalty: float
    scale: float
    inner_scale: float
    frame_skip: int
    timestep: float
    dt_outer: float
    gravity: float
    ctrl_weight: float
    episode_limit: int
    solver_iters: int
    reach: float               # torso-to-box distance within which a box
                               # can touch a test sphere (``_reach``)
    n_w: int                   # world (slide) dofs
    n_blk: int                 # movable blocks
    n_ball: int                # free object balls (0 or 1)
    obs_offset: int            # 3: the heads read the first block's center,
                               # or the ball's body origin

    def table(self, name: str) -> np.ndarray:
        """One table as a numpy float32 array (rows, cols)."""
        off, rows, cols = self.offsets[name]
        flat = self.packed[off:off + rows * cols].detach().cpu().numpy()
        return flat.reshape(rows, cols)


def _ball_bodies(model) -> list:
    """The bodies after the ant's 13 on a free joint: object balls."""
    return [int(model.jnt_body[j]) for j in range(1, model.njnt)
            if int(model.jnt_body[j]) >= NB and int(model.jnt_type[j]) == FREE]


def _check_model(model) -> None:
    """The CUDA kernel's topology: the 13-body ant (a free root, then
    bodies welded or on one hinge at their origin, at most two hinges on a
    root path, identity body frames, hinge dof = qpos address - 1),
    followed either by movable blocks: world bodies with identity frames
    on 1-3 slide joints along the coordinate axes, without armature or
    damping, whose dofs follow the ant's; or by one free object ball: a
    world body on one free joint whose 7 coordinates and 6 dofs follow
    the ant's, without armature or damping."""
    balls = _ball_bodies(model)
    if balls and (len(balls) > MAX_BALLS or model.nbody != NB + len(balls)):
        raise NotImplementedError(
            f"the Ant kernels take at most {MAX_BALLS} free object ball, in a "
            "world without movable blocks (no stock ID has a second ball or "
            "a ball beside blocks)")
    n_w = model.nv - NV - 6 * len(balls)
    if (model.nbody < NB or model.nu != NU
            or model.nq - NQ != n_w + 7 * len(balls)
            or not 0 <= n_w <= MAX_WORLD_DOFS
            or model.nbody - NB - len(balls) > MAX_BLOCKS):
        raise NotImplementedError(
            "the Ant kernels take the 13-body ant and at most "
            f"{MAX_BLOCKS} movable blocks with {MAX_WORLD_DOFS} slide dofs")
    if int(model.jnt_type[0]) != FREE or int(model.jnt_body[0]) != 0:
        raise NotImplementedError("the Ant kernels need a free root joint")
    seen = set()
    for j in range(1, model.njnt):
        b = int(model.jnt_body[j])
        if b in balls:
            d = int(model.jnt_dofadr[j])
            if (int(model.body_parent[b]) != -1 or b in seen
                    or d != NV or int(model.jnt_qposadr[j]) != NQ
                    or np.any(model.jnt_pos[j] != 0.0)
                    or np.any(model.dof_armature[d:d + 6] != 0.0)
                    or np.any(model.dof_damping[d:d + 6] != 0.0)):
                raise NotImplementedError(
                    "the Ant kernels take a ball on one free joint after the "
                    "ant's, without armature or damping")
            seen.add(b)
            continue
        if b >= NB:
            axis = np.asarray(model.jnt_axis[j])
            if (int(model.jnt_type[j]) != SLIDE
                    or int(model.body_parent[b]) != -1
                    or sorted(np.abs(axis)) != [0.0, 0.0, 1.0]
                    or np.any(model.jnt_pos[j] != 0.0)
                    or int(model.jnt_dofadr[j]) != NV + len(
                        [k for k in range(1, j)
                         if int(model.jnt_body[k]) >= NB])
                    or int(model.jnt_qposadr[j]) != int(model.jnt_dofadr[j]) + 1
                    or model.dof_armature[model.jnt_dofadr[j]] != 0.0
                    or model.dof_damping[model.jnt_dofadr[j]] != 0.0):
                raise NotImplementedError(
                    "the Ant kernels take blocks on slide joints only (spin "
                    "blocks: ROADMAP queue 1 item 11e)")
            continue
        if (int(model.jnt_type[j]) != HINGE or b in seen
                or np.any(model.jnt_pos[j] != 0.0)
                or int(model.jnt_qposadr[j]) != int(model.jnt_dofadr[j]) + 1):
            raise NotImplementedError(
                "the Ant kernels take one hinge at each body origin")
        seen.add(b)
    if np.any(model.body_quat != np.array([1.0, 0.0, 0.0, 0.0])):
        raise NotImplementedError("the Ant kernels need identity body frames")
    if np.any(model.body_parent[1:NB] >= np.arange(1, NB)):
        raise NotImplementedError("the Ant kernels need parents before children")


def _reach(model, cs, idx: np.ndarray) -> float:
    """A bound on the distance from the torso origin within which a static
    box can meet a test sphere: the farthest any sphere's centre can be
    from the torso origin (its offset plus the body offsets up its chain:
    every joint sits at its body's origin, so rotations keep those
    lengths), plus its radius and margin and the largest box margin, with
    1 cm to spare for float32 rounding.  A box farther than this from the
    torso can neither touch a sphere nor rank above a box that does, so
    the kernel's picks among the boxes within reach are the picks among
    all boxes."""
    reach = 0.0
    for s in idx:
        b = int(cs.sph_body[s])
        arm = float(np.linalg.norm(cs.sph_local[s]))
        while b > 0:
            arm += float(np.linalg.norm(model.body_pos[b]))
            b = int(model.body_parent[b])
        reach = max(reach, arm + float(cs.sph_radius[s] + cs.sph_margin[s]))
    box_margin = float(np.max(cs.box_margin)) if len(cs.box_margin) else 0.0
    return reach + box_margin + 0.01


def _world_tables(spec: MazeEnvSpec, idx: np.ndarray) -> dict:
    """The world-dof, block, platform and pair tables.  Each block body is
    matched to its box, its falling support and its pairs by body index,
    which the env spec resolves by the block's name."""
    model, cs = spec.dynamic_model, spec.contact_set
    support = {bodyidx: (zdof, plats)
               for bodyidx, zdof, _, plats in spec._falling_support}
    balls = _ball_bodies(model)
    wdof = np.zeros((model.nv - NV - 6 * len(balls), TABLE_COLS["wdof"]))
    blk, plat, qpair = [], [], []
    for body in range(NB, model.nbody):
        if body in balls:
            continue
        joints = [j for j in range(model.njnt) if int(model.jnt_body[j]) == body]
        for j in joints:
            d = int(model.jnt_dofadr[j])
            m = np.float32(model.body_mass[body])
            root = m / np.sqrt(m)    # linalg.spd_inverse's pivot column
            wdof[d - NV] = [int(np.argmax(np.abs(model.jnt_axis[j]))),
                            model.body_mass[body], 1.0 / model.body_mass[body],
                            float(model.jnt_limited[j]), *model.jnt_range[j],
                            (np.float32(1.0) / root) / root]
        (k,) = np.nonzero(cs.dbox_body == body)[0]
        if np.any(cs.dbox_local[k] != 0.0):
            raise NotImplementedError("the Ant kernels need a block's box at "
                                      "its body origin")
        zdof, plats = support.get(body, (-1, ()))
        blk.append([*model.body_pos[body], *cs.dbox_half[k],
                    int(model.jnt_dofadr[joints[0]]), len(joints), zdof,
                    len(plat), len(plats)])
        plat.extend(plats)
        for s in idx:
            hit = np.nonzero((cs.qpair_s == s) & (cs.qpair_b == k))[0]
            if len(hit) != 1:
                raise NotImplementedError(
                    "the Ant kernels pair every test sphere with every block")
            sim = (cs.sph_solimp[s] + cs.dbox_solimp[k]) / 2
            srf = (cs.sph_solref[s] + cs.dbox_solref[k]) / 2
            qpair.append([
                cs.sph_margin[s] + cs.dbox_margin[k],
                max(cs.sph_friction[s], cs.dbox_friction[k]), *sim,
                max(np.float32(srf[0]), np.float32(2.0 * model.timestep)),
                srf[1]])
    if len(cs.qpair_s) != len(blk) * len(idx):
        raise NotImplementedError(
            "the Ant kernels take sphere-vs-block pairs of the ant only")

    def table(rows, name):
        return np.asarray(rows, np.float64).reshape(-1, TABLE_COLS[name])

    return dict(wdof=wdof, blk=table(blk, "blk"), plat=table(plat, "plat"),
                qpair=table(qpair, "qpair"))


def _ball_tables(spec: MazeEnvSpec, idx: np.ndarray) -> dict:
    """The ball and sphere-vs-ball pair tables (no rows without a ball).
    The ball's one test sphere sits at its body-frame com and meets the
    static world; every test sphere of the ant meets it in one pair (JAX
    ``ant_math._ball_rows`` :814), and there is no other sphere-sphere
    pair."""
    model, cs = spec.dynamic_model, spec.contact_set
    tc_min = np.float32(2.0 * model.timestep)
    ball, bpair = [], []
    for body in _ball_bodies(model):
        spheres = np.nonzero(cs.sph_body == body)[0]
        (j,) = [j for j in range(model.njnt) if int(model.jnt_body[j]) == body]
        inertia = np.asarray(model.body_inertia[body])
        if (len(spheres) != 1 or not cs.sph_vs_static[spheres[0]]
                or np.any(cs.sph_local[spheres[0]] != model.body_com[body])
                or np.any(inertia != inertia[0, 0] * np.eye(3))):
            raise NotImplementedError(
                "the Ant kernels take a ball of one sphere at its com, with "
                "an isotropic inertia, that meets the static world")
        (b,) = spheres
        ball.append([
            model.jnt_qposadr[j], model.jnt_dofadr[j], cs.sph_radius[b],
            model.body_mass[body], *model.body_com[body], inertia[0, 0],
            cs.sph_margin[b], cs.sph_margin[b] + cs.floor_margin,
            cs.sph_friction[b], *cs.sph_solimp[b],
            max(np.float32(cs.sph_solref[b, 0]), tc_min), cs.sph_solref[b, 1]])
        for s in idx:
            if np.count_nonzero((cs.pair_i == s) & (cs.pair_j == b)) != 1:
                raise NotImplementedError(
                    "the Ant kernels pair every test sphere with the ball")
            sim = (cs.sph_solimp[s] + cs.sph_solimp[b]) / 2
            srf = (cs.sph_solref[s] + cs.sph_solref[b]) / 2
            bpair.append([
                cs.sph_margin[s] + cs.sph_margin[b],
                max(cs.sph_friction[s], cs.sph_friction[b]), *sim,
                max(np.float32(srf[0]), tc_min), srf[1]])
    if len(cs.pair_i) != len(bpair):
        raise NotImplementedError(
            "the Ant kernels take sphere-sphere pairs of the ant's spheres "
            "with the ball only")

    def table(rows, name):
        return np.asarray(rows, np.float64).reshape(-1, TABLE_COLS[name])

    return dict(ball=table(ball, "ball"), bpair=table(bpair, "bpair"))


def _ant_spheres(cs) -> np.ndarray:
    """The test spheres of the ant (bodies 0-12) that meet the world, in
    the contact set's order: the kernels' spheres."""
    return np.nonzero(cs.sph_vs_static & (cs.sph_body < NB))[0]


def _tables(spec: MazeEnvSpec) -> dict:
    model = spec.dynamic_model
    cs = spec.contact_set
    _check_model(model)
    hinge_of = {int(model.jnt_body[j]): j for j in range(1, model.njnt)
                if int(model.jnt_body[j]) < NB}
    body = np.zeros((NB, 20))
    for b in range(NB):
        j = hinge_of.get(b)
        chain = []
        x = b
        while x >= 0:
            if x in hinge_of:
                chain.insert(0, int(model.jnt_dofadr[hinge_of[x]]))
            x = int(model.body_parent[x])
        if len(chain) > 2:
            raise NotImplementedError("the Ant kernels take two hinges a leg")
        chain += [-1] * (2 - len(chain))
        I = model.body_inertia[b]
        body[b] = [
            model.body_parent[b], -1 if j is None else model.jnt_dofadr[j],
            *chain, *model.body_pos[b],
            *(np.zeros(3) if j is None else model.jnt_axis[j]),
            model.body_mass[b], *model.body_com[b],
            I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2],
        ]
    dof = np.zeros((NV, 5))
    dof[:, 0] = model.dof_armature[:NV]
    dof[:, 1] = model.dof_damping[:NV]
    for j in range(1, model.njnt):
        d = int(model.jnt_dofadr[j])
        if d < NV:
            dof[d, 2:] = [float(model.jnt_limited[j]), *model.jnt_range[j]]
    act = np.stack([model.act_dofadr, model.act_gear,
                    model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]], 1)
    if not cs.has_floor or cs.floor_z != 0:
        raise NotImplementedError("the Ant kernels take a floor at z = 0")
    idx = _ant_spheres(cs)
    if len(idx) > MAX_SPHERES:
        raise NotImplementedError(f"the Ant kernels take at most {MAX_SPHERES} "
                                  "test spheres on the ant")
    if len(cs.box_center) > MAX_BOXES:
        raise NotImplementedError(f"{len(cs.box_center)} static boxes > {MAX_BOXES}")
    tc = np.maximum(cs.sph_solref[idx, 0].astype(np.float32),
                    np.float32(2.0 * model.timestep))
    sph = np.concatenate([
        cs.sph_body[idx, None], cs.sph_local[idx], cs.sph_radius[idx, None],
        cs.sph_margin[idx, None],
        (cs.sph_margin[idx] + cs.floor_margin)[:, None],
        cs.sph_friction[idx, None], cs.sph_solimp[idx],
        tc[:, None], cs.sph_solref[idx, 1:2]], axis=1)
    box = np.concatenate([cs.box_center, cs.box_half, cs.box_margin[:, None]],
                         axis=1).reshape(-1, 7)
    return dict(body=body, dof=dof, act=act, sph=sph, box=box,
                goals=goal_table(spec).cpu().numpy(),
                qpos0=np.asarray(model.qpos0)[None],
                **_world_tables(spec, idx), **_ball_tables(spec, idx))


def spec_from_env(spec: MazeEnvSpec) -> AntKernelSpec:
    """Lower an Ant :class:`MazeEnvSpec` to kernel tables."""
    if spec.robot.NAME != "Ant":
        raise NotImplementedError("the Ant kernels take the Ant robot only")
    tabs = _tables(spec)
    offsets, parts, off = {}, [], 0
    for name in TABLES:
        a = np.asarray(tabs[name], dtype=np.float32)
        offsets[name] = (off, a.shape[0], a.shape[1])
        parts.append(a.reshape(-1))
        off += a.size
    packed = torch.as_tensor(np.concatenate(parts), device=spec.device)
    model = spec.dynamic_model
    task = spec.task
    cs = spec.contact_set
    obs_offset = int(task.OBS_OFFSET)
    if obs_offset not in (0, 3) or obs_offset == 3 and not (
            task.OBSERVE_BLOCKS and spec.block_runtimes
            or task.OBSERVE_BALLS and spec.ball_runtimes):
        raise NotImplementedError(
            "the Ant kernels' heads read the torso, the first observed "
            "block or the ball")
    return AntKernelSpec(
        env_spec=spec,
        packed=packed,
        offsets=offsets,
        reward_type=task.REWARD_TYPE,
        penalty=float(task.PENALTY or 0.0),
        scale=float(task.scale),
        inner_scale=float(spec.inner_reward_scaling),
        frame_skip=int(spec.robot.frame_skip),
        timestep=float(model.timestep),
        dt_outer=float(spec.robot.dt),
        gravity=-float(model.gravity[2]),
        ctrl_weight=float(spec.robot.CTRL_COST_WEIGHT),
        episode_limit=EPISODE_LIMIT,
        solver_iters=CONTACT_SOLVER_ITERS,
        reach=_reach(model, cs, _ant_spheres(cs)),
        n_w=int(tabs["wdof"].shape[0]),
        n_blk=int(tabs["blk"].shape[0]),
        n_ball=int(tabs["ball"].shape[0]),
        obs_offset=obs_offset,
    )


# ---------------------------------------------------------------------------
# plain version of the step kernel
# ---------------------------------------------------------------------------
def ant_step_plain(ks: AntKernelSpec, qpos: torch.Tensor, qvel: torch.Tensor,
                   t: torch.Tensor, actions: torch.Tensor) -> Tensors5:
    """``(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one step through the batched engine, no reset — what the
    step kernel computes."""
    res = ks.env_spec.step(EnvState(qpos=qpos, qvel=qvel, t=t), actions)
    return (res.state.qpos, res.state.qvel, res.state.t, res.reward,
            res.terminated)


# ---------------------------------------------------------------------------
# the rollout kernel's draws, and the plain version of the rollout kernel
# ---------------------------------------------------------------------------
def rollout_ctrl(env_index: torch.Tensor, step: int, seed: int) -> torch.Tensor:
    """The actions ``(B, 8)`` an env draws at one rollout step: uniform
    over the ctrl range, U(±30), from words 0-7 (blocks 0 and 1)."""
    words = philox_words(env_index, step, seed, range(2))
    hi = float(AntRobot().action_bounds()[1][0])
    return torch.stack([uniform24(w, -hi, hi) for w in words], dim=1)


def rollout_reset(env_index: torch.Tensor, step: int, seed: int,
                  qpos0: np.ndarray, nv: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reset state an env draws at one rollout step (blocks 2-12,
    words 8-51), the Ant's reset law (models/ant.py): the ant's ``qpos0 +
    U(±0.1)`` with the quaternion renormalised (words 8-22), and its
    ``qvel = 0.1 N(0, 1)`` by Box-Muller (words 23-50); the world's
    coordinates after the ant's (block slides, or a free ball's position
    and quaternion) go back to ``qpos0``, its dofs to rest, and draw
    nothing.  ``nv``: the env's dofs (``len(qpos0) - 1`` where no free
    ball adds a second quaternion)."""
    w = philox_words(env_index, step, seed, range(2, 13))
    lo, hi = AntRobot.QPOS_NOISE
    q = [float(np.float32(qpos0[i])) + uniform24(w[i], lo, hi)
         for i in range(NQ)]
    qn = torch.sqrt(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] + q[6] * q[6])
    for i in range(3, 7):
        q[i] = q[i] / qn
    std = float(np.float32(AntRobot.QVEL_STD))
    v = [normal_box_muller(w[15 + 2 * d], w[16 + 2 * d]) * std
         for d in range(NV)]
    nv = len(qpos0) - 1 if nv is None else nv
    q += [torch.full_like(q[0], float(np.float32(qpos0[i])))
          for i in range(NQ, len(qpos0))]
    v += [torch.zeros_like(v[0]) for _ in range(NV, nv)]
    return torch.stack(q, dim=1), torch.stack(v, dim=1)


def ant_rollout_plain(ks: AntKernelSpec, qpos: torch.Tensor,
                      qvel: torch.Tensor, t: torch.Tensor, seed: int,
                      num_steps: int) -> Tensors5:
    """Plain version of the rollout kernel: ``num_steps`` random-policy
    steps with auto-reset.  Returns the final ``(qpos, qvel, t)`` and the
    per-env reward sums ``(B,)`` float32 and episode counts ``(B,)``
    int32."""
    B = qpos.shape[0]
    env_index = torch.arange(B, dtype=torch.int64, device=qpos.device)
    rew = torch.zeros(B, dtype=torch.float32, device=qpos.device)
    eps = torch.zeros(B, dtype=torch.int32, device=qpos.device)
    qpos0 = ks.env_spec.dynamic_model.qpos0
    nv = ks.env_spec.nv
    for step in range(num_steps):
        act = rollout_ctrl(env_index, step, seed)
        qpos, qvel, t, reward, term = ant_step_plain(ks, qpos, qvel, t, act)
        done = term | (t >= ks.episode_limit)
        q_r, v_r = rollout_reset(env_index, step, seed, qpos0, nv)
        qpos = torch.where(done[:, None], q_r, qpos)
        qvel = torch.where(done[:, None], v_r, qvel)
        t = torch.where(done, torch.zeros_like(t), t)
        rew = rew + reward
        eps = eps + done.to(torch.int32)
    return qpos, qvel, t, rew, eps


# ---------------------------------------------------------------------------
# states for checks and measurement (not on the main path)
# ---------------------------------------------------------------------------
ANKLE_SIGNS = (1.0, -1.0, -1.0, 1.0)   # ankle ranges of legs 1-4 (models/ant.py)


def contact_states(spec: MazeEnvSpec, num_envs: int, seed: int,
                   start_cell_only: bool = False):
    """``(qpos (B, 15), qvel (B, 14), t (B,))`` numpy states from a seed
    that touch the world gently: a small random tilt, hips and ankles
    drawn inside their ranges, the torso at the height where the lowest
    test sphere meets the floor within ±0.01; half the envs placed so that
    their farthest sphere toward a wall of their cell (a face whose
    neighbour is a BLOCK cell) lies between 0.02 short of it and 0.02
    into it, the rest anywhere in a free cell (or in the start cell,
    around the world origin, with ``start_cell_only``); qvel ~ N(0, 0.3)
    and t uniform over the episode."""
    rng = np.random.RandomState(seed)
    ms = spec.structure
    s, half = ms.size_scaling, ms.size_scaling / 2
    grid = ms.grid
    free = [(i, j) for i in range(grid.shape[0]) for j in range(grid.shape[1])
            if grid[i, j] != 1                    # MazeCell.BLOCK
            and (not start_cell_only
                 or (j * s == ms.torso_x and i * s == ms.torso_y))]
    model, cs = spec.dynamic_model, spec.contact_set
    qpos = _ant_pose(model, num_envs, rng)
    c = _sphere_offsets(spec, qpos)
    r = cs.sph_radius
    qpos[:, 2] = -(c[..., 2] - r).min(axis=1) + rng.uniform(-0.01, 0.01, num_envs)
    for e in range(num_envs):
        i, j = free[rng.randint(len(free))]
        cx, cy = j * s - ms.torso_x, i * s - ms.torso_y
        xy = [cx + rng.uniform(-half + 1.0, half - 1.0),
              cy + rng.uniform(-half + 1.0, half - 1.0)]
        walls = [(di, dj) for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0))
                 if 0 <= i + di < grid.shape[0] and 0 <= j + dj < grid.shape[1]
                 and grid[i + di, j + dj] == 1]
        if e % 2 == 0 and walls:
            di, dj = walls[rng.randint(len(walls))]
            k, sign = (0, dj) if dj else (1, di)
            reach = (sign * c[e, :, k] + r).max()
            xy[k] = (cx, cy)[k] + sign * (half - reach + rng.uniform(-0.02, 0.02))
        qpos[e, :2] = xy
    qvel = rng.normal(0.0, 0.3, (num_envs, NV))
    t = rng.randint(0, EPISODE_LIMIT, num_envs)
    return (qpos.astype(np.float32), qvel.astype(np.float32),
            t.astype(np.int32))


def contact_census(ks: AntKernelSpec, qpos: torch.Tensor):
    """Per env, the ant's test spheres within their contact margin of the
    floor and of any static box at ``qpos``: ``(floor (B,), walls (B,))``
    int64."""
    spec = ks.env_spec
    cs = spec.contact_set
    fkr = engine.fk(spec.dynamic_model, qpos)
    idx = _ant_spheres(cs)
    sb = torch.as_tensor(cs.sph_body[idx], dtype=torch.long, device=qpos.device)

    def const(x):
        return torch.as_tensor(np.asarray(x), dtype=qpos.dtype, device=qpos.device)

    R = torch.stack(fkr.body_rot, dim=1)[:, sb]
    c = torch.stack(fkr.body_pos, dim=1)[:, sb] + engine.mat_vec(
        R, const(cs.sph_local[idx]))
    r = const(cs.sph_radius[idx])
    floor = (c[..., 2] - r) < const(cs.sph_margin[idx] + cs.floor_margin)
    bc, bh = const(cs.box_center), const(cs.box_half)
    delta = torch.clamp(torch.abs(c[:, :, None, :] - bc) - bh, min=0.0)
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1)) - r[:, None]
    marg = const(cs.sph_margin[idx])[:, None] + const(cs.box_margin)
    walls = (dist < marg).any(dim=-1)
    return floor.sum(dim=1), walls.sum(dim=1)


def _ant_pose(model, num_envs: int, rng: np.random.RandomState):
    """``(qpos (B, nq), sphere centres (B, S, 3) about the torso)``: a small
    random tilt, hips and ankles inside their ranges, the torso at the
    origin, world dofs at ``qpos0``."""
    qpos = np.tile(model.qpos0, (num_envs, 1))
    axis = rng.normal(size=(num_envs, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0.0, 0.15, num_envs)
    qpos[:, :3] = 0.0
    qpos[:, 3] = np.cos(ang / 2)
    qpos[:, 4:7] = np.sin(ang / 2)[:, None] * axis
    for leg in range(4):
        qpos[:, 7 + 2 * leg] = rng.uniform(-0.4, 0.4, num_envs)
        qpos[:, 8 + 2 * leg] = ANKLE_SIGNS[leg] * rng.uniform(0.6, 1.1, num_envs)
    return qpos


def _sphere_offsets(spec: MazeEnvSpec, qpos: np.ndarray) -> np.ndarray:
    """The test spheres' centres ``(B, S, 3)`` relative to the torso
    origin (float64 kinematics)."""
    model, cs = spec.dynamic_model, spec.contact_set
    fkr = engine.fk(model, torch.as_tensor(qpos))
    sb = cs.sph_body
    R = torch.stack(fkr.body_rot, 1)[:, sb].numpy()
    return (torch.stack(fkr.body_pos, 1)[:, sb].numpy()
            + np.einsum("bsij,sj->bsi", R, cs.sph_local)
            - qpos[:, None, :3])


def _box_dist(c: np.ndarray, r: np.ndarray, center: np.ndarray,
              half: np.ndarray) -> np.ndarray:
    """Signed sphere-to-AABB distances ``(S, n)`` (negative inside)."""
    local = c[:, None, :] - center
    out = np.linalg.norm(np.maximum(np.abs(local) - half, 0.0), axis=-1)
    inside = np.min(half - np.abs(local), axis=-1)
    return np.where(out > 0.0, out, -inside) - r[:, None]


def block_states(spec: MazeEnvSpec, num_envs: int, seed: int):
    """``(qpos (B, nq), qvel (B, nv), t (B,))`` numpy states of a block
    world from a seed, for checks of the step against the blocks.

    Each block's slides are drawn a third of the time exactly at a travel
    limit, a third up to 0.05 beyond one, a third anywhere between; a
    falling block perches on its platform (its bottom up to 0.12 below the
    platform's top) in two envs of three and is pushed over the chasm
    (a slide limit where no platform holds it, z anywhere between the
    floor and its perch) in the third.  The ant (a small tilt, hips and
    ankles inside their ranges, its lowest sphere within ±0.01 of the
    floor or of the platform under its torso) is placed in a third of the
    envs with its farthest sphere toward a block's face between 0.02 short
    of it and 0.02 into it, in a third likewise against a wall of its
    cell, and anywhere in a free cell in the rest; placements that would
    sink a sphere more than 0.02 into a wall or a block are drawn again.
    qvel ~ N(0, 0.3) on every dof; t uniform over the episode."""
    rng = np.random.RandomState(seed)
    ms = spec.structure
    model, cs = spec.dynamic_model, spec.contact_set
    s, half = ms.size_scaling, ms.size_scaling / 2
    grid = ms.grid
    blocks = spec.block_runtimes

    def cell_of(x, y):
        j = int(np.floor((x + ms.torso_x) / s + 0.5))
        i = int(np.floor((y + ms.torso_y) / s + 0.5))
        return i, j

    def walkable(i, j):
        if not (0 <= i < grid.shape[0] and 0 <= j < grid.shape[1]):
            return False
        cell = MazeCell(grid[i, j])
        return not cell.is_block() and not cell.is_chasm()

    free = [(i, j) for i in range(grid.shape[0]) for j in range(grid.shape[1])
            if walkable(i, j)]
    qpos = _ant_pose(model, num_envs, rng)
    c_rel = _sphere_offsets(spec, qpos)
    r = cs.sph_radius
    low = (c_rel[..., 2] - r).min(axis=1)
    for e in range(num_envs):
        centers = _place_blocks(spec, qpos[e], rng, e)
        # the ant
        for attempt in range(100):
            mode = e % 3 if attempt < 50 else 2
            if mode == 0 and blocks:
                bi = rng.randint(len(blocks))
                bc, bh = centers[bi], blocks[bi].half
                k = rng.randint(2)
                sign = (-1.0, 1.0)[rng.randint(2)]
                reach = (-sign * c_rel[e, :, k] + r).max()
                xy = bc[:2] + rng.uniform(-bh[:2], bh[:2])
                xy[k] = bc[k] + sign * (bh[k] + reach + rng.uniform(-0.02, 0.02))
            else:
                i, j = free[rng.randint(len(free))]
                cx, cy = j * s - ms.torso_x, i * s - ms.torso_y
                xy = np.array([cx + rng.uniform(-half + 1.0, half - 1.0),
                               cy + rng.uniform(-half + 1.0, half - 1.0)])
                walls = [(di, dj) for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0))
                         if 0 <= i + di < grid.shape[0]
                         and 0 <= j + dj < grid.shape[1]
                         and MazeCell(grid[i + di, j + dj]).is_block()]
                if mode == 1 and walls:
                    di, dj = walls[rng.randint(len(walls))]
                    k, sign = (0, dj) if dj else (1, di)
                    reach = (sign * c_rel[e, :, k] + r).max()
                    xy[k] = ((cx, cy)[k]
                             + sign * (half - reach + rng.uniform(-0.02, 0.02)))
            i, j = cell_of(*xy)
            if not walkable(i, j):
                continue
            z = ms.height_offset - low[e] + rng.uniform(-0.01, 0.01)
            c = c_rel[e] + np.array([xy[0], xy[1], z])
            if len(cs.box_center) and _box_dist(
                    c, r, cs.box_center, cs.box_half).min() < -0.02:
                continue
            if any(_box_dist(c, r, bc, b.half).min() < -0.02
                   for bc, b in zip(centers, blocks)):
                continue
            qpos[e, :3] = [xy[0], xy[1], z]
            break
        else:
            raise RuntimeError(f"no placement for env {e} of {num_envs}")
    qvel = rng.normal(0.0, 0.3, (num_envs, model.nv))
    t = rng.randint(0, EPISODE_LIMIT, num_envs)
    return (qpos.astype(np.float32), qvel.astype(np.float32),
            t.astype(np.int32))


BALL_FAR = (50.0, 80.0)     # the far Ant's distance from the ball, m
BALL_FAST_SPIN = (10.0, 20.0)   # rad/s: a fast ball's spin about the vertical
BALL_KNIFE = 0.02           # m: how near the goal threshold the heads sit


def ball_states(spec: MazeEnvSpec, num_envs: int, seed: int):
    """``(qpos (B, 22), qvel (B, 20), t (B,))`` numpy states from a seed of
    an Ant world with a free object ball (AntSmallBilliard), for checks of
    the Ant kernel's ball rows.

    ``engine_kernel.ball_states`` draws the ant (a small tilt, hips and
    ankles inside their ranges, its lowest test sphere within ±0.01 of the
    floor, near the centre of a free cell) and the ball resting on the
    floor, by env index ``e % 8``: 0 against one of the ant's test spheres,
    1 against a wall face of its cell or in a corner, 2 its sphere's centre
    within half the goal threshold of the goal, 3 anywhere in a free cell;
    the ball's qvel x, y ~ N(0, 1), z ~ N(0, 0.1), spin ~ N(0, 3); the
    ant's qvel ~ N(0, 0.3); t uniform over the episode.  Then: 4 a leg
    (or torso capsule) pressed into the ball across its length, two
    neighbouring test spheres of one capsule at once, each 0.02-0.06 into
    it (the ball's centre on their bisecting plane, at or above its
    resting height; where none fits, the ball stays as mode 0 put it); 5 the ant moved 50-80 m from the ball, out of the
    maze in a random direction, with the ball left against its wall (the
    two turning trees far apart); 6 the ball's body origin, which the heads
    read, within 0.02 of the goal threshold on either side (the heads'
    knife edge); 7 the ball anywhere, spinning fast about the vertical
    (10-20 rad/s either way; ~N(0, 1) about the horizontal axes, so that
    it spins in place rather than rolls into the ant).  Deeper presses and
    faster spins blow up under the engine's explicit RK4 at dt 0.02, the
    JAX package's XLA step as the port's.  No test sphere sinks more than 0.02 into a wall, nor the
    ball more than 0.02 into a wall or (outside mode 0 and 4) into an ant
    sphere."""
    from .engine_kernel import ball_states as engine_ball_states

    q, v, t = (x.astype(np.float64)
               for x in engine_ball_states(spec, num_envs, seed))
    rng = np.random.RandomState(seed + 7919)
    ms = spec.structure
    model, cs = spec.dynamic_model, spec.contact_set
    qa, va = NQ, NV
    (s_b,) = np.nonzero(cs.sph_body >= NB)[0]
    r_b = float(cs.sph_radius[s_b])
    local_b = np.asarray(cs.sph_local[s_b], np.float64)
    ant = _ant_spheres(cs)
    r_s = cs.sph_radius[ant]
    goal = spec.task.goals[0]
    g_xy, thr = np.asarray(goal.pos[:2], np.float64), float(goal.threshold)
    s, half = ms.size_scaling, ms.size_scaling / 2

    def walkable(x, y):
        i = int(np.floor((y + ms.torso_y) / s + 0.5))
        j = int(np.floor((x + ms.torso_x) / s + 0.5))
        grid = ms.grid
        return (0 <= i < grid.shape[0] and 0 <= j < grid.shape[1]
                and not MazeCell(grid[i, j]).is_block()
                and not MazeCell(grid[i, j]).is_chasm())

    def centres(qe):
        fkr = engine.fk(model, torch.as_tensor(qe[None]))
        R = torch.stack(fkr.body_rot, 1)[0].numpy()
        P = torch.stack(fkr.body_pos, 1)[0].numpy()
        sb = cs.sph_body[ant]
        return P[sb] + np.einsum("sij,sj->si", R[sb], cs.sph_local[ant])

    def fits(c, ce, skip=()):
        """The ball's centre c clears the walls and the ant's spheres
        (but ``skip``) to within 0.02."""
        if len(cs.box_center) and _box_dist(
                c[None], np.array([r_b]), cs.box_center,
                cs.box_half).min() < -0.02:
            return False
        gap = np.linalg.norm(ce - c, axis=1) - r_s - r_b
        gap[list(skip)] = 0.0
        return gap.min() >= -0.02 and walkable(*c[:2])

    def put_ball(e, c, quat=None):
        if quat is None:
            quat = rng.normal(size=4)
            quat /= np.linalg.norm(quat)
        q[e, qa:qa + 3] = c - _quat_to_mat_np(quat) @ local_b
        q[e, qa + 3:qa + 7] = quat

    capsules = [np.nonzero(cs.sph_body[ant] == b)[0] for b in range(1, NB)]
    for e in range(num_envs):
        mode = e % 8
        if mode == 4:
            ce = centres(q[e])
            for _ in range(500):
                k = capsules[rng.randint(len(capsules))]
                i = rng.randint(len(k) - 1)          # two neighbouring spheres
                a, b = ce[k[i]], ce[k[i + 1]]
                axis = (b - a) / np.linalg.norm(b - a)
                u = rng.normal(size=3)
                u -= axis * (u @ axis)
                u /= np.linalg.norm(u)
                reach = r_s[k[i]] + r_b - rng.uniform(0.02, 0.06)
                off = np.sqrt(reach ** 2 - (np.linalg.norm(b - a) / 2) ** 2)
                c = (a + b) / 2 + off * u
                if c[2] >= r_b - 0.01 and fits(c, ce, skip=k):
                    put_ball(e, c)
                    break
        elif mode == 5:
            ang = rng.uniform(0.0, 2 * np.pi)
            q[e, :2] = q[e, qa:qa + 2] + rng.uniform(*BALL_FAR) * np.array(
                [np.cos(ang), np.sin(ang)])
        elif mode == 6:
            ce = centres(q[e])
            for _ in range(200):
                quat = rng.normal(size=4)
                quat /= np.linalg.norm(quat)
                off = _quat_to_mat_np(quat) @ local_b
                ang = rng.uniform(0.0, 2 * np.pi)
                o_xy = g_xy + (thr + rng.uniform(-BALL_KNIFE, BALL_KNIFE)) * (
                    np.array([np.cos(ang), np.sin(ang)]))
                c = np.r_[o_xy + off[:2], r_b + rng.uniform(-0.01, 0.01)]
                if fits(c, ce):
                    put_ball(e, c, quat)
                    break
            else:
                raise RuntimeError(f"no knife-edge ball for env {e}")
        elif mode == 7:
            # about the vertical, so that it spins in place rather than
            # rolls into the ant: the body-frame dofs of a world spin
            w = np.r_[rng.normal(0.0, 1.0, 2), rng.choice([-1.0, 1.0])
                      * rng.uniform(*BALL_FAST_SPIN)]
            R = _quat_to_mat_np(q[e, qa + 3:qa + 7])
            v[e, va + 3:va + 6] = R.T @ w
    return (q.astype(np.float32), v.astype(np.float32),
            np.asarray(t).astype(np.int32))


def ball_census(ks: AntKernelSpec, qpos: torch.Tensor):
    """Per env at ``qpos``, the ball's active candidates: ``(floor (B,),
    walls (B,), spheres (B,))`` int64, its contact with the floor, with
    its two nearest static boxes, and the ant's test spheres within their
    pair margin of it."""
    spec = ks.env_spec
    model, cs = spec.dynamic_model, spec.contact_set
    kd = engine.kin_dyn(model, qpos, torch.zeros(
        qpos.shape[0], spec.nv, dtype=qpos.dtype, device=qpos.device))
    _, chain_mask, _, _ = engine.get_masks(model)
    act = contact.active_candidates(model, cs, kd, chain_mask)
    statics = np.nonzero(cs.sph_vs_static)[0]
    groups = int(cs.has_floor) + min(len(cs.box_center), 2)
    col = [kind * len(statics) + int(np.nonzero(statics == x)[0][0])
           for kind in range(groups) for x in statics if cs.sph_body[x] >= NB]
    floor = act[:, col[0]].to(torch.int64)
    walls = act[:, col[1:]].sum(dim=1)
    n = groups * len(statics)
    return floor, walls, act[:, n:n + len(cs.pair_i)].sum(dim=1)


def _place_blocks(spec: MazeEnvSpec, q: np.ndarray,
                  rng: np.random.RandomState, e: int) -> list:
    """Draw env ``e``'s movable blocks into its qpos row ``q`` (in place)
    and return their centres: each slide a third of the time exactly at a
    travel limit, a third up to 0.05 beyond one, a third anywhere between;
    a falling block perched on its platform (its bottom up to 0.12 below
    the platform's top) when ``e % 3 != 2``, else pushed over the chasm (a
    slide limit where no platform holds it, z anywhere between the floor
    and its perch)."""
    model = spec.dynamic_model
    support = {zdof: plats for _, zdof, _, plats in spec._falling_support}
    centers = []
    for b in spec.block_runtimes:
        idx = b.qpos_idx
        for k in range(3):
            a = idx[k]
            if a < 0 or (k == 2 and b.falling):
                continue
            lo, hi = model.jnt_range[_joint_of(model, a)]
            mode = rng.randint(3)
            if mode == 0:
                q[a] = (lo, hi)[rng.randint(2)]
            elif mode == 1:
                q[a] = ((lo - rng.uniform(0, 0.05)) if rng.randint(2)
                        else (hi + rng.uniform(0, 0.05)))
            else:
                q[a] = rng.uniform(lo, hi)
        if b.falling:
            zq = b.qpos_idx[2]
            plats = support[int(model.jnt_dofadr[_joint_of(model, zq)])]
            z_perch = max(p[4] for p in plats) - b.body_pos[2] + b.half[2]
            if e % 3 == 2:
                # over the chasm: a slide limit where no platform holds it
                opts = []
                for k in range(2):
                    a = b.qpos_idx[k]
                    if a < 0:
                        continue
                    for v in model.jnt_range[_joint_of(model, a)]:
                        xy = b.body_pos[:2].copy()
                        for kk in range(2):
                            if b.qpos_idx[kk] >= 0:
                                xy[kk] += v if kk == k else q[b.qpos_idx[kk]]
                        if not any(abs(xy[0] - p[0]) < p[2]
                                   and abs(xy[1] - p[1]) < p[3] for p in plats):
                            opts.append((a, v))
                if opts:
                    a, v = opts[rng.randint(len(opts))]
                    q[a] = v
                q[zq] = rng.uniform(0.0, z_perch)
            else:
                q[zq] = z_perch - rng.uniform(0.0, 0.12)
        centers.append(b.body_pos + np.array(
            [q[a] if a >= 0 else 0.0 for a in b.qpos_idx]))
    return centers


def _joint_of(model, qadr: int) -> int:
    (j,) = np.nonzero(np.asarray(model.jnt_qposadr) == qadr)[0]
    return int(j)


def block_census(ks: AntKernelSpec, qpos: torch.Tensor) -> torch.Tensor:
    """Per env, the test spheres within their contact margin of any movable
    block at ``qpos``: ``(B,)`` int64."""
    spec = ks.env_spec
    cs = spec.contact_set
    kd = engine.kin_dyn(spec.dynamic_model, qpos, torch.zeros(
        qpos.shape[0], spec.nv, dtype=qpos.dtype, device=qpos.device))
    _, chain_mask, _, _ = engine.get_masks(spec.dynamic_model)
    active = contact.active_candidates(spec.dynamic_model, cs, kd, chain_mask)
    q = len(cs.qpair_s)
    if q == 0:
        return torch.zeros(qpos.shape[0], dtype=torch.int64, device=qpos.device)
    return active[:, -q:].sum(dim=1)


def active_trace(ks: AntKernelSpec, qpos: torch.Tensor, qvel: torch.Tensor,
                 actions: torch.Tensor, detail: bool = False):
    """The plain version's active contacts and joint limits at each forward
    evaluation of one env step from ``(qpos, qvel)`` under ``actions``,
    laid out as the step kernel's trace (``AntStep(..., trace=True)``):
    ``(B, 4 * frame_skip, 25)`` int32, per evaluation 8 words of contact
    bits (bit kind * S + sphere; kind 0 the floor, 1 and 2 the first and
    second static-box pick, 3 + b block b; then, from (3 + blocks) * S, the
    ball against the floor, its first and second box pick, and each sphere
    against the ball), 8 of those whose sphere centre is inside its box, 8
    of those whose tangent frame is built off the x axis, and one word of
    limit bits (bit d: dof d's limit is violated) and support rows.  The stages are those of
    ``engine.rk4_step``.  With ``detail``, returns ``(trace, info)``: info
    holds each candidate's kernel bit (``bits (C,)``), its ``dist -
    margin`` per evaluation (``gap (B, E, C)``; active where < 0), the
    limited dofs (``lim_dof (L,)``) and their violation per evaluation
    (``lim_gap (B, E, L)``, max(q - hi, lo - q); active where > 0)."""
    spec = ks.env_spec
    model, cs = spec.dynamic_model, spec.contact_set
    _, chain_mask, _, _ = engine.get_masks(model)
    extra = spec.world_extra_qfrc()
    ant = _ant_spheres(cs)
    S = len(ant)
    idx = {int(x): k for k, x in enumerate(ant)}
    ball_bit = (3 + ks.n_blk) * S
    groups = int(cs.has_floor) + min(len(cs.box_center), 2)
    # the kernel's bit of each candidate (contact._detect's order: the
    # spheres that meet the world, the ball's among them, by kind; the
    # sphere-ball pairs; the sphere-block pairs)
    bits = [kind * S + idx[int(x)] if int(x) in idx else ball_bit + kind
            for kind in range(groups) for x in np.nonzero(cs.sph_vs_static)[0]]
    bits += [ball_bit + 3 + idx[int(i)] for i in cs.pair_i]
    bits += [(3 + int(b)) * S + idx[int(s)]
             for s, b in zip(cs.qpair_s, cs.qpair_b)]
    bits = torch.as_tensor(bits, dtype=torch.int64, device=qpos.device)
    C = engine._consts(model, qpos)
    B = qpos.shape[0]
    out = torch.zeros(B, 4 * ks.frame_skip, 25, dtype=torch.int64,
                      device=qpos.device)
    cases = []

    def extra_rec(kd, qacc0, Minv, v):
        word = torch.zeros(B, dtype=torch.int64, device=qpos.device)
        for body, case in spec.support_cases(kd, qacc0, Minv, v).items():
            word = word | (case.to(torch.int64) << (24 + 2 * (body - NB)))
        cases.append(word)
        return extra(kd, qacc0, Minv, v)

    h = float(np.float32(model.timestep))
    ctrl = actions.to(qpos.dtype)
    ev = 0
    gaps, lim_gaps = [], []
    for _ in range(ks.frame_skip):
        zero_v = torch.zeros_like(qvel)
        prev_v, prev_a, acc_v, acc_a = qvel, zero_v, zero_v, zero_v
        for hs, w in ((0.0, 1.0), (h / 2, 2.0), (h / 2, 2.0), (h, 1.0)):
            hs = float(np.float32(hs))
            q_s = engine.integrate_pos(model, qpos, prev_v, hs)
            v_s = qvel + prev_a * hs
            kd = engine.kin_dyn(model, q_s, v_s)
            dist, _, normal, margin, inside = contact._detect(
                cs, contact._consts(model, cs, chain_mask, q_s), kd)
            act = dist < margin
            gaps.append(dist - margin)
            for w0, flag in ((0, act), (8, act & inside),
                             (16, act & (normal[..., 0].abs() < 0.5))):
                words = torch.zeros(B, 8, dtype=torch.int64, device=qpos.device)
                words.index_add_(1, bits // 32,
                                 flag.to(torch.int64) << (bits % 32))
                out[:, ev, w0:w0 + 8] = words
            q = q_s[:, C.lim_qadr]
            on = (q > C.lim_hi) | (q < C.lim_lo)
            lim_gaps.append(torch.maximum(q - C.lim_hi, C.lim_lo - q))
            a_s = engine.forward(model, q_s, v_s, ctrl, extra_rec)
            out[:, ev, 24] = ((on.to(torch.int64) << C.lim_vadr).sum(dim=1)
                              | cases[-1])
            prev_v, prev_a = v_s, a_s
            acc_v = acc_v + w * v_s
            acc_a = acc_a + w * a_s
            ev += 1
        qpos = engine.integrate_pos(model, qpos, acc_v / 6.0, h)
        qvel = qvel + (acc_a / 6.0) * h
    # as int32 bit patterns, the kernel's words
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
    if not detail:
        return out
    return out, dict(bits=bits, gap=torch.stack(gaps, dim=1),
                     lim_dof=C.lim_vadr, lim_gap=torch.stack(lim_gaps, dim=1))
