"""The Ant step and rollout kernels' data, and their plain PyTorch versions.

``spec_from_env`` is the counterpart of ``mujoco_maze_tpu/ops/
ant_pallas.py::spec_from_env`` with ``ant_math.consts_from_model`` and
``ant_math.world_from_spec(n_near_boxes=4)``, for the object-free Ant
mazes.  Where the Pallas kernel baked the model and the maze into the
program at trace time, the CUDA kernels (``csrc/ant_lane.cu``) take them
as runtime tables, packed into one float32 buffer, so one binary serves
every object-free Ant maze:

* ``body (13, 20)``: parent, hinge dof (-1: welded), the two hinge dofs on
  the root path (-1 padded), body offset (3), hinge axis (3), mass, com
  (3), inertia about the com (xx, yy, zz, xy, xz, yz);
* ``dof (14, 5)``: armature, damping, limited, range lo, range hi;
* ``act (8, 4)``: dof, gear, ctrl lo, ctrl hi;
* ``sph (S, 13)``: the test spheres that meet the world: body, local
  centre (3), radius, margin, margin against the floor, friction, solimp
  (3), solref time constant (clamped to 2 dt), solref damping ratio;
* ``box (nbox, 7)``: the static boxes, centre (3), half (3), margin;
* ``goals (G, 9)``: as for the Point;
* ``qpos0 (15)``: the reset pose.

The scalars go by value in a POD struct (``lane_env.AntParams``).

Beside them are the plain versions of both kernels.  ``ant_step_plain``
is the env step through the batched engine (``spec.step``), as the JAX
package's XLA path steps it.  ``ant_rollout_plain`` draws the rollout
kernel's Philox4x32-10 stream and steps through the same engine.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..envs.env import EPISODE_LIMIT, EnvState, MazeEnvSpec
from ..models.ant import AntRobot
from ..physics import engine
from ..physics.contact import CONTACT_SOLVER_ITERS
from ..physics.model import FREE, HINGE
from .philox import normal_box_muller, philox_words, uniform24
from .point_kernel import Tensors5, goal_table

N_NEAR_BOXES = 4          # torso-proximity box prune (ant_math.world_from_spec)
MAX_SPHERES = 40          # kMaxSph in csrc/ant_lane.cu
NB, NV, NQ, NU = 13, 14, 15, 8
TABLES = ("body", "dof", "act", "sph", "box", "goals", "qpos0")


class AntKernelSpec(NamedTuple):
    """Device tables + scalars of one object-free Ant maze."""

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
    n_near: int

    def table(self, name: str) -> np.ndarray:
        """One table as a numpy float32 array (rows, cols)."""
        off, rows, cols = self.offsets[name]
        flat = self.packed[off:off + rows * cols].detach().cpu().numpy()
        return flat.reshape(rows, cols)


def _check_model(model) -> None:
    """The CUDA kernel's topology: 13 bodies, a free root, then bodies
    welded or on one hinge at their origin, at most two hinges on a root
    path, identity body frames, hinge dof = qpos address - 1."""
    if (model.nbody, model.nv, model.nq, model.nu) != (NB, NV, NQ, NU):
        raise NotImplementedError(
            "the Ant kernels take the 13-body ant without world dofs "
            "(Ant object worlds: ROADMAP queue 1 item 11)")
    if int(model.jnt_type[0]) != FREE or int(model.jnt_body[0]) != 0:
        raise NotImplementedError("the Ant kernels need a free root joint")
    seen = set()
    for j in range(1, model.njnt):
        b = int(model.jnt_body[j])
        if (int(model.jnt_type[j]) != HINGE or b in seen
                or np.any(model.jnt_pos[j] != 0.0)
                or int(model.jnt_qposadr[j]) != int(model.jnt_dofadr[j]) + 1):
            raise NotImplementedError(
                "the Ant kernels take one hinge at each body origin")
        seen.add(b)
    if np.any(model.body_quat != np.array([1.0, 0.0, 0.0, 0.0])):
        raise NotImplementedError("the Ant kernels need identity body frames")
    if np.any(model.body_parent[1:] >= np.arange(1, NB)):
        raise NotImplementedError("the Ant kernels need parents before children")


def _tables(spec: MazeEnvSpec) -> dict:
    model = spec.dynamic_model
    cs = spec.contact_set
    _check_model(model)
    hinge_of = {int(model.jnt_body[j]): j for j in range(1, model.njnt)}
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
    dof[:, 0] = model.dof_armature
    dof[:, 1] = model.dof_damping
    for j in range(1, model.njnt):
        d = int(model.jnt_dofadr[j])
        dof[d, 2:] = [float(model.jnt_limited[j]), *model.jnt_range[j]]
    act = np.stack([model.act_dofadr, model.act_gear,
                    model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]], 1)
    if len(cs.pair_i) or len(cs.qpair_s) or not cs.has_floor or cs.floor_z != 0:
        raise NotImplementedError(
            "the Ant kernels take a floor at z = 0 and static boxes only "
            "(Ant object worlds: ROADMAP queue 1 item 11)")
    idx = np.nonzero(cs.sph_vs_static)[0]
    if len(idx) > MAX_SPHERES:
        raise NotImplementedError(f"{len(idx)} test spheres > {MAX_SPHERES}")
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
                qpos0=np.asarray(model.qpos0)[None])


def spec_from_env(spec: MazeEnvSpec) -> AntKernelSpec:
    """Lower an object-free Ant :class:`MazeEnvSpec` to kernel tables."""
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
        n_near=min(N_NEAR_BOXES, len(spec.contact_set.box_center)),
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
                  qpos0: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reset state an env draws at one rollout step (blocks 2-12,
    words 8-51), the Ant's reset law (models/ant.py): ``qpos0 + U(±0.1)``
    with the quaternion renormalised (words 8-22), and ``qvel = 0.1 N(0,
    1)`` by Box-Muller (words 23-50)."""
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
    for step in range(num_steps):
        act = rollout_ctrl(env_index, step, seed)
        qpos, qvel, t, reward, term = ant_step_plain(ks, qpos, qvel, t, act)
        done = term | (t >= ks.episode_limit)
        q_r, v_r = rollout_reset(env_index, step, seed, qpos0)
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
    # test spheres relative to the torso (float64 kinematics)
    fkr = engine.fk(model, torch.as_tensor(qpos))
    sb = cs.sph_body
    R = torch.stack(fkr.body_rot, 1)[:, sb].numpy()
    c = (torch.stack(fkr.body_pos, 1)[:, sb].numpy()
         + np.einsum("bsij,sj->bsi", R, cs.sph_local))
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
    """Per env, the test spheres within their contact margin of the floor
    and of any static box at ``qpos``: ``(floor (B,), walls (B,))`` int64."""
    spec = ks.env_spec
    cs = spec.contact_set
    fkr = engine.fk(spec.dynamic_model, qpos)
    idx = np.nonzero(cs.sph_vs_static)[0]
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
