"""Carry state and lowered spec data across from the JAX package.

The port imports nothing of JAX; these functions take and give numpy
arrays, so a caller that has both packages (the tests) can hand a JAX
``EnvState`` to the port and compare the two sides' lowered data.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .envs.env import EnvState
from .ops.ant_kernel import AntKernelSpec
from .ops.engine_kernel import EngineKernelSpec
from .ops.point_kernel import PointKernelSpec
from .ops.swimmer_kernel import SwimmerKernelSpec


def from_jax_state(qpos, qvel, t, goal_pos=None, *, device) -> EnvState:
    """The port's :class:`EnvState` from the arrays of a JAX ``EnvState``
    (``np.asarray(state.qpos)`` etc.; the JAX PRNG key has no counterpart:
    the port's randomness lives in ``torch.Generator`` objects).  The two
    packages lay qpos and qvel out alike, so every coordinate carries
    across as it is: a free object ball's position and quaternion (7 qpos)
    and its 6 dofs among them."""

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return EnvState(
        qpos=f32(qpos),
        qvel=f32(qvel),
        t=torch.tensor(np.asarray(t, dtype=np.int32), device=device),
        goal_pos=None if goal_pos is None else f32(goal_pos),
    )


def to_numpy(state: EnvState) -> Dict[str, Optional[np.ndarray]]:
    """``qpos``, ``qvel``, ``t`` (and ``goal_pos``) as numpy arrays."""
    return {
        "qpos": state.qpos.detach().cpu().numpy(),
        "qvel": state.qvel.detach().cpu().numpy(),
        "t": state.t.detach().cpu().numpy(),
        "goal_pos": (None if state.goal_pos is None
                     else state.goal_pos.detach().cpu().numpy()),
    }


def lowered_spec(ks) -> Dict[str, object]:
    """The kernel data of ``ks`` under the field names of the JAX package:
    ``point_pallas.PointKernelSpec`` for a :class:`PointKernelSpec` (in an
    object world with ``n_world``, ``obs_offset``, ``object_dof_idx`` and
    the fields of its ``object_lanes.ObjectLanesSpec`` under
    ``object_spec.<name>``, the balls and blocks as lists of dicts of
    their ``BallL`` / ``BlockL`` fields);
    ``ant_math.AntConsts``, ``ant_math.AntWorld`` and
    ``ant_pallas.AntEnvKernelSpec`` for an :class:`AntKernelSpec`;
    ``swimmer_pallas.SwimmerEnvKernelSpec`` (its ``dyn`` fields, those of
    ``swimmer_math.SwimmerKernelSpec``, under ``dyn.<name>``) for a
    :class:`SwimmerKernelSpec`; ``engine_pallas.EngineEnvKernelSpec`` for
    an :class:`EngineKernelSpec` (see :func:`_lowered_engine`).  Numpy
    arrays (float32 as the kernels read them) and Python scalars."""
    if isinstance(ks, AntKernelSpec):
        return _lowered_ant(ks)
    if isinstance(ks, EngineKernelSpec):
        return _lowered_engine(ks)
    if isinstance(ks, SwimmerKernelSpec):
        return _lowered_swimmer(ks)
    walls = ks.walls.detach().cpu().numpy()
    out: Dict[str, object] = {
        "walls_p1": walls[:, :2],
        "walls_p2": walls[:, 2:],
        "walls_mask": np.ones(len(walls), dtype=bool),
        **_goal_fields(ks.env_spec.heads),
    }
    for name in ("reward_type", "penalty", "scale", "restitution", "com_offset",
                 "eject_margin", "eject_lam", "eject_mu", "dt", "episode_limit",
                 "radius", "body_mass", "couple_arm", "spin_inertia",
                 "arrow_tips", "n_world", "obs_offset", "object_dof_idx"):
        out[name] = getattr(ks, name)
    o = ks.object_spec
    if o is not None:
        for name in o._fields:
            val = getattr(o, name)
            if name in ("balls", "blocks"):
                val = [e._asdict() for e in val]
            out[f"object_spec.{name}"] = val
    return out


def _goal_fields(heads) -> Dict[str, np.ndarray]:
    goals = heads.goals
    return {
        "goal_pos": goals.pos.cpu().numpy(),
        "goal_dim_mask": goals.dim_mask.cpu().numpy(),
        "goal_threshold": goals.threshold.cpu().numpy(),
        "goal_scale": goals.reward_scale.cpu().numpy(),
        "goal_valid": goals.valid.cpu().numpy(),
    }


def _lowered_swimmer(ks: SwimmerKernelSpec) -> Dict[str, object]:
    d = ks.dyn
    out: Dict[str, object] = {f"dyn.{name}": getattr(d, name) for name in (
        "mass", "inertia_z", "armature", "viscosity", "density", "box",
        "gear", "limit_lo", "limit_hi", "timestep", "n_act", "n_links")}
    out.update(_goal_fields(ks.env_spec.heads))
    for name in ("reward_type", "penalty", "scale", "inner_scale",
                 "frame_skip", "episode_limit", "n_world"):
        out[name] = getattr(ks, name)
    out["dynamic_goals"] = False
    return out


def _lowered_ant(ks: AntKernelSpec) -> Dict[str, object]:
    body, dof, act = ks.table("body"), ks.table("dof"), ks.table("act")
    sph, box = ks.table("sph"), ks.table("box")
    inertias = np.zeros((len(body), 3, 3), np.float32)
    for (r, c), col in zip(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)),
                           range(14, 20)):
        inertias[:, r, c] = inertias[:, c, r] = body[:, col]
    return {
        # ant_math.AntConsts
        "masses": body[:, 10], "coms": body[:, 11:14], "inertias": inertias,
        "armature": dof[:, 0], "damping": dof[:, 1],
        "hip_range": dof[6, 3:5], "ankle_ranges": dof[7::2, 3:5],
        "gear": act[0, 1], "ctrl_hi": act[0, 3],
        "act_dofadr": act[:, 0].astype(np.int64), "timestep": ks.timestep,
        "gravity": ks.gravity,
        # ant_math.AntWorld (the test spheres that meet the world)
        "box_center": box[:, :3], "box_half": box[:, 3:6],
        "box_margin": box[:, 6],
        "floor_margin": float(ks.env_spec.contact_set.floor_margin),
        "sph_body": sph[:, 0].astype(np.int64), "sph_local": sph[:, 1:4],
        "sph_radius": sph[:, 4], "sph_margin": sph[:, 5],
        "sph_solimp": sph[:, 8:11], "friction": sph[0, 7],
        "solimp": sph[0, 8:11], "solref_tc": sph[0, 11],
        # ant_pallas.AntEnvKernelSpec
        "nq": len(ks.table("qpos0")[0]), "nv": len(dof) + ks.n_w,
        "qpos0": ks.table("qpos0")[0],
        **_goal_fields(ks.env_spec.heads),
        "reward_type": ks.reward_type, "penalty": ks.penalty,
        "scale": ks.scale, "inner_scale": ks.inner_scale,
        "frame_skip": ks.frame_skip, "episode_limit": ks.episode_limit,
        "solver_iters": ks.solver_iters, "obs_offset": ks.obs_offset,
    }


def lowered_blocks(ks: AntKernelSpec) -> List[Dict[str, object]]:
    """The movable blocks of an :class:`AntKernelSpec` under the field
    names of the JAX package's ``ant_math.AntBlock`` (float32 as the
    kernels read them): base, half, inv_mass, axes, vadr, ranges,
    falling_zdof, plats; and the pair constants under ``margin`` (the box
    margin: the pair margin less the sphere's)."""
    wdof, blk, plat = ks.table("wdof"), ks.table("blk"), ks.table("plat")
    qpair, sph = ks.table("qpair"), ks.table("sph")
    n_sph = len(sph)
    out = []
    for b, row in enumerate(blk):
        d0, n = int(row[6]), int(row[7])
        w = wdof[d0 - 14:d0 - 14 + n]
        p0 = int(row[9])
        out.append({
            "base": row[0:3], "half": row[3:6],
            "inv_mass": w[0, 2], "axes": w[:, 0].astype(np.int64),
            "vadr": np.arange(d0, d0 + n),
            "ranges": w[:, 4:6], "falling_zdof": int(row[8]),
            "margin": qpair[b * n_sph, 0] - sph[0, 5],
            "plats": plat[p0:p0 + int(row[10])],
        })
    return out


def _lowered_engine(ks: EngineKernelSpec) -> Dict[str, object]:
    """The generic engine kernel's data under the names of the JAX
    ``engine_pallas.EngineEnvKernelSpec``, read back from the packed
    tables: its scalars and goals; its ``LaneWorld`` under ``lw.<name>``
    (``lw.sph_solref`` holds the solref time constant as the kernels use
    it, clamped to 2 dt; the moving boxes' own margins, solref, solimp and
    friction, which the tables carry only mixed per pair, come from the
    contact set; the JAX prune's ``n_near_boxes`` has no counterpart); the
    model's arrays under ``lw.model.<name>``; the sphere-sphere pair
    table's mixed constants under ``spair.<name>`` and the
    sphere-vs-moving-box pair table's under ``pair.<name>``; and the heads'
    anchor under ``head_qadr`` / ``head_base``."""
    body, jnt, dof, act = (ks.table(n) for n in ("body", "jnt", "dof", "act"))
    sph, box, dbox, pair = (ks.table(n) for n in ("sph", "box", "dbox", "pair"))
    spair = ks.table("spair")
    fall, plat = ks.table("fall"), ks.table("plat")
    cs = ks.env_spec.contact_set
    inertia = np.zeros((len(body), 3, 3), np.float32)
    for (r, c), col in zip(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)),
                           range(19, 25)):
        inertia[:, r, c] = inertia[:, c, r] = body[:, col]
    falling = tuple(
        (int(f[0]), int(f[1]), float(f[2]),
         tuple(tuple(float(x) for x in p)
               for p in plat[int(f[3]):int(f[3]) + int(f[4])]))
        for f in fall)
    out: Dict[str, object] = {
        "nq": ks.nq, "nv": ks.nv, "nu": ks.nu,
        **_goal_fields(ks.env_spec.heads),
        "lw.model.body_parent": body[:, 0].astype(np.int64),
        "lw.model.body_pos": body[:, 3:6],
        "lw.model.body_rot": body[:, 6:15].reshape(-1, 3, 3),
        "lw.model.body_mass": body[:, 15], "lw.model.body_com": body[:, 16:19],
        "lw.model.body_inertia": inertia,
        "lw.model.jnt_type": jnt[:, 0].astype(np.int64),
        "lw.model.jnt_qposadr": jnt[:, 1].astype(np.int64),
        "lw.model.jnt_dofadr": jnt[:, 2].astype(np.int64),
        "lw.model.jnt_axis": jnt[:, 3:6], "lw.model.jnt_pos": jnt[:, 6:9],
        "lw.model.jnt_range": jnt[:, 10:12],
        "lw.model.dof_armature": dof[:, 1], "lw.model.dof_damping": dof[:, 2],
        "lw.model.act_dofadr": act[:, 0].astype(np.int64),
        "lw.model.act_gear": act[:, 1], "lw.model.act_ctrlrange": act[:, 2:4],
        "lw.sph_body": sph[:, 0].astype(np.int64), "lw.sph_local": sph[:, 1:4],
        "lw.sph_radius": sph[:, 4], "lw.sph_margin": sph[:, 5],
        "lw.sph_friction": sph[:, 7], "lw.sph_solimp": sph[:, 8:11],
        "lw.sph_solref": sph[:, 11:13], "lw.sph_vs_static": sph[:, 13] >= 0,
        "lw.box_center": box[:, :3], "lw.box_half": box[:, 3:6],
        "lw.box_margin": box[:, 6], "lw.has_floor": bool(cs.has_floor),
        "lw.floor_margin": float(cs.floor_margin),
        "lw.pair_i": spair[:, 0].astype(np.int64),
        "lw.pair_j": spair[:, 1].astype(np.int64),
        "lw.dbox_body": dbox[:, 0].astype(np.int64),
        "lw.dbox_local": dbox[:, 1:4], "lw.dbox_half": dbox[:, 4:7],
        "lw.dbox_margin": np.asarray(cs.dbox_margin, np.float32),
        "lw.dbox_solref": np.asarray(cs.dbox_solref, np.float32),
        "lw.dbox_solimp": np.asarray(cs.dbox_solimp, np.float32),
        "lw.dbox_friction": np.asarray(cs.dbox_friction, np.float32),
        "lw.qpair_s": pair[:, 0].astype(np.int64),
        "lw.qpair_b": pair[:, 1].astype(np.int64),
        "lw.falling": falling,
        "pair.margin": pair[:, 2], "pair.friction": pair[:, 3],
        "pair.solimp": pair[:, 4:7], "pair.solref": pair[:, 7:9],
        "spair.margin": spair[:, 2], "spair.friction": spair[:, 3],
        "spair.solimp": spair[:, 4:7], "spair.solref": spair[:, 7:9],
    }
    for name in ("reward_type", "penalty", "scale", "inner_scale",
                 "frame_skip", "episode_limit", "solver_iters", "fwd_weight",
                 "ctrl_cost", "obs_offset", "head_qadr", "head_base",
                 "dynamic_goals"):
        out[name] = getattr(ks, name)
    return out
