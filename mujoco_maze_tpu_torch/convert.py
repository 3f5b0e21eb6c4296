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
from .ops.point_kernel import PointKernelSpec


def from_jax_state(qpos, qvel, t, goal_pos=None, *, device) -> EnvState:
    """The port's :class:`EnvState` from the arrays of a JAX ``EnvState``
    (``np.asarray(state.qpos)`` etc.; the JAX PRNG key has no counterpart:
    the port's randomness lives in ``torch.Generator`` objects)."""

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
    ``point_pallas.PointKernelSpec`` for a :class:`PointKernelSpec`;
    ``ant_math.AntConsts``, ``ant_math.AntWorld`` and
    ``ant_pallas.AntEnvKernelSpec`` for an :class:`AntKernelSpec`.  Numpy
    arrays (float32 as the kernels read them) and Python scalars."""
    if isinstance(ks, AntKernelSpec):
        return _lowered_ant(ks)
    walls = ks.walls.detach().cpu().numpy()
    goals = ks.env_spec.heads.goals
    out: Dict[str, object] = {
        "walls_p1": walls[:, :2],
        "walls_p2": walls[:, 2:],
        "walls_mask": np.ones(len(walls), dtype=bool),
        "goal_pos": goals.pos.cpu().numpy(),
        "goal_dim_mask": goals.dim_mask.cpu().numpy(),
        "goal_threshold": goals.threshold.cpu().numpy(),
        "goal_scale": goals.reward_scale.cpu().numpy(),
        "goal_valid": goals.valid.cpu().numpy(),
    }
    for name in ("reward_type", "penalty", "scale", "restitution", "com_offset",
                 "eject_margin", "eject_lam", "eject_mu", "dt", "episode_limit",
                 "radius", "body_mass", "couple_arm", "spin_inertia",
                 "arrow_tips"):
        out[name] = getattr(ks, name)
    return out


def _lowered_ant(ks: AntKernelSpec) -> Dict[str, object]:
    body, dof, act = ks.table("body"), ks.table("dof"), ks.table("act")
    sph, box = ks.table("sph"), ks.table("box")
    goals = ks.env_spec.heads.goals
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
        "goal_pos": goals.pos.cpu().numpy(),
        "goal_dim_mask": goals.dim_mask.cpu().numpy(),
        "goal_threshold": goals.threshold.cpu().numpy(),
        "goal_scale": goals.reward_scale.cpu().numpy(),
        "goal_valid": goals.valid.cpu().numpy(),
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
