"""Carry state and lowered spec data across from the JAX package.

The port imports nothing of JAX; these functions take and give numpy
arrays, so a caller that has both packages (the tests) can hand a JAX
``EnvState`` to the port and compare the two sides' lowered data.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .envs.env import EnvState
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


def lowered_spec(ks: PointKernelSpec) -> Dict[str, object]:
    """The kernel data of ``ks`` under the field names of the JAX package's
    ``point_pallas.PointKernelSpec``, as numpy arrays and Python scalars."""
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
