"""The Point step and rollout kernels' data, and their plain PyTorch versions.

``spec_from_env`` is the counterpart of ``mujoco_maze_tpu/ops/
point_pallas.py::spec_from_env`` for plain (object-free) mazes.  Where the
Pallas kernel baked walls and goals into the program at trace time, the
CUDA kernels (``csrc/point_lane.cu``) take them as runtime tables, so one
binary serves every plain Point maze:

* ``walls (W, 4)`` float32: ``p1x, p1y, p2x, p2y`` of each valid segment;
* ``goals (G, 9)`` float32: ``pos (3), dim_mask (3), threshold², reward
  scale, valid``;
* the scalars, passed by value in a POD struct (``lane_env.PointParams``).

Beside them are the plain versions of both kernels.  ``point_step_plain``
composes the env step as the JAX package's XLA path does
(``models/point.py`` + ``ops/segments.py`` + the task heads).
``point_rollout_plain`` draws the same Philox4x32-10 stream as the rollout
kernel, in int64 torch arithmetic masked to 32 bits, so the two can be
compared on one seed.  The tests run the plain versions; on a card the
main path runs the kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..envs.env import EPISODE_LIMIT, EnvState, MazeEnvSpec
from .philox import philox4x32, philox_words, uniform24  # noqa: F401

Tensors5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]

REWARD_TYPES = {"none": 0, "dist": 1, "goal": 2}


class PointKernelSpec(NamedTuple):
    """Device tables + scalars of one plain Point maze (names as in the
    Pallas ``PointKernelSpec``)."""

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
    )


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
    episode counts ``(B,)`` int32."""
    env_index = torch.arange(qpos.shape[0], dtype=torch.int64,
                             device=qpos.device)
    rew = torch.zeros(qpos.shape[0], dtype=torch.float32, device=qpos.device)
    eps = torch.zeros(qpos.shape[0], dtype=torch.int32, device=qpos.device)
    for step in range(num_steps):
        act, q_r, v_r = rollout_draws(env_index, step, seed)
        qpos, qvel, t, reward, term = point_step_plain(ks, qpos, qvel, t, act)
        done = term | (t >= ks.episode_limit)
        qpos = torch.where(done[:, None], q_r, qpos)
        qvel = torch.where(done[:, None], v_r, qvel)
        t = torch.where(done, torch.zeros_like(t), t)
        rew = rew + reward
        eps = eps + done.to(torch.int32)
    return qpos, qvel, t, rew, eps
