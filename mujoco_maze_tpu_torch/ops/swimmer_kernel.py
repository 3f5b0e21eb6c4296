"""The swimmer step and rollout kernels' data, and their plain PyTorch
versions (the Swimmer and the Reacher, 52 IDs).

``spec_from_env`` is the counterpart of ``mujoco_maze_tpu/ops/
swimmer_pallas.py::spec_from_env``.  Where the Pallas kernel baked the
goals into the program at trace time, the CUDA kernels
(``csrc/swimmer_lane.cu``) take them as a runtime table (``goals (G, 9)``,
as the Point kernels) and the constants in a POD struct
(``lane_env.SwimmerParams``); the link count (2 or 3) and the world dofs
(0 to 2, passed through) are template arguments of one build.

``swimmer_step_plain`` is the env step of the spec (``MazeEnvSpec.step``:
the closed form of ``swimmer_math`` frame_skip times, the inner reward,
the heads), which the step kernel computes in the same float32 order.
``swimmer_rollout_plain`` draws the rollout kernel's Philox4x32-10 stream:
per env and step, words 0-1 the actions (U(±1), as many as the robot
has), then U(±0.1) reset values for every qpos and every qvel, world dofs
included (``swimmer_pallas.py`` ``sample_ctrl`` / ``sample_reset``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..envs.env import EPISODE_LIMIT, EnvState, MazeEnvSpec
from ..models.swimmer import SwimmerRobot
from .philox import philox_words, uniform24
from .point_kernel import Tensors5, goal_table
from .swimmer_math import SwimmerDyn

# Most world dofs the kernels pass through (the census: one block with two
# slides in the 10 swimmer block worlds).
MAX_WORLD_DOFS = 2


class SwimmerKernelSpec(NamedTuple):
    """Device tables + constants of one swimmer-family maze (names as in
    the Pallas ``SwimmerEnvKernelSpec``)."""

    env_spec: MazeEnvSpec   # the plain versions step through it
    dyn: SwimmerDyn
    goals: torch.Tensor     # (G, 9) float32 on the spec's device
    reward_type: str        # "dist" | "goal" | "none"
    penalty: float
    scale: float
    inner_scale: float
    frame_skip: int
    episode_limit: int
    n_world: int            # pass-through world dofs (block slides)


def spec_from_env(spec: MazeEnvSpec) -> SwimmerKernelSpec:
    """Lower a Swimmer or Reacher :class:`MazeEnvSpec` to kernel tables."""
    robot = spec.robot
    if robot.NAME not in ("Swimmer", "Reacher"):
        raise NotImplementedError("the swimmer kernels take the Swimmer and "
                                  "the Reacher only")
    # the heads read the robot's position (no swimmer task puts them on an
    # object), and the world layout has one qpos per dof
    if spec.task.OBS_OFFSET != 0:
        raise NotImplementedError("the swimmer kernels' heads read the robot")
    if spec.nq != spec.nv:
        raise ValueError("the swimmer kernels take one qpos per world dof")
    # the rollout kernel draws a reset as the noise alone (swimmer_pallas.py
    # sample_reset); that equals spec.reset only for a zero initial state
    if np.any(spec.init_qpos != 0.0) or np.any(spec.init_qvel != 0.0):
        raise ValueError("the swimmer kernels assume a zero initial state")
    n_world = spec.nq - robot.nq
    if n_world > MAX_WORLD_DOFS:
        raise NotImplementedError(
            f"{n_world} world dofs exceed the swimmer kernels' {MAX_WORLD_DOFS}")
    task = spec.task
    return SwimmerKernelSpec(
        env_spec=spec,
        dyn=robot.dyn,
        goals=goal_table(spec),
        reward_type=task.REWARD_TYPE,
        penalty=float(task.PENALTY or 0.0),
        scale=float(task.scale),
        inner_scale=float(spec.inner_reward_scaling),
        frame_skip=int(robot.frame_skip),
        episode_limit=EPISODE_LIMIT,
        n_world=n_world,
    )


def swimmer_step_plain(ks: SwimmerKernelSpec, qpos: torch.Tensor,
                       qvel: torch.Tensor, t: torch.Tensor,
                       actions: torch.Tensor) -> Tensors5:
    """``(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one step, no reset — what the step kernel computes."""
    res = ks.env_spec.step(EnvState(qpos=qpos, qvel=qvel, t=t), actions)
    return (res.state.qpos, res.state.qvel, res.state.t, res.reward,
            res.terminated)


def rollout_draws(env_index: torch.Tensor, step: int, seed: int,
                  n_act: int, nq: int):
    """The actions ``(B, n_act)`` and the reset ``qpos``, ``qvel`` ``(B,
    nq)`` an env draws at one rollout step: words 0-1 (actions; the
    Reacher uses word 0), 2 .. 2 + nq (qpos) and 2 + nq .. 2 + 2 nq (qvel)
    of counter ``(env, step, block, 0)``, key ``(seed, 0)``."""
    n_words = 2 + 2 * nq
    words = philox_words(env_index, step, seed, range((n_words + 3) // 4))
    act = torch.stack([uniform24(words[a], -1.0, 1.0) for a in range(n_act)],
                      dim=1)
    lo, hi = SwimmerRobot.RESET_NOISE
    q_r = torch.stack([uniform24(w, lo, hi) for w in words[2:2 + nq]], dim=1)
    v_r = torch.stack([uniform24(w, lo, hi) for w in words[2 + nq:2 + 2 * nq]],
                      dim=1)
    return act, q_r, v_r


def swimmer_rollout_plain(ks: SwimmerKernelSpec, qpos: torch.Tensor,
                          qvel: torch.Tensor, t: torch.Tensor, seed: int,
                          num_steps: int) -> Tensors5:
    """Plain version of the rollout kernel: ``num_steps`` random-policy
    steps with branch-free auto-reset.  Returns the final ``(qpos, qvel,
    t)`` and the per-env reward sums ``(B,)`` float32 and episode counts
    ``(B,)`` int32."""
    B, nq = qpos.shape
    env_index = torch.arange(B, dtype=torch.int64, device=qpos.device)
    rew = torch.zeros(B, dtype=torch.float32, device=qpos.device)
    eps = torch.zeros(B, dtype=torch.int32, device=qpos.device)
    for step in range(num_steps):
        act, q_r, v_r = rollout_draws(env_index, step, seed, ks.dyn.n_act, nq)
        qpos, qvel, t, reward, term = swimmer_step_plain(ks, qpos, qvel, t, act)
        done = term | (t >= ks.episode_limit)
        qpos = torch.where(done[:, None], q_r, qpos)
        qvel = torch.where(done[:, None], v_r, qvel)
        t = torch.where(done, torch.zeros_like(t), t)
        rew = rew + reward
        eps = eps + done.to(torch.int32)
    return qpos, qvel, t, rew, eps

