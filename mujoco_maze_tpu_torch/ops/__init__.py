"""Hand-written CUDA kernels for the hot paths (port of
``mujoco_maze_tpu.ops``).

- :mod:`.point_kernel` — the Point kernels' tables and plain versions
- :mod:`.lane_env`     — their launch wrappers and launch counts
- :mod:`._build`       — one ``nvcc`` call over ``csrc/*.cu``, loaded
  with ``ctypes``

This slice has the Point robot on plain (object-free) mazes; the other
robots' kernels are queued in ROADMAP queue 2.
"""

from __future__ import annotations


def make_fast_step(env):
    """The per-step kernel of a batched env: ``step(qpos, qvel, t, actions)
    -> (qpos, qvel, t, reward, terminated)``, no auto-reset (the caller
    folds resets)."""
    from .lane_env import PointStep
    from .point_kernel import spec_from_env

    return PointStep(spec_from_env(env.spec), env.num_envs)


def make_fast_rollout(env, num_steps: int):
    """The fused random-policy rollout kernel of a batched env:
    ``rollout(qpos, qvel, t, seed) -> (qpos, qvel, t, reward_sum,
    episodes)``."""
    from .lane_env import PointRollout
    from .point_kernel import spec_from_env

    return PointRollout(spec_from_env(env.spec), env.num_envs, num_steps)
