"""Hand-written CUDA kernels for the hot paths (port of
``mujoco_maze_tpu.ops``).

- :mod:`.point_kernel`   — the Point kernels' tables and plain versions
- :mod:`.object_lanes`   — the Point object worlds' reduced object solve
  (the plain version of the object part of the Point kernels)
- :mod:`.ant_kernel`     — the Ant kernels' tables and plain versions
- :mod:`.swimmer_kernel` — the swimmer kernels' tables and plain versions
  (the Swimmer and the Reacher), over :mod:`.swimmer_math`, the
  closed-form planar dynamics
- :mod:`.engine_kernel`  — the generic engine step kernel's tables and
  plain version: any other robot with ``USES_WORLD_ENGINE`` (custom robots
  composed through the extension API), free object balls included
- :mod:`.lane_env`       — their launch wrappers and launch counts
- :mod:`.philox`         — the rollout kernels' random stream, in torch
- :mod:`._build`         — one ``nvcc`` per ``csrc/*.cu``, linked into one
  library loaded with ``ctypes``

The port has the Point robot on object-free mazes and in its object
worlds, the Ant on object-free mazes, in the block worlds and with a free
object ball, the Swimmer and the Reacher on object-free mazes and in the
block worlds, and custom engine-world robots through the generic kernel,
in ball worlds too.  The Point kernels cover the object worlds in both of
the JAX package's models: the reduced object solve, and, for a Point
robot without ``USES_POINT_WORLD``, the quasi-static block push and
kick/roll/bounce ball.  The kernels are float32: a float64 spec (the
Point fidelity path) has none, and steps through ``MazeEnvSpec.step``.
"""

from __future__ import annotations

import torch


def _kernel(env, which: int):
    """(kernel data, step or rollout wrapper class) of the env's robot, as
    the JAX package's ``_KERNEL_MODULES`` dispatches by robot; any other
    robot with ``USES_WORLD_ENGINE`` goes to the generic engine kernel
    (JAX ``ops/__init__.py:100-107``)."""
    from . import (ant_kernel, engine_kernel, lane_env, point_kernel,
                   swimmer_kernel)

    swimmer = (swimmer_kernel.spec_from_env, lane_env.SwimmerStep,
               lane_env.SwimmerRollout)
    kernels = {
        "Point": (point_kernel.spec_from_env, lane_env.PointStep,
                  lane_env.PointRollout),
        "Ant": (ant_kernel.spec_from_env, lane_env.AntStep,
                lane_env.AntRollout),
        # one kernel serves both, as the JAX package routes both to
        # swimmer_pallas
        "Swimmer": swimmer,
        "Reacher": swimmer,
    }
    robot = env.spec.robot
    if env.spec.dtype != torch.float32:
        raise NotImplementedError(
            "the kernels are float32; a float64 spec steps through "
            "MazeEnvSpec.step (BatchedMazeEnv does so by its dtype)")
    if robot.NAME in kernels:
        lower, step, rollout = kernels[robot.NAME]
        return lower(env.spec), (step, rollout)[which]
    if not getattr(robot, "USES_WORLD_ENGINE", False):
        raise NotImplementedError(
            f"no kernel for the {robot.NAME} robot: it is neither a known "
            "robot nor an engine-world robot")
    if which == 1:
        raise NotImplementedError(
            "the generic engine kernel is step-only, as in the JAX package "
            "(engine_pallas.py:176-179): roll a custom robot out through "
            "BatchedMazeEnv.rollout or rollout_metrics")
    return engine_kernel.spec_from_env(env.spec), lane_env.EngineStep


def make_fast_step(env):
    """The per-step kernel of a batched env: ``step(qpos, qvel, t, actions)
    -> (qpos, qvel, t, reward, terminated)``, no auto-reset (the caller
    folds resets)."""
    ks, wrapper = _kernel(env, 0)
    return wrapper(ks, env.num_envs)


def make_fast_rollout(env, num_steps: int):
    """The fused random-policy rollout kernel of a batched env:
    ``rollout(qpos, qvel, t, seed) -> (qpos, qvel, t, reward_sum,
    episodes)``."""
    ks, wrapper = _kernel(env, 1)
    return wrapper(ks, env.num_envs, num_steps)
