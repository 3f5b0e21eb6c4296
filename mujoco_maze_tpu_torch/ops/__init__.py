"""Hand-written CUDA kernels for the hot paths (port of
``mujoco_maze_tpu.ops``).

- :mod:`.point_kernel`   — the Point kernels' tables and plain versions
- :mod:`.object_lanes`   — the Point object worlds' reduced object solve
  (the plain version of the object part of the Point kernels)
- :mod:`.ant_kernel`     — the Ant kernels' tables and plain versions
- :mod:`.swimmer_kernel` — the swimmer kernels' tables and plain versions
  (the Swimmer and the Reacher), over :mod:`.swimmer_math`, the
  closed-form planar dynamics
- :mod:`.lane_env`       — their launch wrappers and launch counts
- :mod:`.philox`         — the rollout kernels' random stream, in torch
- :mod:`._build`         — one ``nvcc`` per ``csrc/*.cu``, linked into one
  library loaded with ``ctypes``

The port has the Point robot on object-free mazes and in its object
worlds, and the Ant, the Swimmer and the Reacher on object-free mazes and
in the block worlds; the Ant object balls' kernel is queued in ROADMAP
queue 2.
"""

from __future__ import annotations

def _kernel(env, which: int):
    """(kernel data, step or rollout wrapper class) of the env's robot, as
    the JAX package's ``_KERNEL_MODULES`` dispatches by robot."""
    from . import ant_kernel, lane_env, point_kernel, swimmer_kernel

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
    name = env.spec.robot.NAME
    if name not in kernels:
        raise NotImplementedError(
            f"no kernel for the {name} robot yet (ROADMAP queue 2)")
    lower, step, rollout = kernels[name]
    return lower(env.spec), (step, rollout)[which]


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
