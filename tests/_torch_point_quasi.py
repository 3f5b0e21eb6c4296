"""Shared by the ``test_torch_point_quasi_*.py`` files: a Point robot
without the object solve, in both packages.

``QuasiPoint`` is the port's ``PointRobot`` with ``USES_POINT_WORLD =
False`` and nothing else changed; ``JaxQuasiPoint`` is the JAX package's.
Neither package has such a class: users who define their own
manual-collision Point robot through the extension API send this traffic.
In the object worlds such a robot keeps the quasi-static push and the
kick/roll/bounce ball (JAX ``envs/env.py:1079-1088``), and the Point
kernels run their quasi-static rows (``point_pallas._push_blocks_lanes``,
``_step_balls_lanes``; the port's ``csrc/point_lane.cu``).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import torch

from mujoco_maze_tpu import registry as jreg
from mujoco_maze_tpu.envs.env import MazeEnvSpec as JaxSpec
from mujoco_maze_tpu.models.point import PointRobot as JaxPointRobot

from mujoco_maze_tpu_torch import convert
from mujoco_maze_tpu_torch import registry as treg
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec
from mujoco_maze_tpu_torch.models.point import PointRobot

# the five worlds of the quasi-static rows: one block, three blocks (pair
# separation), the Fall block (z slide; the push moves x/y only), the
# heads on the block, the ball with the heads on it
WORLDS = ("PointPush-v0", "PointMultiPushSmall-v0", "PointFall-v0",
          "PointBlockCarry-v0", "PointBilliard-v0")
ATOL = 1e-4     # the JAX package's kernel-vs-XLA bound (tests/test_pallas.py)


class QuasiPoint(PointRobot):
    USES_POINT_WORLD = False


class JaxQuasiPoint(JaxPointRobot):
    USES_POINT_WORLD = False


def specs(env_id: str):
    """``(jax_spec, port_spec)`` of ``env_id`` with the quasi robot, on the
    CPU."""
    e = treg.entry(env_id)
    jspec = JaxSpec(JaxQuasiPoint(), jreg.entry(env_id).task_cls,
                    e.maze_size_scaling,
                    inner_reward_scaling=e.inner_reward_scaling)
    tspec = MazeEnvSpec(QuasiPoint(), e.task_cls, e.maze_size_scaling,
                        inner_reward_scaling=e.inner_reward_scaling,
                        device="cpu")
    return jspec, tspec


def jax_state(jspec, qpos, qvel, t):
    """A batched JAX ``EnvState`` of numpy arrays (keys unused by step)."""
    import jax

    s0, _ = jspec.reset(jax.random.PRNGKey(0))
    n = len(t)
    return s0._replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                       t=jnp.asarray(t),
                       key=jnp.broadcast_to(s0.key, (n,) + s0.key.shape))


def port_state(qpos, qvel, t):
    return convert.from_jax_state(np.asarray(qpos), np.asarray(qvel),
                                  np.asarray(t), device="cpu")


def assert_step_close(tres, jres, atol=ATOL):
    """qpos (the heading modulo 2 pi), qvel and reward within ``atol``; t
    and terminated exactly."""
    jq, tq = np.asarray(jres.state.qpos), tres.state.qpos.numpy()
    np.testing.assert_allclose(np.delete(tq, 2, 1), np.delete(jq, 2, 1),
                               atol=atol)
    dori = np.remainder(tq[:, 2] - jq[:, 2] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(dori, 0.0, atol=atol)
    np.testing.assert_allclose(tres.state.qvel.numpy(),
                               np.asarray(jres.state.qvel), atol=atol)
    np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                               atol=atol)
    np.testing.assert_array_equal(tres.state.t.numpy(),
                                  np.asarray(jres.state.t))
    np.testing.assert_array_equal(tres.terminated.numpy(),
                                  np.asarray(jres.terminated))


def as_torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module (its functions only: the
    checks run under its ``__main__``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quasi_events(spec, qpos, qvel, actions):
    """Which quasi-static rows one step exercises, per env: the counter
    that ``chip_smoke.py`` prints on the card, read from there."""
    return _chip_smoke().quasi_events(spec, qpos, qvel, actions)
