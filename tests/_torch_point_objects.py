"""Shared by ``test_torch_point_objects_step_*.py``: the port's Point step in
an object world vs the JAX package's XLA step (``make_batched(...,
fast_step=False)``, whose object physics is the monolith
``point_world.rk4_object_step``), teacher-forced.

Each file builds a few IDs (the JAX step compiles in 30-55 s per ID on
the CPU, so the IDs are spread over two files).  From the JAX reset states
and from ``point_kernel.object_states`` (the robot within reach of the
objects, moving at them; blocks at their travel limits; the Fall block
perched or at the floor), a few steps with random actions: every step of
the port starts from the JAX state.  qpos (the heading modulo 2 pi), qvel,
obs and reward within 1e-4, the bound tests/test_pallas.py holds the JAX
Pallas kernel to against the XLA step; t, terminated and truncated
exactly.  On the CPU the port's step runs the step kernel's plain version
(``point_kernel.point_step_plain``, the object part ``ops/object_lanes``).

One exception, from the contact states only: the objects' velocities are
held within 2e-3.  The port's object solve is the JAX package's lane form
(``ops/object_lanes``, 6 Newton steps), and the XLA step runs the
monolith (10 Newton steps); the JAX package holds its two forms to each
other at v 2e-3 (tests/test_object_lanes.py).  Where three blocks press
on each other and on the robot the two forms differ by up to ~2e-3 in an
object's velocity while the JAX lane form and the port agree to ~2e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mujoco_maze_tpu as jmmt

import mujoco_maze_tpu_torch as tmmt
from mujoco_maze_tpu_torch import convert
from mujoco_maze_tpu_torch.ops import point_kernel

ATOL = 1e-4
OBJ_VEL_ATOL = 2e-3   # lane form vs monolith (tests/test_object_lanes.py)
B = 8
STEPS = 4


def make_envs(env_id):
    jenv = jmmt.make_batched(env_id, B, auto_reset=False, fast_step=False)
    tenv = tmmt.make_batched(env_id, B, auto_reset=False, device="cpu")
    return jenv, tenv


def assert_close(tres, jres, n_robot, obj_vel_atol):
    jq, tq = np.asarray(jres.state.qpos), tres.state.qpos.numpy()
    np.testing.assert_allclose(np.delete(tq, 2, axis=1),
                               np.delete(jq, 2, axis=1), atol=ATOL)
    dori = np.remainder(tq[:, 2] - jq[:, 2] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(dori, 0.0, atol=ATOL)
    tv, jv = tres.state.qvel.numpy(), np.asarray(jres.state.qvel)
    np.testing.assert_allclose(tv[:, :n_robot], jv[:, :n_robot], atol=ATOL)
    np.testing.assert_allclose(tv[:, n_robot:], jv[:, n_robot:],
                               atol=obj_vel_atol)
    np.testing.assert_array_equal(tres.state.t.numpy(), np.asarray(jres.state.t))
    np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                               atol=ATOL)
    np.testing.assert_array_equal(tres.terminated.numpy(),
                                  np.asarray(jres.terminated))
    np.testing.assert_array_equal(tres.truncated.numpy(),
                                  np.asarray(jres.truncated))
    tobs, jobs = tres.obs.numpy(), np.asarray(jres.obs)
    np.testing.assert_allclose(np.delete(tobs, 2, axis=1),
                               np.delete(jobs, 2, axis=1), atol=ATOL)


def teacher_forced(jenv, tenv, jstate, seed, obj_vel_atol=ATOL):
    """STEPS teacher-forced steps from ``jstate``; returns the largest
    object speed the JAX step reached (objects were moved)."""
    rng = np.random.RandomState(seed)
    n_robot = tenv.spec.robot.nq
    moved = 0.0
    for _ in range(STEPS):
        act = (rng.uniform(-1, 1, (B, 2)) * [1.0, 0.25]).astype(np.float32)
        jres = jenv.step(jstate, jnp.asarray(act))
        tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                        device="cpu")
        tres = tenv.step(tstate, torch.as_tensor(act))
        assert_close(tres, jres, n_robot, obj_vel_atol)
        moved = max(moved, float(np.abs(np.asarray(
            jres.state.qvel)[:, n_robot:]).max()))
        jstate = jres.state
    return moved


def contact_state(jenv, tenv, seed):
    """A JAX batched state at ``point_kernel.object_states``."""
    qpos, qvel, t = point_kernel.object_states(tenv.spec, B, seed)
    jstate, _ = jenv.reset(jax.random.PRNGKey(seed))
    return jstate._replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                           t=jnp.asarray(t))
