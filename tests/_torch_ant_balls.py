"""Shared set-up of the Ant ball worlds' JAX comparisons
(``tests/test_torch_ant_balls_step.py`` and ``_batched.py``): both
packages' batched envs of one AntSmallBilliard ID at B = 8 on the CPU
(the JAX one on its XLA step, ``fast_step=False``; auto-reset off on
both), and a start state from the JAX reset with the ball's sphere
against the torso's in envs 0 and 1 (its centre 0.63 from the torso's,
the two radii summing to 0.65) and the ball's body origin, which the heads
read, on the goal in env 2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import mujoco_maze_tpu as jmmt

import mujoco_maze_tpu_torch as tmmt

IDS = ["AntSmallBilliard-v0", "AntSmallBilliard-v1", "AntSmallBilliard-v2"]
B = 8
STEPS = 3
QPOS_TOL, QVEL_TOL, REWARD_TOL = 5e-4, 5e-3, 1e-4


@functools.lru_cache(maxsize=None)
def sides(env_id):
    """``(jax env, port env, jax start state)`` of ``env_id``."""
    jenv = jmmt.make_batched(env_id, B, auto_reset=False, fast_step=False)
    tenv = tmmt.make_batched(env_id, B, auto_reset=False, device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    q = np.asarray(jstate.qpos).copy()
    for e, ang in ((0, 0.3), (1, 2.2)):
        q[e, 15:17] = q[e, :2] + 0.63 * np.array([np.cos(ang), np.sin(ang)])
        q[e, 17] = q[e, 2] - 0.4
    q[2, 15:17] = np.asarray(jenv.spec.heads.goals.pos)[0, :2]
    return jenv, tenv, jstate._replace(qpos=jnp.asarray(q))


def assert_state_close(tq, tv, jq, jv, msg):
    np.testing.assert_allclose(tq, np.asarray(jq), rtol=0, atol=QPOS_TOL,
                               err_msg=msg)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=QVEL_TOL,
                               err_msg=msg)
