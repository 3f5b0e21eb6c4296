"""The Ant's ball worlds (AntSmallBilliard-v0, -v1, -v2: the dist, goal
and no-reward heads) of the PyTorch port vs the JAX package: the batched
env's step on the CPU.

The port's ``make_batched(id, 8, device="cpu")`` steps through the Ant
step wrapper, whose plain version on the CPU is the batched engine (what
the CUDA ``ant_balls_step`` kernel is held to on the card); the JAX
reference is ``make_batched(id, 8, fast_step=False)``, its XLA step,
compiled once per ID (``tests/_torch_ant_balls.py``: auto-reset off, the
ball against the ant in two envs and on the goal in one).  Three steps of
seeded actions, teacher-forced: qpos 5e-4, qvel 5e-3, reward 1e-4, t and
terminated exact, the observation 33 wide with the ball's body origin at
obs[3:6] (the Ant bounds of tests/test_torch_ant_step.py); the ball on
the goal ends the episode under every head.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_ant_balls import (B, IDS, QPOS_TOL, QVEL_TOL,  # noqa: E402
                              REWARD_TOL, STEPS, assert_state_close, sides)

from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import lane_env, make_fast_step  # noqa: E402


@pytest.mark.parametrize("env_id", IDS)
def test_step_matches_jax(env_id):
    jenv, tenv, jstate = sides(env_id)
    assert isinstance(make_fast_step(tenv), lane_env.AntStep)
    rng = np.random.RandomState(len(env_id))
    for k in range(STEPS):
        act = rng.uniform(-30, 30, (B, 8)).astype(np.float32)
        jres = jenv.step(jstate, jnp.asarray(act))
        tres = tenv.step(convert.from_jax_state(
            jstate.qpos, jstate.qvel, jstate.t, device="cpu"),
            torch.as_tensor(act))
        msg = f"{env_id} step {k}"
        assert_state_close(tres.state.qpos.numpy(), tres.state.qvel.numpy(),
                           jres.state.qpos, jres.state.qvel, msg)
        np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                                   rtol=0, atol=REWARD_TOL, err_msg=msg)
        np.testing.assert_array_equal(tres.state.t.numpy(),
                                      np.asarray(jres.state.t))
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      np.asarray(jres.terminated))
        tobs, jobs = tres.obs.numpy(), np.asarray(jres.obs)
        assert tobs.shape == jobs.shape == (B, 33)
        np.testing.assert_array_equal(tobs[:, 3:6],
                                      tres.state.qpos.numpy()[:, 15:18])
        np.testing.assert_allclose(tobs[:, :18], jobs[:, :18], rtol=0,
                                   atol=QPOS_TOL, err_msg=msg)
        np.testing.assert_allclose(tobs, jobs, rtol=0, atol=QVEL_TOL,
                                   err_msg=msg)
        if k == 0:
            assert bool(tres.terminated[2])   # the ball on the goal
        jstate = jres.state
