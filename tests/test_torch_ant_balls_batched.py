"""The Ant's ball worlds (AntSmallBilliard-v0, -v1, -v2) of the PyTorch
port vs the JAX package: ``rollout_metrics`` of the batched env on the
CPU, from the set-up of ``tests/_torch_ant_balls.py``.

Three steps from the same state on both sides; the JAX policy draws each
step's actions from that step's key of its scan (``jax.random.split(key,
3)``), the port's replays them.  The final qpos and qvel within 5e-4 and
5e-3, t exact, the reward sum within 3 B x 1e-4, the episode count
exact.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_ant_balls import (B, IDS, REWARD_TOL, STEPS,  # noqa: E402
                              assert_state_close, sides)

from mujoco_maze_tpu_torch import convert  # noqa: E402


@pytest.mark.parametrize("env_id", IDS)
def test_rollout_metrics_matches_jax(env_id):
    jenv, tenv, jstate = sides(env_id)
    key = jax.random.PRNGKey(11)

    def jpolicy(obs, k):
        return jax.random.uniform(k, (B, 8), minval=-30.0, maxval=30.0)

    acts = [np.array(jpolicy(None, k)) for k in jax.random.split(key, STEPS)]
    jfinal, jrew, jeps = jenv.rollout_metrics(jstate, jpolicy, STEPS, key)
    replay = iter(acts)

    def tpolicy(obs, gen):
        return torch.as_tensor(next(replay))

    tfinal, trew, teps = tenv.rollout_metrics(
        convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                               device="cpu"),
        tpolicy, STEPS, torch.Generator())
    assert_state_close(tfinal.qpos.numpy(), tfinal.qvel.numpy(), jfinal.qpos,
                       jfinal.qvel, env_id)
    np.testing.assert_array_equal(tfinal.t.numpy(), np.asarray(jfinal.t))
    np.testing.assert_allclose(float(trew), float(jrew), rtol=0,
                               atol=STEPS * B * REWARD_TOL)
    # env 2's ball stays on the goal: it ends an episode at every step
    # (auto-reset off)
    assert int(teps) == int(jeps) == STEPS
