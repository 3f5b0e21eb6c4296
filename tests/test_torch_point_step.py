"""The port's Point step vs the JAX package's XLA step (``spec.step``).

On PointUMaze-v0 (dist reward), PointUMaze-v1 (goal reward) and
Point4Rooms-v2 (3 goals, first hit wins): qpos (ori modulo 2*pi), qvel,
reward and obs at atol 1e-4 — the bound tests/test_pallas.py holds the
Pallas kernel to against the XLA path — and terminated exactly.

Teacher-forced: every step of the port starts from the JAX state, so one
knife-edge wall hit cannot snowball.  One short free-running check too.
On the CPU the port's step goes through the step kernel's wrapper, which
runs the kernel's plain version (``point_kernel.point_step_plain``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402

IDS = ["PointUMaze-v0", "PointUMaze-v1", "Point4Rooms-v2"]
ATOL = 1e-4
B = 64
STEPS = 20


@pytest.fixture(scope="module", params=IDS)
def envs(request):
    jenv = jmmt.make_batched(request.param, B, auto_reset=False, fast_step=False)
    tenv = tmmt.make_batched(request.param, B, auto_reset=False, device="cpu")
    return jenv, tenv


def _actions(rng):
    return (rng.uniform(-1, 1, (B, 2)) * [1.0, 0.25]).astype(np.float32)


def _assert_close(tres, jres):
    jq, tq = np.asarray(jres.state.qpos), tres.state.qpos.numpy()
    np.testing.assert_allclose(tq[:, :2], jq[:, :2], atol=ATOL)
    dori = np.remainder(tq[:, 2] - jq[:, 2] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(dori, 0.0, atol=ATOL)
    np.testing.assert_allclose(tres.state.qvel.numpy(),
                               np.asarray(jres.state.qvel), atol=ATOL)
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


def test_step_teacher_forced(envs):
    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    max_speed = 0.0
    for _ in range(STEPS):
        act = _actions(rng)
        jres = jenv.step(jstate, jnp.asarray(act))
        tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                        device="cpu")
        tres = tenv.step(tstate, torch.as_tensor(act))
        _assert_close(tres, jres)
        max_speed = max(max_speed, float(np.abs(np.asarray(jres.state.qvel)).max()))
        jstate = jres.state
    # the walls were hit: contact ejections reach speeds far above the
    # reset noise
    assert max_speed > 1.0


def test_step_free_running(envs):
    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                    device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(8):
        act = _actions(rng)
        jres = jenv.step(jstate, jnp.asarray(act))
        tres = tenv.step(tstate, torch.as_tensor(act))
        _assert_close(tres, jres)
        jstate, tstate = jres.state, tres.state
    back = convert.to_numpy(tstate)
    np.testing.assert_allclose(back["qvel"], np.asarray(jstate.qvel), atol=ATOL)


def test_goal_hit_terminates_and_rewards(envs):
    """An env placed on each goal terminates and takes that goal's reward,
    the first listed goal winning, as on the JAX side."""
    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    goals = np.asarray(jenv.spec.heads.goals.pos)
    qpos = np.array(jstate.qpos)
    for k, g in enumerate(goals):
        qpos[k, :2] = g[:2]
    jstate = jstate._replace(qpos=jnp.asarray(qpos))
    act = np.zeros((B, 2), np.float32)
    jres = jenv.step(jstate, jnp.asarray(act))
    tres = tenv.step(convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                            device="cpu"), torch.as_tensor(act))
    assert np.asarray(jres.terminated)[: len(goals)].all()
    _assert_close(tres, jres)
