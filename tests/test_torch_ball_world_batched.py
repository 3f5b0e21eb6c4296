"""A custom robot in a free-ball world through the public batched API of the
PyTorch port vs the JAX package.

The Roller of ``examples/custom_robot.py`` in the SmallBilliard task
(maze scaling 2.0), composed as a user composes it: ``MazeEnvSpec`` then
``BatchedMazeEnv(spec, 8)`` on the CPU, against the JAX package's
``BatchedMazeEnv`` of the same spec (its XLA path on the CPU), stepped
from one state (ball states carried across with
``convert.from_jax_state``, the free ball's 7 coordinates and 6 dofs
among them) on the same actions: obs (width 10, the ball's body origin at
obs[3:6]), reward, terminated, truncated and the info at the generic
kernel's bounds (tests/test_engine_pallas.py: qpos 1e-5, qvel 1e-4,
reward 1e-5); then the auto-reset fold on envs forced to end their
episode: the ball goes back to its qpos0, at rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import BALL_TASK, specs  # noqa: E402

from mujoco_maze_tpu.envs.batched import BatchedMazeEnv as JaxBatched  # noqa: E402

from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import EnvState  # noqa: E402
from mujoco_maze_tpu_torch.ops import engine_kernel, lane_env  # noqa: E402

B = 8


@pytest.fixture(scope="module")
def envs():
    js, ts = specs(BALL_TASK)
    return (JaxBatched(js, B, auto_reset=False),
            BatchedMazeEnv(ts, B, auto_reset=False))


def test_public_step_matches_jax(envs):
    jenv, tenv = envs
    assert isinstance(tenv._kernel_step, lane_env.EngineStep)
    q, v, t = engine_kernel.ball_states(tenv.spec, B, seed=9)
    jst, _ = jenv.reset(jax.random.PRNGKey(2))
    jst = jst._replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                       t=jnp.asarray(t))
    tst = convert.from_jax_state(jst.qpos, jst.qvel, jst.t, device="cpu")
    np.testing.assert_array_equal(tst.qpos.numpy(), q)
    np.testing.assert_array_equal(tst.qvel.numpy(), v)
    rng = np.random.RandomState(4)
    for it in range(3):
        act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        jres = jenv.step(jst, jnp.asarray(act))
        tres = tenv.step(tst, torch.as_tensor(act))
        msg = f"step {it}"
        tobs, jobs = tres.obs.numpy(), np.asarray(jres.obs)
        assert tobs.shape == jobs.shape == (B, 10)
        np.testing.assert_array_equal(tobs[:, 3:6],
                                      tres.state.qpos.numpy()[:, 3:6])
        np.testing.assert_allclose(tobs, jobs, rtol=0, atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(tobs[:, :6], jobs[:, :6], rtol=0,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                                   rtol=0, atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      np.asarray(jres.terminated))
        np.testing.assert_array_equal(tres.truncated.numpy(),
                                      np.asarray(jres.truncated))
        assert sorted(tres.info) == sorted(jres.info)
        # reward_forward is |dxy| / dt: the qpos bound over dt = 0.1
        for key, tol in (("reward_forward", 1e-4), ("reward_ctrl", 1e-7),
                         ("position", 1e-5)):
            np.testing.assert_allclose(tres.info[key].numpy(),
                                       np.asarray(jres.info[key]), rtol=0,
                                       atol=tol, err_msg=f"{msg} {key}")
        jst = jres.state
        tst = convert.from_jax_state(jst.qpos, jst.qvel, jst.t, device="cpu")


def test_auto_reset_fold(envs):
    """Envs whose ball lies on the goal terminate and one at t = 999
    truncates: they take the reset draw of the env's own generator (the
    ball back at qpos0 with the unit quaternion, at rest; t = 0), the
    others keep their step."""
    spec = envs[1].spec
    env = BatchedMazeEnv(spec, B)
    free = envs[1]
    state, _ = env.reset(3)
    goal = spec.heads.goals.pos[0]
    qpos = state.qpos.clone()
    qpos[:3, 3] = goal[0]
    qpos[:3, 4] = goal[1]
    t = torch.zeros(B, dtype=torch.int32)
    t[4] = 999
    state = EnvState(qpos=qpos, qvel=state.qvel, t=t)
    act = torch.zeros(B, 2)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(env.generator.get_state())
    reset_state, reset_obs = spec.reset(gen, B)
    res = env.step(state, act)
    plain = free.step(state, act)
    done = (plain.terminated | plain.truncated)
    assert done.tolist() == [True] * 3 + [False, True] + [False] * 3
    assert plain.truncated.tolist() == [False] * 4 + [True] + [False] * 3
    for got, r, p in ((res.state.qpos, reset_state.qpos, plain.state.qpos),
                      (res.state.qvel, reset_state.qvel, plain.state.qvel),
                      (res.obs, reset_obs, plain.obs)):
        assert torch.equal(got[done], r[done])
        assert torch.equal(got[~done], p[~done])
    assert torch.equal(res.state.t, torch.where(done, 0, plain.state.t))
    assert torch.equal(res.reward, plain.reward)
    qpos0 = torch.as_tensor(spec.dynamic_model.qpos0[3:], dtype=torch.float32)
    assert torch.equal(res.state.qpos[done][:, 3:],
                       qpos0.expand(int(done.sum()), 7))
    assert not res.state.qvel[done][:, 3:].any()
