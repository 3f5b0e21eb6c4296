"""The custom robot through the public batched API of the PyTorch port vs
the JAX package.

``make_roller_umaze(8, device="cpu")`` (the port's
``examples/custom_robot.py``) against the JAX package's
``make_roller_umaze(8)`` (its XLA path on the CPU), stepped from one
state (the JAX reset, carried across with ``convert.from_jax_state``) on
the same actions: obs (width 7), reward, terminated, truncated and info at
the generic kernel's bounds (tests/test_engine_pallas.py: qpos 1e-5,
qvel 1e-4, reward 1e-5); then the auto-reset fold on envs forced to end
their episode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import jax_custom  # noqa: E402

from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import EnvState  # noqa: E402
from mujoco_maze_tpu_torch.examples.custom_robot import make_roller_umaze  # noqa: E402

B = 8


@pytest.fixture(scope="module")
def envs():
    return (jax_custom.make_roller_umaze(num_envs=B, auto_reset=False),
            make_roller_umaze(B, device="cpu", auto_reset=False))


def test_public_step_matches_jax(envs):
    jenv, tenv = envs
    jst, jobs = jenv.reset(jax.random.PRNGKey(2))
    tst = convert.from_jax_state(jst.qpos, jst.qvel, jst.t, device="cpu")
    np.testing.assert_allclose(tenv.spec._observe(tst).numpy(),
                               np.asarray(jobs), rtol=0, atol=0)
    rng = np.random.RandomState(4)
    for it in range(3):
        act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        jres = jenv.step(jst, jnp.asarray(act))
        tres = tenv.step(tst, torch.as_tensor(act))
        msg = f"step {it}"
        assert tuple(tres.obs.shape) == (B, 7)
        np.testing.assert_allclose(tres.obs.numpy(), np.asarray(jres.obs),
                                   rtol=0, atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(tres.obs.numpy()[:, :3],
                                   np.asarray(jres.obs)[:, :3], rtol=0,
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


def test_auto_reset_fold():
    """Envs at the goal terminate and one at t = 999 truncates: they take
    the reset draw of the env's own generator (at t = 0), the others keep
    their step."""
    env = make_roller_umaze(B, device="cpu")
    free = make_roller_umaze(B, device="cpu", auto_reset=False)
    state, _ = env.reset(3)
    goal = env.spec.heads.goals.pos[0]
    qpos = state.qpos.clone()
    qpos[:3, 0] = goal[0]
    qpos[:3, 1] = goal[1]
    t = torch.zeros(B, dtype=torch.int32)
    t[4] = 999
    state = EnvState(qpos=qpos, qvel=state.qvel, t=t)
    act = torch.zeros(B, 2)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(env.generator.get_state())
    reset_state, reset_obs = env.spec.reset(gen, B)
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
