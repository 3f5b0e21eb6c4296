"""The generic engine step of the PyTorch port vs the JAX package: the
Roller of ``examples/custom_robot.py`` in the UMaze, Push and BlockCarry
tasks.

The port's plain version (``engine_kernel.engine_step_plain``, what the
CUDA kernel is held against on the card) against the JAX package's
generic kernel in interpret mode (``engine_pallas.build_step_kernel``) and
its XLA step (``spec.step``), over 3 steps of seeded numpy actions, from
the JAX reset and from contact states (``engine_kernel.sphere_robot_states``:
the roller against wall and block faces, the blocks at and beyond their
travel limits).  Bounds: the JAX package's own kernel-vs-XLA check of this
robot (tests/test_engine_pallas.py): qpos 1e-5, qvel 1e-4, reward 1e-5,
terminated and t exact.  Each JAX kernel is built once per module at
B = 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import actions, jax_state, specs  # noqa: E402

from mujoco_maze_tpu.ops import engine_pallas as ep  # noqa: E402

from mujoco_maze_tpu_torch.envs.env import EnvState  # noqa: E402
from mujoco_maze_tpu_torch.examples.custom_robot import make_roller_umaze  # noqa: E402
from mujoco_maze_tpu_torch.ops import engine_kernel, lane_env  # noqa: E402

B = 8
TOL = {"qpos": 1e-5, "qvel": 1e-4, "reward": 1e-5}
WORLDS = ("GoalRewardUMaze", "GoalRewardPush", "GoalRewardBlockCarry")


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    js, ts = specs(request.param)
    kern = ep.build_step_kernel(ep.spec_from_env(js), B, tile=8)
    return (request.param, js, ts, engine_kernel.spec_from_env(ts), kern,
            jax.jit(jax.vmap(js.step)))


def _compare(world, q, v, t, seed, steps=3):
    """Steps both sides teacher-forced from (q, v, t); returns the
    per-step max errors against the JAX kernel and the XLA path."""
    name, js, ts, ks, kern, xla = world
    rng = np.random.RandomState(seed)
    for it in range(steps):
        a = actions(rng, ts, B)
        pq, pv, pt, pr, pm = (x.numpy() for x in engine_kernel.engine_step_plain(
            ks, torch.as_tensor(q), torch.as_tensor(v), torch.as_tensor(t),
            torch.as_tensor(a)))
        kq, kv, kt, kr, km = (np.asarray(x) for x in kern(
            jnp.asarray(q), jnp.asarray(v), jnp.asarray(t), jnp.asarray(a)))
        res = xla(jax_state(q, v, t), jnp.asarray(a))
        xq, xv, xt, xr, xm = (np.asarray(x) for x in (
            res.state.qpos, res.state.qvel, res.state.t, res.reward,
            res.terminated))
        for ref, (rq, rv, rt, rr, rm) in (("kernel", (kq, kv, kt, kr, km)),
                                          ("xla", (xq, xv, xt, xr, xm))):
            msg = f"{name} step {it} vs the JAX {ref}"
            np.testing.assert_allclose(pq, rq, rtol=0, atol=TOL["qpos"], err_msg=msg)
            np.testing.assert_allclose(pv, rv, rtol=0, atol=TOL["qvel"], err_msg=msg)
            np.testing.assert_allclose(pr, rr, rtol=0, atol=TOL["reward"], err_msg=msg)
            np.testing.assert_array_equal(pt, rt, err_msg=msg)
            np.testing.assert_array_equal(pm, rm, err_msg=msg)
        q, v, t = (np.array(x) for x in (xq, xv, xt))


def test_matches_jax_from_reset(world):
    _, js, _, _, _, _ = world
    st, _ = jax.vmap(js.reset)(jax.random.split(jax.random.PRNGKey(3), B))
    _compare(world, *(np.array(x) for x in (st.qpos, st.qvel, st.t)), seed=0)


def test_matches_jax_from_contact_states(world):
    """From states against walls and blocks: the floor, a wall face and (in
    the block worlds) a block face and a travel limit are all met."""
    name, _, ts, ks, _, _ = world
    q, v, t = engine_kernel.sphere_robot_states(ts, B, seed=5)
    trace = engine_kernel.active_trace(ks, *(torch.as_tensor(x) for x in (
        q, v, np.zeros((B, ks.nu), np.float32))))
    nw = (ks.n_cand + 31) // 32
    active = trace[:, 0, :nw].numpy()
    assert (active & 1).any()                        # the floor
    assert (active & 2).any()                        # a wall: first box pick
    if ts.block_runtimes:
        assert (active >> (ks.n_cand - 1) & 1).any()  # the block pair
        lo_hi = [ts.dynamic_model.jnt_range[j] for j in range(3, 5)]
        at_limit = [(np.abs(q[:, j] - lo) < 1e-6) | (np.abs(q[:, j] - hi) < 1e-6)
                    for j, (lo, hi) in zip(range(3, 5), lo_hi)]
        assert np.any(at_limit)
    _compare(world, q, v, t, seed=6)


def test_wrapper_on_cpu_is_the_plain_version(world):
    _, _, ts, ks, _, _ = world
    step = lane_env.EngineStep(ks, B)
    q, v, t = (torch.as_tensor(x) for x in
               engine_kernel.sphere_robot_states(ts, B, seed=7))
    a = torch.as_tensor(actions(np.random.RandomState(7), ts, B))
    for x, y in zip(step(q, v, t, a), engine_kernel.engine_step_plain(ks, q, v, t, a)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="kernel"):
        step(q, v, t, a, trace=True)
    with pytest.raises(TypeError):
        step(q.double(), v, t, a)
    with pytest.raises(ValueError, match="shape"):
        step(q[:, :2], v, t, a)


def test_custom_robot_runs_on_engine():
    """The counterpart of the JAX package's test_custom_robot_runs_on_engine:
    the roller falls onto the floor and settles there."""
    env = make_roller_umaze(num_envs=B, device="cpu", auto_reset=False)
    state, obs = env.reset(0)
    assert tuple(obs.shape) == (B, 7)   # 6 robot + the time channel
    for _ in range(6):
        state = env.step(state, torch.zeros(B, 2)).state
    z = state.qpos[:, 2].numpy() + 0.75
    assert (z < 0.7).all() and (z > 0.2).all()
    assert isinstance(state, EnvState)
