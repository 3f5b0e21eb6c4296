"""Batched lockstep contracts of the PyTorch port (tests/test_batched.py's,
on the port): shapes, reset noise, auto-reset on termination, truncation at
1000, the t*0.001 obs channel, single vs batched equality, determinism."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import lane_env, make_fast_step  # noqa: E402


@pytest.fixture(scope="module")
def umaze():
    return mmt.make_batched("PointUMaze-v0", 32, device="cpu")


def test_batched_shapes(umaze):
    state, obs = umaze.reset(0)
    assert obs.shape == (32, 7) and obs.dtype == torch.float32
    assert state.qpos.shape == (32, 3) and state.t.dtype == torch.int32
    res = umaze.step(state, torch.zeros(32, 2))
    assert res.obs.shape == (32, 7)
    assert res.reward.shape == (32,) and res.reward.dtype == torch.float32
    assert res.terminated.shape == (32,) and res.terminated.dtype == torch.bool
    assert res.truncated.shape == (32,)
    assert res.info["position"].shape == (32, 2)


def test_reset_noise(umaze):
    """qpos ~ U(-0.1, 0.1), qvel ~ U(0, 0.1), t = 0, distinct per env."""
    state, obs = umaze.reset(0)
    q, v = state.qpos.numpy(), state.qvel.numpy()
    assert (np.abs(q) <= 0.1).all() and (v >= 0).all() and (v <= 0.1).all()
    assert q.std(axis=0).min() > 0.0 and v.std(axis=0).min() > 0.0
    assert (state.t == 0).all() and (obs[:, 6] == 0).all()


def test_autoreset_on_termination():
    """An env that hits the goal restarts near the origin with t=0."""
    env = mmt.make_batched("PointUMaze-v1", 4, device="cpu")
    state, _ = env.reset(0)
    qpos = state.qpos.clone()
    qpos[0, :2] = torch.tensor([0.0, 8.0])  # the goal of UMaze (0, 2 * scale)
    res = env.step(state._replace(qpos=qpos), torch.zeros(4, 2))
    assert bool(res.terminated[0]) and float(res.reward[0]) == 1.0
    assert int(res.state.t[0]) == 0
    assert abs(float(res.obs[0, 1])) < 0.5
    assert (res.state.t[1:] == 1).all()
    assert not res.terminated[1:].any()


def test_truncation_at_episode_limit(umaze):
    state, _ = umaze.reset(0)
    state = state._replace(t=torch.full((32,), 999, dtype=torch.int32))
    res = umaze.step(state, torch.zeros(32, 2))
    assert res.truncated.all()
    assert (res.state.t == 0).all()  # auto-reset
    state = state._replace(t=torch.full((32,), 998, dtype=torch.int32))
    assert not umaze.step(state, torch.zeros(32, 2)).truncated.any()


def test_rollout_time_channel(umaze):
    state, _ = umaze.reset(0)
    gen = torch.Generator().manual_seed(1)
    final, (obs, rew, term) = umaze.rollout(state, umaze.random_policy(), 12, gen)
    assert obs.shape == (12, 32, 7) and rew.shape == (12, 32)
    assert term.shape == (12, 32)
    assert int(final.t.max()) <= 12
    np.testing.assert_allclose(obs[:5, 0, -1].numpy(), np.arange(1, 6) * 0.001,
                               atol=1e-6)


def test_rollout_metrics(umaze):
    state, _ = umaze.reset(0)
    gen = torch.Generator().manual_seed(1)
    final, rew_sum, eps = umaze.rollout_metrics(state, umaze.random_policy(), 12, gen)
    state, _ = umaze.reset(0)
    gen = torch.Generator().manual_seed(1)
    _, (_, rew, term) = umaze.rollout(state, umaze.random_policy(), 12, gen)
    assert float(rew_sum) < 0.0  # dist reward
    np.testing.assert_allclose(float(rew_sum), float(rew.sum()), rtol=1e-5)
    assert int(eps) == int(term.sum())


def test_single_vs_batched_equivalence():
    """A batch of 1 matches the spec's reset/step on the same generator."""
    spec = mmt.make_spec("PointUMaze-v0", device="cpu")
    batch = mmt.make_batched("PointUMaze-v0", 1, auto_reset=False, device="cpu")
    s1, o1 = spec.reset(torch.Generator().manual_seed(7), 1)
    sb, ob = batch.reset(7)
    torch.testing.assert_close(o1, ob, rtol=0, atol=0)
    a = torch.tensor([[0.3, -0.1]])
    r1, rb = spec.step(s1, a), batch.step(sb, a)
    torch.testing.assert_close(r1.obs, rb.obs, rtol=0, atol=0)
    torch.testing.assert_close(r1.reward, rb.reward, rtol=0, atol=0)


def test_same_seed_same_trajectory():
    def run():
        env = mmt.make_batched("Point4Rooms-v2", 16, device="cpu")
        state, obs = env.reset(3)
        gen = torch.Generator().manual_seed(4)
        policy = env.random_policy()
        for _ in range(15):
            res = env.step(state, policy(obs, gen))
            state, obs = res.state, res.obs
        return obs

    torch.testing.assert_close(run(), run(), rtol=0, atol=0)


def test_step_wrapper_checks_and_cpu_path(umaze):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; malformed inputs are refused before any launch."""
    step = make_fast_step(umaze)
    state, _ = umaze.reset(0)
    before = dict(lane_env.LAUNCHES)
    q, v, t, r, m = step(state.qpos, state.qvel, state.t, torch.zeros(32, 2))
    assert lane_env.LAUNCHES == before
    assert q.shape == (32, 3) and m.dtype == torch.bool
    with pytest.raises(TypeError):
        step(state.qpos.double(), state.qvel, state.t, torch.zeros(32, 2))
    with pytest.raises(ValueError):
        step(state.qpos[:16], state.qvel, state.t, torch.zeros(32, 2))
    with pytest.raises(ValueError):
        step(state.qpos.t().contiguous().t(), state.qvel, state.t, torch.zeros(32, 2))
    with pytest.raises(ValueError):
        step(state.qpos.to("meta"), state.qvel, state.t, torch.zeros(32, 2))


def test_object_worlds_and_other_robots_are_queued():
    for env_id in ("PointPush-v0", "AntSmallBilliard-v0", "SwimmerUMaze-v0"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mmt.make_batched(env_id, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="float64"):
        mmt.make_spec("PointUMaze-v0", dtype=torch.float64, device="cpu")
