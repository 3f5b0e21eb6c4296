"""Batched lockstep contracts of the port on an Ant maze, on the CPU, and
the Ant rollout kernel's random stream (its plain version draws the same
Philox4x32-10 words as the CUDA kernel).

tests/test_torch_batched.py's contracts for AntUMaze-v0/-v1: shapes and
dtypes, the reset law, auto-reset on termination and at the episode
limit, ``rollout`` vs ``rollout_metrics``; the step and rollout wrappers'
CPU paths and input checks; the rollout's ctrl and reset draws and their
laws, and that they are the Point rollout's words for the same (seed,
env, step, block).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,  # noqa: E402
                                       make_fast_step)
from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,  # noqa: E402
                                                  rollout_ctrl, rollout_reset)
from mujoco_maze_tpu_torch.ops.philox import philox_words, uniform24  # noqa: E402
from mujoco_maze_tpu_torch.ops.point_kernel import rollout_draws  # noqa: E402

B = 8


@pytest.fixture(scope="module")
def umaze():
    return mmt.make_batched("AntUMaze-v0", B, device="cpu")


def test_batched_shapes(umaze):
    state, obs = umaze.reset(0)
    assert obs.shape == (B, 30) and obs.dtype == torch.float32
    assert state.qpos.shape == (B, 15) and state.qvel.shape == (B, 14)
    assert state.t.dtype == torch.int32
    res = umaze.step(state, torch.zeros(B, 8))
    assert res.obs.shape == (B, 30) and torch.isfinite(res.obs).all()
    assert res.reward.shape == (B,) and res.reward.dtype == torch.float32
    assert res.terminated.shape == (B,) and res.terminated.dtype == torch.bool
    assert res.truncated.shape == (B,)
    assert res.info["position"].shape == (B, 2)
    assert res.info["reward_forward"].shape == (B,)
    assert res.info["reward_ctrl"].shape == (B,)
    assert (res.obs[:, -1] == 0.001).all()


def test_reset_law():
    """qpos0 + U(±0.1) on all 15 coordinates (the JAX reset leaves the
    quaternion as drawn), qvel ~ N(0, 0.1), t = 0."""
    spec = mmt.make_spec("AntUMaze-v0", device="cpu")
    state, obs = spec.reset(torch.Generator().manual_seed(3), 4096)
    dq = (state.qpos - torch.as_tensor(spec.init_qpos, dtype=torch.float32)).numpy()
    v = state.qvel.numpy()
    assert np.abs(dq).max() <= 0.1
    np.testing.assert_allclose(dq.mean(0), 0.0, atol=0.005)
    np.testing.assert_allclose(dq.std(0), 0.1 / np.sqrt(3), rtol=0.05)
    np.testing.assert_allclose(v.mean(0), 0.0, atol=0.01)
    np.testing.assert_allclose(v.std(0), 0.1, rtol=0.05)
    assert (state.t == 0).all() and (obs[:, -1] == 0).all()
    assert spec.init_qpos[2] == 0.75 and spec.init_qpos[3] == 1.0


def test_autoreset_on_termination():
    """An ant on the goal of AntUMaze-v1 terminates, takes the goal reward
    (plus the scaled inner reward) and restarts at the origin with t = 0."""
    env = mmt.make_batched("AntUMaze-v1", 4, device="cpu")
    state, _ = env.reset(0)
    qpos = state.qpos.clone()
    qpos[0, :2] = torch.tensor([0.0, 16.0])  # the goal of UMaze (0, 2 * scale)
    res = env.step(state._replace(qpos=qpos), torch.zeros(4, 8))
    assert bool(res.terminated[0]) and not res.terminated[1:].any()
    inner = res.info["reward_forward"][0] + res.info["reward_ctrl"][0]
    np.testing.assert_allclose(float(res.reward[0]), 1.0 + 0.01 * float(inner),
                               rtol=1e-6)
    assert int(res.state.t[0]) == 0 and (res.state.t[1:] == 1).all()
    assert float(res.state.qpos[0, :2].abs().max()) <= 0.1
    assert float(res.obs[0, 1]) < 1.0 and float(res.obs[0, -1]) == 0.0


def test_truncation_at_episode_limit(umaze):
    state, _ = umaze.reset(0)
    t = torch.tensor([999, 998] * (B // 2), dtype=torch.int32)
    res = umaze.step(state._replace(t=t), torch.zeros(B, 8))
    np.testing.assert_array_equal(res.truncated.numpy(), (t == 999).numpy())
    np.testing.assert_array_equal(res.state.t.numpy(),
                                  np.where(t.numpy() == 999, 0, 999))


def test_rollout_metrics_match_rollout(umaze):
    state, _ = umaze.reset(0)
    gen = torch.Generator().manual_seed(1)
    final, rew_sum, eps = umaze.rollout_metrics(state, umaze.random_policy(), 3,
                                                gen)
    state, _ = umaze.reset(0)
    gen = torch.Generator().manual_seed(1)
    final2, (obs, rew, term) = umaze.rollout(state, umaze.random_policy(), 3, gen)
    assert obs.shape == (3, B, 30) and rew.shape == (3, B)
    np.testing.assert_allclose(float(rew_sum), float(rew.sum()), rtol=1e-5)
    assert float(rew_sum) < 0.0  # dist reward, far from the goal
    assert int(eps) == int(term.sum()) == 0
    torch.testing.assert_close(final.qpos, final2.qpos, rtol=0, atol=0)
    np.testing.assert_allclose(obs[:, 0, -1].numpy(), [0.001, 0.002, 0.003],
                               atol=1e-7)


def test_random_policy_draws_inside_the_ctrl_range(umaze):
    act = umaze.random_policy()(None, torch.Generator().manual_seed(0))
    assert act.shape == (B, 8) and float(act.abs().max()) <= 30.0


def test_step_wrapper_checks_and_cpu_path(umaze):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; malformed inputs are refused before any launch."""
    step = make_fast_step(umaze)
    assert isinstance(step, lane_env.AntStep)
    state, _ = umaze.reset(0)
    before = dict(lane_env.LAUNCHES)
    q, v, t, r, m = step(state.qpos, state.qvel, state.t, torch.zeros(B, 8))
    assert lane_env.LAUNCHES == before
    assert q.shape == (B, 15) and v.shape == (B, 14) and m.dtype == torch.bool
    with pytest.raises(TypeError):
        step(state.qpos.double(), state.qvel, state.t, torch.zeros(B, 8))
    with pytest.raises(ValueError):
        step(state.qpos[:, :7], state.qvel, state.t, torch.zeros(B, 8))
    with pytest.raises(ValueError):
        step(state.qpos, state.qvel, state.t, torch.zeros(B, 2))
    with pytest.raises(ValueError):
        step(state.qpos.to("meta"), state.qvel, state.t, torch.zeros(B, 8))
    with pytest.raises(ValueError, match="kernel"):
        step(state.qpos, state.qvel, state.t, torch.zeros(B, 8),
             count_active=True)
    p = lane_env.ant_params(step.ks)
    assert (p.n_sph, p.n_box, p.n_goal, p.n_w, p.n_blk) == (37, 18, 1, 0, 0)
    assert 1.0 < p.reach2 ** 0.5 < 1.5   # the ant's reach from its torso
    assert p.n_floats == step.ks.packed.numel()


def test_rollout_plain_resets_on_the_last_step(umaze):
    """Envs at t = 999 truncate on the rollout's only step and end on that
    step's reset draw; the count is one episode each."""
    roll = make_fast_rollout(umaze, 1)
    assert isinstance(roll, lane_env.AntRollout)
    state, _ = umaze.reset(0)
    t0 = torch.full((B,), 999, dtype=torch.int32)
    q, v, t, rew, eps = roll.per_env(state.qpos, state.qvel, t0, 5)
    idx = torch.arange(B, dtype=torch.int64)
    q_r, v_r = rollout_reset(idx, 0, 5, umaze.spec.init_qpos)
    torch.testing.assert_close(q, q_r, rtol=0, atol=0)
    torch.testing.assert_close(v, v_r, rtol=0, atol=0)
    assert (t == 0).all() and (eps == 1).all() and torch.isfinite(rew).all()
    qs, vs, ts, rew_s, eps_s = roll(state.qpos, state.qvel, t0, 5)
    assert rew_s.shape == () and int(eps_s) == B


def test_rollout_plain_steps_like_the_step_api(umaze):
    """Two rollout steps from t = 0 are two env steps with the drawn ctrl."""
    state, _ = umaze.reset(0)
    ks = make_fast_step(umaze).ks
    q, v, t, rew, eps = ant_rollout_plain(ks, state.qpos, state.qvel, state.t,
                                          9, 2)
    idx = torch.arange(B, dtype=torch.int64)
    s = state
    total = torch.zeros(B)
    for step in range(2):
        res = umaze.spec.step(s, rollout_ctrl(idx, step, 9))
        s, total = res.state, total + res.reward
    torch.testing.assert_close(q, s.qpos, rtol=0, atol=0)
    torch.testing.assert_close(rew, total, rtol=0, atol=0)
    assert (t == 2).all() and (eps == 0).all()


def test_rollout_draws_follow_their_laws():
    idx = torch.arange(4096, dtype=torch.int64)
    qpos0 = mmt.make_spec("AntUMaze-v0", device="cpu").init_qpos
    ctrl = rollout_ctrl(idx, 3, 17).numpy()
    assert np.abs(ctrl).max() <= 30.0
    np.testing.assert_allclose(ctrl.mean(0), 0.0, atol=1.0)
    np.testing.assert_allclose(ctrl.std(0), 30.0 / np.sqrt(3), rtol=0.05)
    q_r, v_r = (x.numpy() for x in rollout_reset(idx, 3, 17, qpos0))
    np.testing.assert_allclose(np.linalg.norm(q_r[:, 3:7], axis=1), 1.0,
                               atol=1e-6)
    rest = np.r_[0:3, 7:15]
    assert np.abs(q_r[:, rest] - qpos0[rest]).max() <= 0.1
    np.testing.assert_allclose(v_r.mean(0), 0.0, atol=0.01)
    np.testing.assert_allclose(v_r.std(0), 0.1, rtol=0.05)


def test_rollout_words_are_the_point_rollouts():
    """Same (seed, env, step, block), same words: the Point rollout reads
    blocks 0-1, the Ant rollout blocks 0-12 of one Philox stream."""
    idx = torch.arange(64, dtype=torch.int64)
    for seed, step in ((0, 0), (7, 5), (2 ** 32 - 1, 999)):
        w = philox_words(idx, step, seed, range(13))
        act, q_p, v_p = rollout_draws(idx, step, seed)
        torch.testing.assert_close(act[:, 0], uniform24(w[0], -1.0, 1.0),
                                   rtol=0, atol=0)
        torch.testing.assert_close(q_p[:, 0], uniform24(w[2], -0.1, 0.1),
                                   rtol=0, atol=0)
        ctrl = rollout_ctrl(idx, step, seed)
        torch.testing.assert_close(
            ctrl, torch.stack([uniform24(x, -30.0, 30.0) for x in w[:8]], 1),
            rtol=0, atol=0)
        q_r, _ = rollout_reset(idx, step, seed, np.zeros(15))
        torch.testing.assert_close(q_r[:, 0], uniform24(w[8], -0.1, 0.1),
                                   rtol=0, atol=0)


def test_object_worlds_and_float64_are_queued():
    for env_id in ("AntSmallBilliard-v0", "AntSmallBilliard-v2"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11d"):
            mmt.make_batched(env_id, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="float64"):
        mmt.make_spec("AntUMaze-v0", dtype=torch.float64, device="cpu")
