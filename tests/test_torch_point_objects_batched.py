"""The port's batched API and rollout in the Point object worlds (CPU).

* Auto-reset puts the world dofs back at 0, at rest, and draws the robot
  from the reset law, on PointPush-v0 (one block), PointBilliard-v0 (a
  hinge ball) and PointFall-v0 (the falling block).
* The rollout kernel's plain version (``point_rollout_plain``) follows
  the Philox stream of the plain mazes: each step's actions and reset
  draws are ``rollout_draws`` (no extra draws for the world dofs), the
  robot and objects step as the env's own step does, resets put the world
  dofs at 0, at rest, and the episode counts are the resets.
* The object worlds' wrappers take ``(B, 3 + n_world)`` rows and run the
  plain version on the CPU; an entry point asked for CUDA without a card
  raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT, EnvState  # noqa: E402
from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,  # noqa: E402
                                       make_fast_step)
from mujoco_maze_tpu_torch.ops.point_kernel import (object_states,  # noqa: E402
                                                    point_rollout_plain,
                                                    rollout_draws)

IDS = ["PointPush-v0", "PointBilliard-v0", "PointFall-v0"]
B = 8


def _state(spec, seed, t):
    q, v, _ = object_states(spec, B, seed)
    return EnvState(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                    t=torch.full((B,), t, dtype=torch.int32))


@pytest.mark.parametrize("env_id", IDS)
def test_auto_reset_zeroes_the_world_dofs(env_id):
    env = mmt.make_batched(env_id, B, device="cpu")
    env.reset(0)
    n_robot = env.spec.robot.nq
    st = _state(env.spec, 3, EPISODE_LIMIT - 1)
    assert bool((st.qpos[:, n_robot:] != 0).any())
    res = env.step(st, torch.zeros(B, 2))
    assert bool(res.truncated.all())
    q, v = res.state.qpos, res.state.qvel
    assert torch.all(q[:, n_robot:] == 0) and torch.all(v[:, n_robot:] == 0)
    assert torch.all(res.state.t == 0)
    assert bool((q[:, :n_robot].abs() <= 0.1).all())
    assert bool(((v[:, :n_robot] >= 0) & (v[:, :n_robot] <= 0.1)).all())
    np.testing.assert_array_equal(res.obs.numpy(),
                                  env.spec._observe(res.state).numpy())


@pytest.mark.parametrize("env_id", IDS)
def test_rollout_plain_follows_the_philox_stream(env_id):
    """The plain rollout against an independent loop of the env's own step
    with the same draws, from t near the limit so that every env resets
    inside the window."""
    steps, seed = 6, 21
    env = mmt.make_batched(env_id, B, auto_reset=False, device="cpu")
    roll = make_fast_rollout(env, steps)
    st = _state(env.spec, 4, EPISODE_LIMIT - 4)
    st = st._replace(t=st.t - torch.arange(B, dtype=torch.int32) % 3)
    got = roll.per_env(st.qpos, st.qvel, st.t, seed)
    got_sums = roll(st.qpos, st.qvel, st.t, seed)

    n_world = env.spec.nq - env.spec.robot.nq
    idx = torch.arange(B, dtype=torch.int64)
    q, v, t = st.qpos, st.qvel, st.t
    rew = torch.zeros(B)
    eps = torch.zeros(B, dtype=torch.int32)
    for k in range(steps):
        act, q_r, v_r = rollout_draws(idx, k, seed)
        res = env.spec.step(EnvState(qpos=q, qvel=v, t=t), act)
        done = (res.terminated | res.truncated)[:, None]
        zero = torch.zeros(B, n_world)
        q = torch.where(done, torch.cat([q_r, zero], dim=1), res.state.qpos)
        v = torch.where(done, torch.cat([v_r, zero], dim=1), res.state.qvel)
        t = torch.where(done[:, 0], 0, res.state.t)
        rew = rew + res.reward
        eps = eps + done[:, 0].to(torch.int32)
    for a, b in zip(got, (q, v, t, rew, eps)):
        assert torch.equal(a, b)
    assert int(eps.sum()) >= B
    assert torch.equal(got_sums[3], torch.sum(rew))
    assert int(got_sums[4]) == int(eps.sum())


def test_rollout_plain_resets_draw_nothing_for_the_world():
    """A reset in an object world takes the same draws as in a plain maze:
    the robot's three qpos and three qvel words of ``rollout_draws``."""
    obj = make_fast_rollout(mmt.make_batched("PointPush-v0", B, device="cpu"), 1)
    plain = make_fast_rollout(mmt.make_batched("PointUMaze-v0", B, device="cpu"), 1)
    t = torch.full((B,), EPISODE_LIMIT - 1, dtype=torch.int32)
    q_obj = torch.zeros(B, 5)
    q_plain = torch.zeros(B, 3)
    out_obj = point_rollout_plain(obj.ks, q_obj, q_obj.clone(), t, 5, 1)
    out_plain = point_rollout_plain(plain.ks, q_plain, q_plain.clone(), t, 5, 1)
    assert torch.equal(out_obj[0][:, :3], out_plain[0])
    assert torch.equal(out_obj[1][:, :3], out_plain[1])
    assert torch.all(out_obj[0][:, 3:] == 0) and torch.all(out_obj[1][:, 3:] == 0)
    assert torch.equal(out_obj[4], out_plain[4])


def test_wrappers_take_the_world_rows_and_run_plain_on_the_cpu():
    env = mmt.make_batched("PointMultiPushSmall-v0", B, auto_reset=False,
                           device="cpu")
    step = make_fast_step(env)
    assert step.ks.n_world == 6 and step.ks.max_rows == 604
    st = _state(env.spec, 5, 10)
    before = dict(lane_env.LAUNCHES)
    out = step(st.qpos, st.qvel, st.t, torch.zeros(B, 2))
    assert lane_env.LAUNCHES == before
    assert out[0].shape == (B, 9) and out[1].shape == (B, 9)
    with pytest.raises(ValueError):
        step(st.qpos[:, :3].contiguous(), st.qvel, st.t, torch.zeros(B, 2))
    with pytest.raises(ValueError, match="kernel"):
        step(st.qpos, st.qvel, st.t, torch.zeros(B, 2), trace=True)
    with pytest.raises(ValueError):
        step(st.qpos.to("meta"), st.qvel, st.t, torch.zeros(B, 2))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mmt.make_batched("PointPush-v0", B)
