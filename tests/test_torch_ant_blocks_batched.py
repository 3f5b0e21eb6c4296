"""Batched lockstep contracts of the port in the Ant block worlds, on the
CPU: the observation's layout and width (block centers after the first
three robot coordinates), the reset law (the world dofs at ``qpos0``, at
rest), auto-reset on termination and at the episode limit putting the
blocks back, the step wrapper's input checks at nq = 15 + world dofs, and
the rollout kernel's plain version on block worlds (its reset draws the
ant's 15 q and 14 v only; the world dofs go back to ``qpos0`` at rest).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,  # noqa: E402
                                       make_fast_step)
from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,  # noqa: E402
                                                  block_states, rollout_ctrl,
                                                  rollout_reset)

B = 4


@pytest.fixture(scope="module")
def push():
    return mmt.make_batched("AntPush-v0", B, device="cpu")


def _displaced(env, seed=0):
    q, v, t = (torch.as_tensor(x) for x in block_states(env.spec, B, seed))
    return env.spec.reset(torch.Generator().manual_seed(seed), B)[0]._replace(
        qpos=q, qvel=v, t=t)


def test_reset_law_zeroes_the_world_dofs():
    spec = mmt.make_spec("AntPushMaze-v0", device="cpu")
    state, obs = spec.reset(torch.Generator().manual_seed(3), 512)
    qpos0 = torch.as_tensor(spec.init_qpos, dtype=torch.float32)
    assert state.qpos.shape == (512, 21) and state.qvel.shape == (512, 20)
    assert (state.qpos[:, 15:] == qpos0[15:]).all()
    assert (state.qvel[:, 14:] == 0).all()
    dq = (state.qpos[:, :15] - qpos0[:15]).abs()
    assert float(dq.max()) <= 0.1 and float(dq.max()) > 0.09
    assert obs.shape == (512, 39)


@pytest.mark.parametrize("env_id", ["AntPush-v0", "AntFall-v0",
                                    "AntMultiPush-v0", "AntBlockCarry-v0"])
def test_obs_layout(env_id):
    spec = mmt.make_spec(env_id, device="cpu")
    q, v, t = (torch.as_tensor(x) for x in block_states(spec, B, 1))
    from mujoco_maze_tpu_torch.envs.env import EnvState

    obs = spec._observe(EnvState(qpos=q, qvel=v, t=t))
    n = len(spec.block_runtimes)
    assert obs.shape == (B, 30 + 3 * n) == (B, spec.obs_dim)
    torch.testing.assert_close(obs[:, :3], q[:, :3], rtol=0, atol=0)
    for i, b in enumerate(spec.block_runtimes):
        want = torch.as_tensor(b.body_pos, dtype=torch.float32).expand(B, 3).clone()
        for k, a in enumerate(b.qpos_idx):
            if a >= 0:
                want[:, k] = want[:, k] + q[:, a]
        torch.testing.assert_close(obs[:, 3 + 3 * i:6 + 3 * i], want,
                                   rtol=0, atol=0)
    torch.testing.assert_close(obs[:, 3 + 3 * n:15 + 3 * n], q[:, 3:15],
                               rtol=0, atol=0)
    torch.testing.assert_close(obs[:, 15 + 3 * n:29 + 3 * n], v[:, :14],
                               rtol=0, atol=0)
    torch.testing.assert_close(obs[:, -1], t.float() * 0.001, rtol=0, atol=0)


def test_autoreset_at_the_episode_limit_puts_blocks_back(push):
    state = _displaced(push)
    assert float(state.qpos[:, 15:].abs().max()) > 1.0
    t = torch.tensor([999, 5] * (B // 2), dtype=torch.int32)
    res = push.step(state._replace(t=t), torch.zeros(B, 8))
    done = (t == 999).numpy()
    np.testing.assert_array_equal(res.truncated.numpy(), done)
    qpos0 = torch.as_tensor(push.spec.init_qpos, dtype=torch.float32)
    assert (res.state.qpos[done][:, 15:] == qpos0[15:]).all()
    assert (res.state.qvel[done][:, 14:] == 0).all()
    base = torch.tensor(push.spec.block_runtimes[0].body_pos, dtype=torch.float32)
    assert (res.obs[done][:, 3:6] == base).all()
    assert (res.state.qpos[~done][:, 15:] != qpos0[15:]).any()


def test_autoreset_on_termination_of_the_block_carry():
    """BlockCarry's heads read the block's center: a block on the goal
    terminates the episode, wherever the ant is."""
    env = mmt.make_batched("AntBlockCarry-v0", B, device="cpu")
    state, _ = env.reset(0)
    (blk,) = env.spec.block_runtimes
    goal = env.spec.heads.goals.pos[0]
    q = state.qpos.clone()
    q[0, blk.qpos_idx[0]] = float(goal[0]) - blk.body_pos[0]
    q[0, blk.qpos_idx[1]] = float(goal[1]) - blk.body_pos[1]
    res = env.step(state._replace(qpos=q), torch.zeros(B, 8))
    assert bool(res.terminated[0]) and not res.terminated[1:].any()
    assert int(res.state.t[0]) == 0
    assert (res.state.qpos[0, 15:] == 0).all()


def test_step_wrapper_checks_world_dofs(push):
    step = make_fast_step(push)
    state, _ = push.reset(0)
    q, v, t, r, m = step(state.qpos, state.qvel, state.t, torch.zeros(B, 8))
    assert q.shape == (B, 17) and v.shape == (B, 16)
    with pytest.raises(ValueError):
        step(state.qpos[:, :15], state.qvel, state.t, torch.zeros(B, 8))
    with pytest.raises(ValueError):
        step(state.qpos, state.qvel[:, :14], state.t, torch.zeros(B, 8))
    with pytest.raises(ValueError, match="kernel"):
        step(state.qpos, state.qvel, state.t, torch.zeros(B, 8), trace=True)


def test_rollout_plain_resets_world_dofs(push):
    """Envs at t = 999 truncate on the rollout's only step and end on that
    step's reset draw: the ant's drawn, the blocks at qpos0 and at rest."""
    roll = make_fast_rollout(push, 1)
    assert isinstance(roll, lane_env.AntRollout)
    state = _displaced(push, 2)
    t0 = torch.full((B,), 999, dtype=torch.int32)
    q, v, t, rew, eps = roll.per_env(state.qpos, state.qvel, t0, 5)
    idx = torch.arange(B, dtype=torch.int64)
    q_r, v_r = rollout_reset(idx, 0, 5, push.spec.init_qpos)
    assert q_r.shape == (B, 17) and v_r.shape == (B, 16)
    torch.testing.assert_close(q, q_r, rtol=0, atol=0)
    torch.testing.assert_close(v, v_r, rtol=0, atol=0)
    assert (q[:, 15:] == torch.as_tensor(push.spec.init_qpos[15:],
                                         dtype=torch.float32)).all()
    assert (v[:, 14:] == 0).all()
    assert (t == 0).all() and (eps == 1).all() and torch.isfinite(rew).all()


def test_rollout_reset_draws_are_the_object_free_ones():
    """The block worlds' reset draws the same words as the object-free
    mazes' for the ant: the world dofs draw nothing."""
    idx = torch.arange(64, dtype=torch.int64)
    q15, v14 = rollout_reset(idx, 3, 17, np.r_[np.zeros(15)])
    q17, v16 = rollout_reset(idx, 3, 17, np.r_[np.zeros(15), 1.5, -2.0])
    torch.testing.assert_close(q17[:, :15], q15, rtol=0, atol=0)
    torch.testing.assert_close(v16[:, :14], v14, rtol=0, atol=0)
    assert (q17[:, 15] == 1.5).all() and (q17[:, 16] == -2.0).all()
    assert (v16[:, 14:] == 0).all()


def test_rollout_plain_steps_like_the_step_api():
    """Two rollout steps from t = 0 on AntFall-v0 are two env steps with
    the drawn ctrl."""
    env = mmt.make_batched("AntFall-v0", B, device="cpu")
    state, _ = env.reset(0)
    ks = make_fast_step(env).ks
    q, v, t, rew, eps = ant_rollout_plain(ks, state.qpos, state.qvel, state.t,
                                          9, 2)
    idx = torch.arange(B, dtype=torch.int64)
    s, total = state, torch.zeros(B)
    for step in range(2):
        res = env.spec.step(s, rollout_ctrl(idx, step, 9))
        s, total = res.state, total + res.reward
    torch.testing.assert_close(q, s.qpos, rtol=0, atol=0)
    torch.testing.assert_close(rew, total, rtol=0, atol=0)
    assert (t == 2).all() and (eps == 0).all()
