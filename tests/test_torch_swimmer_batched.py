"""Batched lockstep contracts of the port for the Swimmer and the Reacher,
on the CPU, and the swimmer rollout kernel's random stream.

The reset law over the full state (U(±0.1) on every qpos and qvel, the
block worlds' dofs included), the observation widths, auto-reset on
termination and at the episode limit, the step and rollout wrappers' CPU
paths and input checks, the rollout's plain version against the step API
with the same draws, the engine route against the closed form, every one
of the 52 Swimmer and Reacher IDs built and stepped, and the plain version
of the fp32 peak kernel's chain against numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.models.swimmer import SwimmerRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,  # noqa: E402
                                       make_fast_step)
from mujoco_maze_tpu_torch.ops.philox import philox_words, uniform24  # noqa: E402
from mujoco_maze_tpu_torch.ops.swimmer_kernel import (rollout_draws,  # noqa: E402
                                                      swimmer_rollout_plain)
from mujoco_maze_tpu_torch.utils import roofline  # noqa: E402

B = 8
SWIMMER_IDS = [i for i in mmt.env_ids() if i.startswith(("Swimmer", "Reacher"))]


@pytest.fixture(scope="module")
def push():
    return mmt.make_batched("SwimmerPush-v0", B, device="cpu")


def test_the_census_has_52_ids():
    assert len(SWIMMER_IDS) == 52
    blocks = [i for i in SWIMMER_IDS if mmt.entry(i).task_cls.OBSERVE_BLOCKS]
    assert len(blocks) == 10


@pytest.mark.parametrize("env_id", ["SwimmerPush-v0", "ReacherFall-v0"])
def test_reset_law_noises_the_full_state(env_id):
    """qpos and qvel ~ U(±0.1) on every coordinate, world dofs included
    (the init state is zero), t = 0."""
    spec = mmt.make_spec(env_id, device="cpu")
    assert not spec.init_qpos.any() and spec.nq == spec.robot.nq + 2
    state, obs = spec.reset(torch.Generator().manual_seed(3), 4096)
    for x in (state.qpos.numpy(), state.qvel.numpy()):
        assert x.shape == (4096, spec.nq)
        assert np.abs(x).max() <= 0.1 and np.abs(x).min(0).max() < 1e-3
        np.testing.assert_allclose(np.abs(x).max(0), 0.1, atol=1e-3)
        np.testing.assert_allclose(x.mean(0), 0.0, atol=0.005)
        np.testing.assert_allclose(x.std(0), 0.1 / np.sqrt(3), rtol=0.05)
    assert (state.t == 0).all() and (obs[:, -1] == 0).all()


@pytest.mark.parametrize("env_id,width", [
    ("SwimmerUMaze-v0", 11), ("ReacherUMaze-v0", 9),
    ("SwimmerPush-v0", 14), ("ReacherFall-v1", 12)])
def test_obs_widths(env_id, width):
    """qpos[:3], the block centre in the block worlds, the rest of the
    robot's qpos and qvel, t * 0.001."""
    env = mmt.make_batched(env_id, B, device="cpu")
    state, obs = env.reset(0)
    assert obs.shape == (B, width) == (B, env.spec.obs_dim)
    nr = env.spec.robot.nq
    off = 3 + 3 * len(env.spec.block_runtimes)
    torch.testing.assert_close(obs[:, :3], state.qpos[:, :3], rtol=0, atol=0)
    torch.testing.assert_close(obs[:, off:off + nr - 3], state.qpos[:, 3:nr],
                               rtol=0, atol=0)
    torch.testing.assert_close(obs[:, off + nr - 3:-1], state.qvel[:, :nr],
                               rtol=0, atol=0)


def test_autoreset_on_termination():
    """A swimmer on the goal of SwimmerUMaze-v1 terminates, takes the goal
    reward plus the scaled inner reward, and restarts at the origin."""
    env = mmt.make_batched("SwimmerUMaze-v1", 4, device="cpu")
    state, _ = env.reset(0)
    qpos = state.qpos.clone()
    qpos[0, :2] = torch.tensor([0.0, 8.0])  # the goal of UMaze (0, 2 * scale)
    res = env.step(state._replace(qpos=qpos), torch.zeros(4, 2))
    assert bool(res.terminated[0]) and not res.terminated[1:].any()
    inner = res.info["reward_forward"][0] + res.info["reward_ctrl"][0]
    np.testing.assert_allclose(float(res.reward[0]), 1.0 + 0.01 * float(inner),
                               rtol=1e-6)
    assert int(res.state.t[0]) == 0 and (res.state.t[1:] == 1).all()
    assert float(res.state.qpos[0].abs().max()) <= 0.1
    assert float(res.obs[0, -1]) == 0.0


def test_truncation_at_episode_limit(push):
    state, _ = push.reset(0)
    t = torch.tensor([999, 998] * (B // 2), dtype=torch.int32)
    res = push.step(state._replace(t=t), torch.zeros(B, 2))
    np.testing.assert_array_equal(res.truncated.numpy(), (t == 999).numpy())
    np.testing.assert_array_equal(res.state.t.numpy(),
                                  np.where(t.numpy() == 999, 0, 999))
    done = res.truncated
    assert float(res.state.qpos[done].abs().max()) <= 0.1
    torch.testing.assert_close(res.state.qpos[~done, 5:], state.qpos[~done, 5:],
                               rtol=0, atol=0)


def test_step_wrapper_checks_and_cpu_path(push):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; malformed inputs are refused before any launch."""
    step = make_fast_step(push)
    assert isinstance(step, lane_env.SwimmerStep)
    state, _ = push.reset(0)
    before = dict(lane_env.LAUNCHES)
    q, v, t, r, m = step(state.qpos, state.qvel, state.t, torch.zeros(B, 2))
    assert lane_env.LAUNCHES == before
    assert q.shape == (B, 7) and v.shape == (B, 7) and m.dtype == torch.bool
    with pytest.raises(TypeError):
        step(state.qpos.double(), state.qvel, state.t, torch.zeros(B, 2))
    with pytest.raises(ValueError):
        step(state.qpos[:, :5], state.qvel, state.t, torch.zeros(B, 2))
    with pytest.raises(ValueError):
        step(state.qpos, state.qvel, state.t, torch.zeros(B, 1))
    with pytest.raises(ValueError):
        step(state.qpos.t().contiguous().t(), state.qvel, state.t,
             torch.zeros(B, 2))
    with pytest.raises(ValueError):
        step(state.qpos.to("meta"), state.qvel, state.t, torch.zeros(B, 2))
    p = lane_env.swimmer_params(step.ks)
    assert (step.ks.n_world, step.ks.dyn.n_links, p.frame_skip) == (2, 3, 4)
    assert p.inv_dt == 25.0 and p.reward_type == 1
    roll = make_fast_rollout(push, 1)
    with pytest.raises(ValueError, match="32 bits"):
        roll(state.qpos, state.qvel, state.t, -1)


def test_rollout_plain_steps_like_the_step_api(push):
    """Two rollout steps from t = 0 are two env steps with the drawn
    actions."""
    state, _ = push.reset(0)
    ks = make_fast_step(push).ks
    q, v, t, rew, eps = swimmer_rollout_plain(ks, state.qpos, state.qvel,
                                              state.t, 9, 2)
    idx = torch.arange(B, dtype=torch.int64)
    s = state
    total = torch.zeros(B)
    for step in range(2):
        act, _, _ = rollout_draws(idx, step, 9, 2, 7)
        res = push.spec.step(s, act)
        s, total = res.state, total + res.reward
    torch.testing.assert_close(q, s.qpos, rtol=0, atol=0)
    torch.testing.assert_close(v, s.qvel, rtol=0, atol=0)
    torch.testing.assert_close(rew, total, rtol=0, atol=0)
    assert (t == 2).all() and (eps == 0).all()


@pytest.mark.parametrize("env_id", ["SwimmerPush-v0", "ReacherUMaze-v0"])
def test_rollout_plain_resets_on_the_last_step(env_id):
    """Envs at t = 999 truncate on the rollout's only step and end on that
    step's reset draw, world dofs included; one episode each."""
    env = mmt.make_batched(env_id, B, device="cpu")
    roll = make_fast_rollout(env, 1)
    assert isinstance(roll, lane_env.SwimmerRollout)
    state, _ = env.reset(0)
    t0 = torch.full((B,), 999, dtype=torch.int32)
    q, v, t, rew, eps = roll.per_env(state.qpos, state.qvel, t0, 5)
    idx = torch.arange(B, dtype=torch.int64)
    _, q_r, v_r = rollout_draws(idx, 0, 5, env.spec.robot.action_dim,
                                env.spec.nq)
    torch.testing.assert_close(q, q_r, rtol=0, atol=0)
    torch.testing.assert_close(v, v_r, rtol=0, atol=0)
    assert (t == 0).all() and (eps == 1).all() and torch.isfinite(rew).all()
    _, _, _, rew_s, eps_s = roll(state.qpos, state.qvel, t0, 5)
    assert rew_s.shape == () and int(eps_s) == B


def test_rollout_draws_follow_their_laws():
    """Words 0-1 the actions U(±1), then U(±0.1) for every qpos and qvel;
    the same words as every other rollout's for (seed, env, step, block)."""
    idx = torch.arange(4096, dtype=torch.int64)
    act, q_r, v_r = (x.numpy() for x in rollout_draws(idx, 3, 17, 2, 7))
    assert act.shape == (4096, 2) and q_r.shape == v_r.shape == (4096, 7)
    assert np.abs(act).max() <= 1.0
    np.testing.assert_allclose(act.std(0), 1.0 / np.sqrt(3), rtol=0.05)
    for x in (q_r, v_r):
        assert np.abs(x).max() <= 0.1
        np.testing.assert_allclose(x.mean(0), 0.0, atol=0.005)
        np.testing.assert_allclose(x.std(0), 0.1 / np.sqrt(3), rtol=0.05)
    w = philox_words(idx[:64], 3, 17, range(4))
    r_act, r_q, r_v = rollout_draws(idx[:64], 3, 17, 1, 7)
    torch.testing.assert_close(r_act[:, 0], uniform24(w[0], -1.0, 1.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(r_q[:, 6], uniform24(w[8], -0.1, 0.1),
                               rtol=0, atol=0)
    torch.testing.assert_close(r_v[:, 6], uniform24(w[15], -0.1, 0.1),
                               rtol=0, atol=0)


def test_engine_route_matches_the_closed_form(monkeypatch):
    """With ``USE_CLOSED_FORM`` cleared the step runs the generic engine
    with the fluid drag; the observations agree with the closed form's
    within the JAX package's bound for the same check
    (tests/test_swimmer_fast.py: 2e-5)."""
    env = mmt.make_batched("SwimmerUMaze-v0", B, auto_reset=False, device="cpu")
    state, _ = env.reset(0)
    act = torch.full((B, 2), 0.5)
    fast = env.step(state, act)
    monkeypatch.setattr(SwimmerRobot, "USE_CLOSED_FORM", False)
    ref = env.spec.step(state, act)
    torch.testing.assert_close(fast.obs, ref.obs, rtol=0, atol=2e-5)


@pytest.mark.parametrize("env_id", SWIMMER_IDS)
def test_every_id_builds_and_steps(env_id):
    env = mmt.make_batched(env_id, 2, device="cpu")
    state, obs = env.reset(1)
    gen = torch.Generator().manual_seed(2)
    res = env.step(state, env.random_policy()(obs, gen))
    assert res.obs.shape == (2, env.spec.obs_dim)
    assert torch.isfinite(res.obs).all() and torch.isfinite(res.reward).all()
    assert isinstance(env._kernel_step, lane_env.SwimmerStep)


def test_fma_chain_plain_matches_numpy():
    """The plain version of the fp32 peak kernel's chain, x = a x + b
    rounded twice per step, against the same chain in float64: within a
    relative 1e-5 over 64 steps (the bound the kernel is held to against
    the plain version on the card)."""
    x0 = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    got = roofline.fma_chain(x0, 64).numpy()
    want = x0.numpy().astype(np.float64)
    for _ in range(64):
        want = want * roofline.A + roofline.B
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert lane_env.LAUNCHES["fma_peak"] == 0
    with pytest.raises(RuntimeError, match="card"):
        roofline.fp32_peak_flops(device="cpu")
