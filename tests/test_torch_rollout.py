"""The fused random-policy rollout of the PyTorch port, on the CPU through
its plain version (the CUDA kernel draws the same Philox stream; on the
card chip_smoke.py holds the two against each other).

Semantics as tests/test_pallas.py checks them for the Pallas rollout:
bounded xy, t <= steps, negative dist reward, episodes consistent with
truncation; and the same seed gives the same output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_rollout  # noqa: E402
from mujoco_maze_tpu_torch.ops.point_kernel import (philox4x32,  # noqa: E402
                                                    rollout_draws)

B, STEPS = 32, 16


@pytest.fixture(scope="module")
def env():
    return mmt.make_batched("PointUMaze-v0", B, device="cpu")


@pytest.mark.parametrize("counter, key, expected", [
    # Random123 known-answer vectors for Philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    words = philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in counter),
                       key)
    assert tuple(int(w) for w in words) == expected


def test_rollout_draws_follow_the_laws():
    act, q_r, v_r = rollout_draws(torch.arange(4096, dtype=torch.int64), 5, 9)
    a = act.numpy()
    assert (np.abs(a[:, 0]) <= 1).all() and (np.abs(a[:, 1]) <= 0.25).all()
    assert (np.abs(q_r.numpy()) <= 0.1).all()
    assert (v_r.numpy() >= 0).all() and (v_r.numpy() <= 0.1).all()
    # 24-bit uniforms: means near the centres of their boxes
    np.testing.assert_allclose(a.mean(axis=0), 0.0, atol=0.05)
    np.testing.assert_allclose(v_r.numpy().mean(), 0.05, atol=0.005)


def test_rollout_semantics(env):
    roll = make_fast_rollout(env, STEPS)
    state, _ = env.reset(0)
    qp, qv, t, rew, eps = roll(state.qpos, state.qvel, state.t, 3)
    lo, hi = env.spec.observation_bounds()
    q = qp.numpy()
    assert (q[:, 0] > lo[0] - 0.2).all() and (q[:, 0] < hi[0] + 0.2).all()
    assert (q[:, 1] > lo[1] - 0.2).all() and (q[:, 1] < hi[1] + 0.2).all()
    assert float(rew) < 0  # dist reward is negative away from the goal
    assert int(t.max()) <= STEPS
    assert int(eps) == 0  # no truncation within 16 steps of a reset
    assert rew.shape == () and eps.shape == ()


def test_rollout_truncation_counts_episodes(env):
    """Envs 10 steps short of the limit each end exactly one episode in a
    16-step rollout and restart: t = 16 - 10."""
    roll = make_fast_rollout(env, STEPS)
    state, _ = env.reset(0)
    t0 = torch.full((B,), 990, dtype=torch.int32)
    qp, qv, t, rew, eps = roll.per_env(state.qpos, state.qvel, t0, 3)
    assert (eps == 1).all()
    assert (t == STEPS - 10).all()


def test_rollout_same_seed_same_output(env):
    roll = make_fast_rollout(env, STEPS)
    state, _ = env.reset(0)
    a = roll.per_env(state.qpos, state.qvel, state.t, 11)
    b = roll.per_env(state.qpos, state.qvel, state.t, 11)
    c = roll.per_env(state.qpos, state.qvel, state.t, 12)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
