"""The port's quasi-static Point step against the JAX package.

A Point robot without the object solve (``_torch_point_quasi.QuasiPoint``)
in the five worlds of its rows: the port's plain step
(``point_kernel.point_step_plain``, the plain version of the CUDA
``point_quasi_step_kernel``) against JAX ``spec.step`` (XLA, float32),
teacher-forced from ``point_kernel.quasi_states`` (the robot disc on the
block faces and inside the blocks, equal exit depths among them; blocks at
and past their travel limits and overlapping pairs; the ball on the robot,
headed into walls and corners; t spread over the episode), then along
random actions: qpos, qvel and reward within 1e-4 (the bound the JAX
package holds its kernel to against XLA, tests/test_pallas.py), t and
terminated exactly.  On one block world and one ball world, also against
the JAX Pallas kernel in interpret mode, as tests/test_pallas.py runs it.
The plain rollout resets the world dofs to qpos0, at rest.
"""

import _torch_threads  # noqa: F401  (one PyTorch intra-op thread)
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_point_quasi as pq  # noqa: E402
from mujoco_maze_tpu.ops import point_pallas  # noqa: E402

from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT  # noqa: E402
from mujoco_maze_tpu_torch.ops import point_kernel as pk  # noqa: E402

from _torch_threads import one_intraop_thread  # noqa: E402,F401

B = 64
STEPS = 3


def _random_actions(rng, n):
    return (rng.uniform(-1, 1, (n, 2)) * [1.0, 0.25]).astype(np.float32)


@pytest.mark.parametrize("env_id", pq.WORLDS)
def test_plain_step_matches_xla(env_id):
    jspec, tspec = pq.specs(env_id)
    ks = pk.spec_from_env(tspec)
    step = jax.jit(jax.vmap(jspec.step))
    q, v, t, act = pk.quasi_states(tspec, B, 11)
    js = pq.jax_state(jspec, q, v, t)
    rng = np.random.RandomState(11)
    fired = {}
    for k in range(STEPS):
        jres = step(js, jnp.asarray(act))
        ts = pq.port_state(np.asarray(js.qpos), np.asarray(js.qvel),
                           np.asarray(js.t))
        for name, hit in pq.quasi_events(tspec, ts.qpos, ts.qvel,
                                         torch.as_tensor(act)).items():
            fired[name] = fired.get(name, 0) + int(hit.sum())
        out = pk.point_step_plain(ks, ts.qpos, ts.qvel, ts.t,
                                  torch.as_tensor(act))
        tres = tspec.step(ts, torch.as_tensor(act))
        for a, b in zip(out, (tres.state.qpos, tres.state.qvel, tres.state.t,
                              tres.reward, tres.terminated)):
            assert torch.equal(a, b)
        pq.assert_step_close(tres, jres)
        js = jres.state
        act = _random_actions(rng, B)
    # the rows were exercised
    if tspec.block_runtimes:
        assert fired["block pushed"] >= B
    if len(tspec.block_runtimes) > 1:
        assert fired["pair separated"] > 0
    if tspec.ball_runtimes:
        assert fired["ball kicked"] > 0 and fired["ball bounced"] > 0


def test_tie_rule_inside_a_block():
    """The robot's centre at a block's centre (all four exit depths equal):
    the block leaves along +x, as ``argmin`` picks the first of equal
    depths (JAX env.py:666-673)."""
    jspec, tspec = pq.specs("PointPush-v0")
    b = tspec.block_runtimes[0]
    q = np.zeros((1, tspec.nq), np.float32)
    q[0, :2] = np.float32(b.body_pos[:2])
    v = np.zeros_like(q)
    t = np.zeros(1, np.int32)
    act = np.zeros((1, 2), np.float32)
    jres = jax.jit(jax.vmap(jspec.step))(pq.jax_state(jspec, q, v, t),
                                          jnp.asarray(act))
    tres = tspec.step(pq.port_state(q, v, t), torch.as_tensor(act))
    pq.assert_step_close(tres, jres)
    moved = tres.state.qpos[0, 3:5].numpy()
    assert moved[0] > 0.1 and moved[1] == 0.0


@pytest.mark.parametrize("env_id", ["PointMultiPushSmall-v0",
                                    "PointBilliard-v0"])
def test_plain_step_matches_pallas_kernel_interpret(env_id):
    """The plain step against the JAX Point kernel's quasi-static rows
    (``_push_blocks_lanes`` / ``_step_balls_lanes``) in interpret mode."""
    n = 16
    jspec, tspec = pq.specs(env_id)
    jks = point_pallas.spec_from_env(jspec)
    assert jks.object_spec is None and (jks.blocks or jks.balls)
    kern = point_pallas.build_step_kernel(jks, n, tile=n, interpret=True)
    ks = pk.spec_from_env(tspec)
    q, v, t, act = pk.quasi_states(tspec, n, 5)
    jq, jv, jt, jr, jm = kern(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t),
                              jnp.asarray(act))
    tq, tv, tt, tr, tm = pk.point_step_plain(ks, *pq.as_torch(q, v, t, act))
    np.testing.assert_allclose(np.delete(tq.numpy(), 2, 1),
                               np.delete(np.asarray(jq), 2, 1), atol=pq.ATOL)
    dori = np.remainder(tq.numpy()[:, 2] - np.asarray(jq)[:, 2] + np.pi,
                        2 * np.pi) - np.pi
    np.testing.assert_allclose(dori, 0.0, atol=pq.ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=pq.ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=pq.ATOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("env_id", ["PointPush-v0", "PointBilliard-v0"])
def test_plain_rollout_resets_world_dofs(env_id):
    """The rollout's plain version from states that end their episode in
    the window: every env resets, and those that reset on the last step
    hold the reset draw on the robot and the world dofs at qpos0 (0), at
    rest, as the JAX rollout kernel's ``sample_reset`` puts them."""
    _, tspec = pq.specs(env_id)
    ks = pk.spec_from_env(tspec)
    n, steps = 16, 4
    q, v, _, _ = pq.as_torch(*pk.quasi_states(tspec, n, 2))
    t = torch.as_tensor(EPISODE_LIMIT - steps + np.arange(n) % steps,
                        dtype=torch.int32)
    qf, vf, tf, rew, eps = pk.point_rollout_plain(ks, q, v, t, 9, steps)
    assert int(eps.min()) >= 1
    last = tf == 0
    assert bool(last.any())
    _, q_r, v_r = pk.rollout_draws(torch.arange(n), steps - 1, 9)
    assert torch.equal(qf[last, :3], q_r[last])
    assert torch.equal(vf[last, :3], v_r[last])
    assert bool((qf[last, 3:] == 0).all() and (vf[last, 3:] == 0).all())
    assert torch.isfinite(rew).all()
