"""The Ant with a free object ball (AntSmallBilliard-v0) in the PyTorch
port vs the JAX package: the env step on the CPU.

The port's ``spec.step`` (the plain batch-first engine with the ball's
free tree and the 37 robot-ball sphere-sphere pairs) against the JAX
package's XLA step (``jax.jit(jax.vmap(spec.step))``, compiled once for
the module) at B = 8, teacher-forced for 3 steps of seeded actions, from
the JAX reset and from the ball-touching states of tests/test_ant_fast.py
(the ant's qpos0 plus U(±0.08), the ball up to 0.5 from the torso in x
and y in every third env and near its rest elsewhere, its body origin
0.35-0.5 high at a random orientation).  Bounds: those of the Ant step
(tests/test_torch_ant_step.py): qpos 5e-4, qvel 5e-3, reward 1e-4, t and
terminated exact; the observation 33 wide with the ball's body origin at
obs[3:6].  On the same states the engine's pieces for the ball's second
free tree: the mass matrix and the bias at a relative 1e-5
(tests/test_torch_ant_engine.py's bounds) and the integration of both
free joints' quaternions, renormalised, at 1e-6.

The Ant's own kernel takes no ball yet: ``make_batched`` raises naming
ROADMAP queue 1 item 11d-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.physics import engine as jeng  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.physics import engine as teng  # noqa: E402

ENV_ID = "AntSmallBilliard-v0"
B = 8
QPOS_TOL, QVEL_TOL, REWARD_TOL = 5e-4, 5e-3, 1e-4


@pytest.fixture(scope="module")
def sides():
    jspec = jmmt.make_spec(ENV_ID)
    return jspec, jax.jit(jax.vmap(jspec.step)), tmmt.make_spec(ENV_ID,
                                                                device="cpu")


def _touching_states(model, seed):
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(model.qpos0, np.float64), (B, 1))
    for e in range(B):
        qpos[e, :15] += rng.uniform(-0.08, 0.08, 15)
        qpos[e, 3:7] /= np.linalg.norm(qpos[e, 3:7])
        if e % 3 == 0:          # the ball overlapping the robot
            qpos[e, 15:17] = qpos[e, :2] + rng.uniform(-0.5, 0.5, 2)
        else:
            qpos[e, 15:17] += rng.uniform(-0.5, 0.5, 2)
        qpos[e, 17] = 0.4 + rng.uniform(-0.05, 0.1)
        bq = rng.randn(4)
        qpos[e, 18:22] = bq / np.linalg.norm(bq)
    qvel = rng.randn(B, 20) * 0.3
    t = rng.randint(0, 1000, B)
    return (qpos.astype(np.float32), qvel.astype(np.float32),
            t.astype(np.int32))


def _compare(sides, jstate, seed):
    jspec, jstep, tspec = sides
    rng = np.random.RandomState(seed)
    for it in range(3):
        act = rng.uniform(-30, 30, (B, 8)).astype(np.float32)
        jres = jstep(jstate, jnp.asarray(act))
        tst = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                     device="cpu")
        tres = tspec.step(tst, torch.as_tensor(act))
        msg = f"step {it}"
        np.testing.assert_allclose(tres.state.qpos.numpy(),
                                   np.asarray(jres.state.qpos), rtol=0,
                                   atol=QPOS_TOL, err_msg=msg)
        np.testing.assert_allclose(tres.state.qvel.numpy(),
                                   np.asarray(jres.state.qvel), rtol=0,
                                   atol=QVEL_TOL, err_msg=msg)
        np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                                   rtol=0, atol=REWARD_TOL, err_msg=msg)
        np.testing.assert_array_equal(tres.state.t.numpy(),
                                      np.asarray(jres.state.t))
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      np.asarray(jres.terminated))
        tobs, jobs = tres.obs.numpy(), np.asarray(jres.obs)
        assert tobs.shape == jobs.shape == (B, 33)
        np.testing.assert_array_equal(tobs[:, 3:6],
                                      tres.state.qpos.numpy()[:, 15:18])
        np.testing.assert_allclose(tobs, jobs, rtol=0, atol=QVEL_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tobs[:, :18], jobs[:, :18], rtol=0,
                                   atol=QPOS_TOL, err_msg=msg)
        jstate = jres.state


def test_step_matches_jax_from_reset(sides):
    jspec, _, tspec = sides
    jst, jobs = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(4), B))
    tst = convert.from_jax_state(jst.qpos, jst.qvel, jst.t, device="cpu")
    np.testing.assert_allclose(tspec._observe(tst).numpy(), np.asarray(jobs),
                               rtol=0, atol=0)
    _compare(sides, jst, seed=1)


def test_step_matches_jax_with_the_ball_touching(sides):
    jspec, _, tspec = sides
    q, v, t = _touching_states(tspec.dynamic_model, seed=0)
    jst, _ = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    jst = jst._replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                       t=jnp.asarray(t))
    _compare(sides, jst, seed=2)


def test_mass_matrix_bias_and_integration_match(sides):
    """The two free trees (the Ant, the ball): M block diagonal over them,
    the bias, and one integration step of both quaternions."""
    jspec, _, tspec = sides
    jmodel, tmodel = jspec.dynamic_model, tspec.dynamic_model
    q, v, _ = _touching_states(tmodel, seed=3)

    def ref(q_, v_):
        kd = jeng.kin_dyn(jmodel, q_, v_)
        return jeng.crb_mass_matrix(jmodel, kd), jeng.rne_bias(jmodel, kd, v_)

    jM, jbias = (np.asarray(x) for x in jax.jit(jax.vmap(ref))(
        jnp.asarray(q), jnp.asarray(v)))
    tq, tv = torch.as_tensor(q), torch.as_tensor(v)
    kd = teng.kin_dyn(tmodel, tq, tv)
    tM = teng.crb_mass_matrix(tmodel, kd).numpy()
    tbias = teng.rne_bias(tmodel, kd, tv).numpy()
    for got, want, name in ((tM, jM, "M"), (tbias, jbias, "bias")):
        rel = np.abs(got - want).max() / (1.0 + np.abs(want).max())
        assert rel < 1e-5, f"{name}: rel err {rel}"
    assert not tM[:, :14, 14:].any() and not tM[:, 14:, :14].any()
    jq = np.asarray(jax.vmap(lambda a, b: jeng.integrate_pos(
        jmodel, a, b, 0.01))(jnp.asarray(q), jnp.asarray(5.0 * v)))
    got = teng.integrate_pos(tmodel, tq, 5.0 * tv, 0.01).numpy()
    np.testing.assert_allclose(got, jq, rtol=0, atol=1e-6)
    for a in (3, 18):
        np.testing.assert_allclose(np.linalg.norm(got[:, a:a + 4], axis=1),
                                   1.0, rtol=0, atol=1e-6)


def test_the_ant_kernel_waits_for_11d_2():
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item 11d-2"):
        tmmt.make_batched(ENV_ID, 4, device="cpu")
