"""The generic engine step of the PyTorch port vs the JAX package: the Fall
world, the Ant model's forward dynamics, and the ball-jointed robot in a
fluid.

* Roller · Fall (the JAX kernel's interpret-mode build takes ~36 s, hence
  a file of its own): the port's plain step against the JAX generic
  kernel and the JAX XLA step over 3 steps from the JAX reset, at the
  bounds of tests/test_engine_pallas.py (qpos 1e-5, qvel 1e-4, reward
  1e-5, terminated and t exact).  One coordinate is held otherwise: the
  falling block's z slide, whose saturated platform and limit rows press
  with ~500 times the block's weight against each other, so float32
  rounding leaves ~1e-5 in its step in any implementation; the JAX
  package's own kernel and XLA path differ there by 6.3e-6.  The port is
  held within the bound of the JAX kernel, and within the bound plus the
  kernel-vs-XLA difference of the XLA path.
* The Ant model's AntPush-v0 world, with a leg against the block: one
  forward evaluation of the port's engine (contacts and support) against
  the JAX lane form ``lane_engine.forward_lane`` at a relative 1e-5, as
  tests/test_engine_pallas.py:72-104 holds the lane form to the JAX
  engine.  The JAX generic kernel is never built for the Ant: its
  interpret-mode compile does not finish within minutes.
* The Roller with a ball-jointed arm, in a model with viscosity and fluid
  density (``_torch_engine``): the plain step against the JAX XLA step at
  the same bounds, from the reset and from contact states.  The contact
  states are the ones nearest the world origin of a larger draw: the JAX
  engine takes spatial quantities about the world origin, so its float32
  rounding grows with r² (ROADMAP queue 3) and reaches 2e-4 in a ball
  dof's velocity 11 m out, past the bound; within a cell or so of the
  origin it stays under it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import actions, jax_state, specs  # noqa: E402

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import engine_pallas as ep  # noqa: E402
from mujoco_maze_tpu.ops import lane_engine as le  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import ant_kernel, engine_kernel  # noqa: E402
from mujoco_maze_tpu_torch.physics import engine  # noqa: E402

B = 8
TOL = {"qpos": 1e-5, "qvel": 1e-4, "reward": 1e-5}


def _plain(ks, q, v, t, a):
    return tuple(x.numpy() for x in engine_kernel.engine_step_plain(
        ks, *(torch.tensor(x) for x in (q, v, t, a))))


def _xla(step, q, v, t, a):
    res = step(jax_state(q, v, t), jnp.asarray(a))
    return tuple(np.array(x) for x in (res.state.qpos, res.state.qvel,
                                       res.state.t, res.reward,
                                       res.terminated))


def test_fall_matches_jax():
    js, ts = specs("GoalRewardFall")
    ks = engine_kernel.spec_from_env(ts)
    kern = ep.build_step_kernel(ep.spec_from_env(js), B, tile=8)
    xla = jax.jit(jax.vmap(js.step))
    (zq,) = [b.qpos_idx[2] for b in ts.block_runtimes if b.falling]
    zv = zq   # slides only: the z slide's dof is its coordinate's index
    st, _ = jax.vmap(js.reset)(jax.random.split(jax.random.PRNGKey(4), B))
    q, v, t = (np.array(x) for x in (st.qpos, st.qvel, st.t))
    rng = np.random.RandomState(1)
    for it in range(3):
        a = actions(rng, ts, B)
        p = _plain(ks, q, v, t, a)
        k = tuple(np.array(x) for x in kern(*(jnp.asarray(x) for x in (q, v, t, a))))
        x = _xla(xla, q, v, t, a)
        for name, i in (("qpos", 0), ("qvel", 1), ("reward", 3)):
            tol = TOL[name]
            np.testing.assert_allclose(p[i], k[i], rtol=0, atol=tol,
                                       err_msg=f"step {it} {name} vs kernel")
            spread = np.zeros_like(p[i])
            if name != "reward":
                z = zq if name == "qpos" else zv
                spread[:, z] = np.abs(k[i][:, z] - x[i][:, z])
            assert np.all(np.abs(p[i] - x[i]) <= tol + spread), (
                f"step {it} {name} vs XLA: {np.abs(p[i] - x[i]).max()}")
        for ref in (k, x):
            np.testing.assert_array_equal(p[2], ref[2])
            np.testing.assert_array_equal(p[4], ref[4])
        q, v, t = x[:3]


def test_ant_forward_matches_lane_engine():
    """One forward evaluation of the Ant model in the AntPush-v0 world with
    a leg on the block: the port's engine with contacts and the support
    against the JAX lane form the generic kernel runs."""
    env_id = "AntPush-v0"
    jspec = jmmt.make_spec(env_id)
    tspec = tmmt.make_spec(env_id, device="cpu")
    ks = engine_kernel.spec_from_env(tspec)
    q, v, _ = ant_kernel.block_states(tspec, 6, seed=11)
    qt = torch.as_tensor(q)
    on_block = ant_kernel.block_census(
        ant_kernel.spec_from_env(tspec), qt).numpy()
    e = int(np.argmax(on_block > 0))
    assert on_block[e] > 0
    ctrl = np.random.RandomState(11).uniform(-30, 30, 8).astype(np.float32)
    extra = tspec.world_extra_qfrc()
    got = engine.forward(tspec.dynamic_model, qt[e:e + 1],
                         torch.as_tensor(v[e:e + 1]),
                         torch.as_tensor(ctrl[None]), extra)[0].numpy()
    lw = le.world_from_spec(jspec)
    cols = lambda x: tuple(jnp.asarray(x)[i][None] for i in range(len(x)))
    ref = le.forward_lane(lw, cols(q[e]), cols(v[e]), cols(ctrl))
    ref = np.asarray([np.asarray(x)[0] for x in ref])
    rel = np.abs(got - ref).max() / (1 + float(np.abs(ref).max()))
    assert rel < 1e-5, f"rel err {rel}"
    assert ks.nv == len(ref)


@pytest.fixture(scope="module")
def arm():
    js, ts = specs("Arm")
    return js, ts, engine_kernel.spec_from_env(ts), jax.jit(jax.vmap(js.step))


def _arm_compare(arm, q, v, t, seed):
    js, ts, ks, xla = arm
    rng = np.random.RandomState(seed)
    for it in range(3):
        a = actions(rng, ts, B)
        p = _plain(ks, q, v, t, a)
        x = _xla(xla, q, v, t, a)
        for name, i in (("qpos", 0), ("qvel", 1), ("reward", 3)):
            np.testing.assert_allclose(p[i], x[i], rtol=0, atol=TOL[name],
                                       err_msg=f"step {it} {name}")
        np.testing.assert_array_equal(p[2], x[2])
        np.testing.assert_array_equal(p[4], x[4])
        q, v, t = x[:3]


def test_arm_robot_matches_jax_from_reset(arm):
    js = arm[0]
    st, _ = jax.vmap(js.reset)(jax.random.split(jax.random.PRNGKey(5), B))
    _arm_compare(arm, *(np.array(x) for x in (st.qpos, st.qvel, st.t)), seed=2)


def test_arm_robot_matches_jax_from_contact_states(arm):
    """The arm's tip on the floor (the ball joint's dofs in the contact
    rows) and the roller against the walls, within 6 m of the origin."""
    _, ts, ks, _ = arm
    q, v, t = engine_kernel.sphere_robot_states(ts, 12 * B, seed=9)
    near = np.argsort(np.hypot(q[:, 0], q[:, 1]), kind="stable")[:B]
    q, v, t = q[near], v[near], t[near]
    assert np.hypot(q[:, 0], q[:, 1]).max() < 6.0
    trace = engine_kernel.active_trace(ks, *(torch.as_tensor(x) for x in (
        q, v, np.zeros((B, ks.nu), np.float32))))
    nw = (ks.n_cand + 31) // 32
    words = trace[:, :, :nw].numpy().astype(np.int64) & 0xFFFFFFFF
    arm_spheres = [s for s in np.nonzero(ts.contact_set.sph_vs_static)[0]
                   if ts.contact_set.sph_body[s] == 1]
    static_of = {int(s): k for k, s in enumerate(
        np.nonzero(ts.contact_set.sph_vs_static)[0])}
    hit = [(words[..., b // 32] >> (b % 32)) & 1 for s in arm_spheres
           for b in [static_of[int(s)]]]
    assert np.any(hit)                   # the arm touches the floor
    _arm_compare(arm, q, v, t, seed=3)
