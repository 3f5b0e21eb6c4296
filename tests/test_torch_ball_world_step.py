"""Sphere-sphere contact rows and free object balls in the generic engine
step of the PyTorch port vs the JAX package.

The port's plain version (``engine_kernel.engine_step_plain``, what the
CUDA kernel is held against on the card) against the JAX package's
generic kernel in interpret mode (``engine_pallas.build_step_kernel``)
and its XLA step (``spec.step``), over 3 steps of seeded numpy actions,
from the JAX reset and from contact states, in two worlds:

* the Roller of ``examples/custom_robot.py`` in the SmallBilliard task
  (maze scaling 2.0), whose free ball meets the roller in one pair:
  ``engine_kernel.ball_states`` puts the ball against the roller (its
  sphere up to 0.15 into the roller's), pressed into a wall face or a
  corner, within half the goal threshold of the goal (terminated), or
  anywhere, spinning and rolling;
* the twin roller in the UMaze (``tests/_torch_engine.py``), whose pair
  joins two bodies of one robot: the twin 0.05-0.15 into the roller.

Bounds: the JAX package's own kernel-vs-XLA check of the Roller
(tests/test_engine_pallas.py): qpos 1e-5, qvel 1e-4, reward 1e-5,
terminated and t exact.  Each JAX kernel is built once per module at
B = 8.

Then one forward evaluation of the port's engine on an AntSmallBilliard-v0
state with the ball touching the Ant (built as tests/test_engine_pallas.py
builds it) against the JAX lane form ``lane_engine.forward_lane``, run
eagerly, at a relative 1e-5.  No JAX kernel is run on an Ant spec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import BALL_TASK, actions, jax_state, specs  # noqa: E402

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import engine_pallas as ep  # noqa: E402
from mujoco_maze_tpu.ops import lane_engine as le  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import engine_kernel  # noqa: E402
from mujoco_maze_tpu_torch.ops.ant_kernel import _box_dist  # noqa: E402
from mujoco_maze_tpu_torch.physics import contact, engine  # noqa: E402

B = 8
TOL = {"qpos": 1e-5, "qvel": 1e-4, "reward": 1e-5}


@pytest.fixture(scope="module", params=(BALL_TASK, "Twin"))
def world(request):
    js, ts = specs(request.param)
    kern = ep.build_step_kernel(ep.spec_from_env(js), B, tile=8)
    return (request.param, js, ts, engine_kernel.spec_from_env(ts), kern,
            jax.jit(jax.vmap(js.step)))


def _compare(world, q, v, t, seed, steps=3):
    """Steps both sides teacher-forced from (q, v, t) against the JAX
    kernel and the XLA path; returns the XLA path's first terminated."""
    name, js, ts, ks, kern, xla = world
    rng = np.random.RandomState(seed)
    first = None
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
        first = xm if first is None else first
        q, v, t = (np.array(x) for x in (xq, xv, xt))
    return first


def _twin_states(ts, seed):
    """The roller as ``sphere_robot_states`` draws it, the twin beside it
    on the floor with its sphere 0.05-0.15 into the roller's, clear of the
    walls."""
    q, v, t = engine_kernel.sphere_robot_states(ts, B, seed)
    rng = np.random.RandomState(seed)
    cs = ts.contact_set
    base = ts.dynamic_model.body_pos
    for e in range(B):
        c0 = q[e, :3] + base[0]
        for _ in range(200):
            ang = rng.uniform(0.0, 2 * np.pi)
            c1 = c0 + (0.8 - rng.uniform(0.05, 0.15)) * np.array(
                [np.cos(ang), np.sin(ang), 0.0])
            if _box_dist(c1[None], np.array([0.4]), cs.box_center,
                         cs.box_half).min() > -0.02:
                break
        q[e, 3:6] = c1 - base[1]
    return q, v, t


def _pair_active(ks, q, v):
    """Per env: the pair rows active at the first forward evaluation."""
    trace = engine_kernel.active_trace(ks, *(torch.as_tensor(x) for x in (
        q, v, np.zeros((B, ks.nu), np.float32))))
    spec = ks.env_spec
    groups = int(spec.contact_set.has_floor) + min(ks.offsets["box"][1], 2)
    i = groups * ks.n_static          # the first sphere-sphere pair
    return (trace[:, 0, i // 32].numpy() >> (i % 32)) & 1


def test_matches_jax_from_reset(world):
    _, js, _, _, _, _ = world
    st, _ = jax.vmap(js.reset)(jax.random.split(jax.random.PRNGKey(3), B))
    _compare(world, *(np.array(x) for x in (st.qpos, st.qvel, st.t)), seed=0)


def test_matches_jax_from_contact_states(world):
    """From pair contacts, walls and the goal: the pair row is active where
    the states put the two spheres together, the ball meets a wall where
    they press it into one, and the XLA path's first step ends the
    episodes whose ball starts on the goal."""
    name, _, ts, ks, _, _ = world
    if name == "Twin":
        q, v, t = _twin_states(ts, seed=5)
        assert _pair_active(ks, q, v).all()
        _compare(world, q, v, t, seed=6)
        return
    q, v, t = engine_kernel.ball_states(ts, B, seed=5)
    assert _pair_active(ks, q, v)[0::4].all()          # against the roller
    nw = (ks.n_cand + 31) // 32
    trace = engine_kernel.active_trace(ks, *(torch.as_tensor(x) for x in (
        q, v, np.zeros((B, ks.nu), np.float32))))[:, 0, :nw].numpy()
    ball = 1                                           # its static index
    walls = [(g * ks.n_static + ball) for g in (1, 2)]
    on_wall = sum((trace[:, w // 32] >> (w % 32)) & 1 for w in walls)
    assert on_wall[1::4].all()                         # pressed into a wall
    assert np.abs(v[:, 6:9]).max() > 1.0               # spinning
    terminated = _compare(world, q, v, t, seed=6)
    assert terminated[2::4].all()                      # on the goal


def test_forward_matches_lane_engine_on_the_ant_ball_world():
    """One forward evaluation, the Ant's legs on the free ball (every
    robot-ball pair row among the candidates), against the JAX lane form:
    the Ant's 14 dofs, the ball's 6x6 block and bias, the pair rows."""
    spec = jmmt.make_spec("AntSmallBilliard-v0")
    ts = tmmt.make_spec("AntSmallBilliard-v0", device="cpu")
    model = spec.dynamic_model
    rng = np.random.RandomState(0)
    qp = np.asarray(model.qpos0).copy()
    qp[:15] += rng.uniform(-0.08, 0.08, 15)
    qp[3:7] /= np.linalg.norm(qp[3:7])
    qp[15:17] = qp[:2] + rng.uniform(-0.5, 0.5, 2)   # ball touching the ant
    qv = rng.randn(model.nv) * 0.3
    ct = rng.uniform(-30, 30, 8)

    def cols(x):
        return tuple(jnp.asarray(x, jnp.float32)[i][None] for i in range(len(x)))

    want = np.asarray([np.asarray(x)[0] for x in le.forward_lane(
        le.world_from_spec(spec), cols(qp), cols(qv), cols(ct))])
    tq, tv, tc = (torch.as_tensor(np.asarray(x, np.float32))[None]
                  for x in (qp, qv, ct))
    got = engine.forward(ts.dynamic_model, tq, tv, tc,
                         ts.world_extra_qfrc())[0].numpy()
    rel = np.abs(got - want).max() / (1.0 + np.abs(want).max())
    assert rel < 1e-5, f"rel err {rel}"
    _, chain_mask, _, _ = engine.get_masks(ts.dynamic_model)
    act = contact.active_candidates(
        ts.dynamic_model, ts.contact_set,
        engine.kin_dyn(ts.dynamic_model, tq, tv), chain_mask)[0].numpy()
    n_static = int(np.sum(ts.contact_set.sph_vs_static))
    first_pair = 3 * n_static
    assert act[first_pair:first_pair + 37].any()     # legs on the ball
