"""Free object balls in the PyTorch port's engine world vs the JAX package:
static data.

For the Roller of ``examples/custom_robot.py`` in the SmallBilliard task
(maze scaling 2.0, the task's own for engine-world robots) and the three
AntSmallBilliard IDs: the contact set (the sphere-sphere pairs and every
test sphere's constants), the composed model (the ball's free tree, its
mass and its sphere's fixed solimp), the ball's runtime and the
observation width equal the JAX package's; and the generic engine
kernel's lowered tables (``convert.lowered_spec`` of
``engine_kernel.spec_from_env``) equal the JAX package's
``engine_pallas.spec_from_env``, field by field, the heads' anchor on the
ball included: ints and bools exact, floats equal in float32.  Nothing is
traced.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import BALL_TASK, specs  # noqa: E402

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import engine_pallas as ep  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import engine_kernel, lane_env  # noqa: E402
from mujoco_maze_tpu_torch.physics.contact import candidate_count  # noqa: E402

# world -> (nq, nv, bodies, sphere-sphere pairs, candidates, obs_dim)
WORLDS = {
    "Roller": (10, 9, 2, 1, 7, 10),
    "AntSmallBilliard-v0": (22, 20, 14, 37, 151, 33),
    "AntSmallBilliard-v1": (22, 20, 14, 37, 151, 33),
    "AntSmallBilliard-v2": (22, 20, 14, 37, 151, 33),
}
SCALARS = ("nq", "nv", "nu", "reward_type", "penalty", "scale", "inner_scale",
           "frame_skip", "episode_limit", "solver_iters", "fwd_weight",
           "ctrl_cost", "obs_offset", "head_qadr", "head_base",
           "dynamic_goals")
GOALS = ("goal_pos", "goal_dim_mask", "goal_threshold", "goal_scale",
         "goal_valid")


def f32(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=sorted(WORLDS))
def sides(request):
    world = request.param
    if world == "Roller":
        js, ts = specs(BALL_TASK)
    else:
        js, ts = jmmt.make_spec(world), tmmt.make_spec(world, device="cpu")
    ks = engine_kernel.spec_from_env(ts)
    return world, js, ts, ks, ep.spec_from_env(js), convert.lowered_spec(ks)


def test_census(sides):
    world, js, ts, ks, _, _ = sides
    nq, nv, nb, n_pair, n_cand, obs_dim = WORLDS[world]
    assert (ts.nq, ts.nv, ts.dynamic_model.nbody) == (nq, nv, nb)
    assert (js.nq, js.nv) == (nq, nv)
    assert len(ts.contact_set.pair_i) == n_pair
    assert ks.n_cand == candidate_count(ts.contact_set) == n_cand
    assert ks.offsets["spair"][1] == n_pair and ks.offsets["pair"][1] == 0
    assert ts.obs_dim == js.obs_dim == obs_dim


def test_contact_set(sides):
    """The pairs exactly, each test sphere's constants equal."""
    _, js, ts, _, _, _ = sides
    jc, tc = js.contact_set, ts.contact_set
    for name in tc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    # every ball sphere meets every robot sphere
    ball = tc.sph_body[-1]
    robot = np.flatnonzero(tc.sph_body != ball)
    np.testing.assert_array_equal(tc.pair_i, robot)
    np.testing.assert_array_equal(tc.pair_j, np.full(len(robot), len(robot)))


def test_model_and_the_free_ball(sides):
    """The composed model's tree, the ball's free joint at its cell's
    centre on the floor, its mass and its sphere's fixed solimp."""
    _, js, ts, _, _, _ = sides
    jm, tm = js.dynamic_model, ts.dynamic_model
    for name in ("body_parent", "jnt_type", "jnt_body", "jnt_qposadr",
                 "jnt_dofadr"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in ("body_pos", "body_mass", "body_com", "body_inertia",
                 "qpos0"):
        np.testing.assert_array_equal(f32(getattr(tm, name)),
                                      f32(getattr(jm, name)), err_msg=name)
    ob = ts.structure.object_balls[0]
    assert int(tm.jnt_type[-1]) == 0            # FREE
    a = int(tm.jnt_qposadr[-1])
    np.testing.assert_array_equal(tm.qpos0[a:a + 7],
                                  [ob.pos[0], ob.pos[1], 0, 1, 0, 0, 0])
    r = ob.size
    np.testing.assert_allclose(
        tm.body_mass[-1],
        ts.robot.WORLD_GEOM_DEFAULTS.get("density", 1000.0) * 4.0 / 3.0
        * np.pi * r ** 3,
        rtol=1e-12)
    np.testing.assert_array_equal(ts.contact_set.sph_solimp[-1],
                                  (0.9, 0.99, 0.001))
    np.testing.assert_array_equal(ts.contact_set.sph_local[-1], (0, 0, r))


def test_ball_runtimes_and_obs(sides):
    _, js, ts, _, _, _ = sides
    (tb,), (jb,) = ts.ball_runtimes, js.ball_runtimes
    assert (tb.kind, tb.qpos_idx, tb.size) == (jb.kind, jb.qpos_idx, jb.size)
    assert tb.kind == "free" and tb.qpos_idx == (ts.nq - 7,)
    np.testing.assert_array_equal(f32(tb.body_pos), np.asarray(jb.body_pos))
    q = torch.as_tensor(np.tile(ts.dynamic_model.qpos0, (2, 1)),
                        dtype=torch.float32)
    q[1, ts.nq - 7:ts.nq - 4] += torch.tensor([0.3, -0.2, 0.1])
    np.testing.assert_array_equal(ts.ball_center3(q, tb).numpy(),
                                  q[:, ts.nq - 7:ts.nq - 4].numpy())


def test_lowered_scalars_goals_and_anchor(sides):
    """The heads read the ball's body origin, qpos[adr:adr + 3], at a zero
    base (JAX engine_pallas.py:78-92)."""
    _, _, ts, ks, es, low = sides
    for name in SCALARS:
        want, got = getattr(es, name), low[name]
        if isinstance(want, tuple):
            assert tuple(got) == tuple(want), name
        else:
            assert got == want and type(got) is type(want), name
    for name in GOALS:
        np.testing.assert_array_equal(low[name], np.asarray(getattr(es, name)),
                                      err_msg=name)
    a = ts.nq - 7
    assert ks.head_qadr == (a, a + 1, a + 2) and ks.head_base == (0.0,) * 3
    p = lane_env.engine_params(ks)
    assert (p.head_q0, p.head_q1, p.head_q2) == (a, a + 1, a + 2)
    assert (p.n_spair, p.n_pair) == (ks.offsets["spair"][1], 0)


def test_lowered_world_and_pair_constants(sides):
    """The lane world's arrays, and the sphere-sphere table's constants
    mixed as the JAX lane form mixes them (lane_engine.py:588-600)."""
    _, _, _, _, es, low = sides
    lw = es.lw
    for name in ("sph_body", "pair_i", "pair_j"):
        np.testing.assert_array_equal(low[f"lw.{name}"],
                                      np.asarray(getattr(lw, name), np.int64),
                                      err_msg=name)
    for name in ("sph_local", "sph_radius", "sph_margin", "sph_friction",
                 "sph_solimp", "box_center", "box_half", "box_margin"):
        np.testing.assert_array_equal(low[f"lw.{name}"],
                                      f32(getattr(lw, name)).reshape(
                                          low[f"lw.{name}"].shape),
                                      err_msg=name)
    for name in ("body_parent", "jnt_type", "jnt_qposadr", "jnt_dofadr"):
        np.testing.assert_array_equal(
            low[f"lw.model.{name}"],
            np.asarray(getattr(lw.model, name), np.int64), err_msg=name)
    for name in ("body_pos", "body_mass", "body_com", "dof_armature"):
        np.testing.assert_array_equal(low[f"lw.model.{name}"],
                                      f32(getattr(lw.model, name)),
                                      err_msg=name)
    i, j = np.asarray(lw.pair_i), np.asarray(lw.pair_j)
    np.testing.assert_array_equal(low["spair.margin"],
                                  f32(lw.sph_margin[i] + lw.sph_margin[j]))
    np.testing.assert_array_equal(
        low["spair.friction"],
        f32(np.maximum(lw.sph_friction[i], lw.sph_friction[j])))
    np.testing.assert_array_equal(
        low["spair.solimp"], f32((lw.sph_solimp[i] + lw.sph_solimp[j]) / 2))
    srf = (lw.sph_solref[i] + lw.sph_solref[j]) / 2
    np.testing.assert_array_equal(
        low["spair.solref"][:, 0],
        np.maximum(f32(srf[:, 0]), np.float32(2.0 * lw.model.timestep)))
    np.testing.assert_array_equal(low["spair.solref"][:, 1], f32(srf[:, 1]))
