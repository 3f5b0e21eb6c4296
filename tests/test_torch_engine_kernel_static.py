"""The generic engine kernel of the PyTorch port vs the JAX package: static
data, dispatch, refusals and the device rule.

For the seven worlds of the census (the Roller of ``examples/
custom_robot.py`` in the UMaze, Push, Fall, BlockCarry and 4Rooms tasks;
the Ant model's AntUMaze-v0 and AntPush-v0 / AntFall-v0 worlds), the
port's lowered tables (``convert.lowered_spec`` of
``engine_kernel.spec_from_env``) against the JAX package's
``engine_pallas.spec_from_env``: ints and bools exact, float arrays equal
in float32.  Nothing is traced.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import TorchArmRoller, specs  # noqa: E402

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import engine_pallas as ep  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec  # noqa: E402
from mujoco_maze_tpu_torch.examples.custom_robot import (  # noqa: E402
    RollerRobot, make_roller_umaze)
from mujoco_maze_tpu_torch.models.swimmer import SwimmerRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import (engine_kernel, lane_env,  # noqa: E402
                                       make_fast_rollout, make_fast_step)
from mujoco_maze_tpu_torch.physics.contact import candidate_count  # noqa: E402
from mujoco_maze_tpu_torch.tasks.library import GoalRewardUMaze  # noqa: E402

# world -> (nq, nv, static boxes, moving boxes, falling blocks, obs offset)
WORLDS = {
    "GoalRewardUMaze": (3, 3, 18, 0, 0, 0),
    "GoalRewardPush": (5, 5, 19, 1, 0, 0),
    "GoalRewardFall": (5, 5, 38, 1, 1, 0),
    "GoalRewardBlockCarry": (5, 5, 16, 1, 0, 3),
    "GoalReward4Rooms": (3, 3, 41, 0, 0, 0),
    "AntUMaze-v0": (15, 14, 18, 0, 0, 0),
    "AntPush-v0": (17, 16, 19, 1, 0, 0),
    "AntFall-v0": (17, 16, 38, 1, 1, 0),
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
    if world.startswith("Ant"):
        js = jmmt.make_spec(world)
        ts = tmmt.make_spec(world, device="cpu")
    else:
        js, ts = specs(world)
    ks = engine_kernel.spec_from_env(ts)
    return world, ep.spec_from_env(js), ts, ks, convert.lowered_spec(ks)


def test_census(sides):
    world, es, ts, ks, low = sides
    nq, nv, nbox, ndbox, nfall, off = WORLDS[world]
    assert (ks.nq, ks.nv) == (nq, nv)
    assert len(low["lw.box_center"]) == len(es.lw.box_center) == nbox
    assert len(low["lw.dbox_body"]) == len(es.lw.dbox_body) == ndbox
    assert len(low["lw.falling"]) == len(es.lw.falling) == nfall
    assert ks.obs_offset == off
    assert ks.n_cand == candidate_count(ts.contact_set)


def test_scalars_and_goals(sides):
    _, es, _, _, low = sides
    for name in SCALARS:
        want = getattr(es, name)
        got = low[name]
        if isinstance(want, tuple):
            assert tuple(got) == tuple(want), name
        else:
            assert got == want and type(got) is type(want), name
    for name in GOALS:
        np.testing.assert_array_equal(low[name], np.asarray(getattr(es, name)),
                                      err_msg=name)


def test_lane_world(sides):
    _, es, _, _, low = sides
    lw = es.lw
    for name in ("sph_body", "pair_i", "pair_j", "dbox_body", "qpair_s",
                 "qpair_b"):
        np.testing.assert_array_equal(low[f"lw.{name}"],
                                      np.asarray(getattr(lw, name), np.int64),
                                      err_msg=name)
    np.testing.assert_array_equal(low["lw.sph_vs_static"], lw.sph_vs_static)
    for name in ("sph_local", "sph_radius", "sph_margin", "sph_friction",
                 "sph_solimp", "box_center", "box_half", "box_margin",
                 "dbox_local", "dbox_half", "dbox_margin", "dbox_solref",
                 "dbox_solimp", "dbox_friction"):
        np.testing.assert_array_equal(low[f"lw.{name}"],
                                      f32(getattr(lw, name)).reshape(
                                          low[f"lw.{name}"].shape),
                                      err_msg=name)
    # the kernels read the solref time constant clamped to 2 dt, as the JAX
    # lane form's solpar does
    tc = np.maximum(f32(lw.sph_solref[:, 0]),
                    np.float32(2.0 * lw.model.timestep))
    np.testing.assert_array_equal(low["lw.sph_solref"][:, 0], tc)
    np.testing.assert_array_equal(low["lw.sph_solref"][:, 1],
                                  f32(lw.sph_solref[:, 1]))
    assert low["lw.has_floor"] is bool(lw.has_floor)
    assert low["lw.floor_margin"] == lw.floor_margin
    got = low["lw.falling"]
    assert len(got) == len(lw.falling)
    for (b, zd, hz, plats), (jb, jzd, jhz, jplats) in zip(got, lw.falling):
        assert (b, zd) == (jb, jzd)
        assert np.float32(hz) == np.float32(jhz)
        np.testing.assert_array_equal(f32(plats), f32(jplats))


def test_model_tables(sides):
    _, es, _, _, low = sides
    m = es.lw.model
    for name in ("body_parent", "jnt_type", "jnt_qposadr", "jnt_dofadr",
                 "act_dofadr"):
        np.testing.assert_array_equal(low[f"lw.model.{name}"],
                                      np.asarray(getattr(m, name), np.int64),
                                      err_msg=name)
    for name in ("body_pos", "body_mass", "body_com", "jnt_axis", "jnt_pos",
                 "dof_armature", "dof_damping", "act_gear", "act_ctrlrange"):
        np.testing.assert_array_equal(low[f"lw.model.{name}"],
                                      f32(getattr(m, name)), err_msg=name)
    # the table keeps the inertia's upper triangle (its lower one differs
    # from it by float64 rounding, ~1e-19, in the capsules' frames)
    upper = np.triu(np.asarray(m.body_inertia))
    np.testing.assert_array_equal(
        low["lw.model.body_inertia"],
        f32(upper + np.transpose(np.triu(upper, 1), (0, 2, 1))))
    limited = np.asarray(m.jnt_limited)
    np.testing.assert_array_equal(low["lw.model.jnt_range"][limited],
                                  f32(m.jnt_range)[limited])
    w, x, y, z = np.asarray(m.body_quat, np.float64).T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y), 2 * (x * y + w * z),
                    1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)], axis=1).reshape(-1, 3, 3)
    np.testing.assert_array_equal(low["lw.model.body_rot"], f32(rot))


def test_pair_constants(sides):
    """The pair table mixes the sphere's and the moving box's constants as
    the JAX lane form mixes them (lane_engine.py:608-626)."""
    _, es, _, _, low = sides
    lw = es.lw
    s, b = np.asarray(lw.qpair_s), np.asarray(lw.qpair_b)
    np.testing.assert_array_equal(
        low["pair.margin"], f32(lw.sph_margin[s] + lw.dbox_margin[b]))
    np.testing.assert_array_equal(
        low["pair.friction"],
        f32(np.maximum(lw.sph_friction[s], lw.dbox_friction[b])))
    np.testing.assert_array_equal(
        low["pair.solimp"], f32((lw.sph_solimp[s] + lw.dbox_solimp[b]) / 2))
    srf = (lw.sph_solref[s] + lw.dbox_solref[b]) / 2
    np.testing.assert_array_equal(
        low["pair.solref"][:, 0],
        np.maximum(f32(srf[:, 0]), np.float32(2.0 * lw.model.timestep)))
    np.testing.assert_array_equal(low["pair.solref"][:, 1], f32(srf[:, 1]))


def test_params_struct(sides):
    _, _, ts, ks, _ = sides
    p = lane_env.engine_params(ks)
    assert (p.nq, p.nv, p.nu) == (ks.nq, ks.nv, ks.nu)
    assert p.n_floats == ks.packed.numel()
    assert p.n_cand == ks.n_cand
    assert p.n_static == int(np.sum(ts.contact_set.sph_vs_static))
    assert p.trace_words == 3 * ((ks.n_cand + 31) // 32) + 1
    assert p.row_floats == 3 * ks.nv + engine_kernel.ROW_FIXED
    assert (p.head_q0, p.head_q1, p.head_q2) == ks.head_qadr


def test_dispatch():
    """A custom engine robot goes to the generic kernel; it has no rollout
    kernel, as in the JAX package; the stock robots keep theirs."""
    env = make_roller_umaze(8, device="cpu")
    assert isinstance(env._kernel_step, lane_env.EngineStep)
    assert isinstance(make_fast_step(env).ks, engine_kernel.EngineKernelSpec)
    with pytest.raises(NotImplementedError, match="step-only"):
        make_fast_rollout(env, 4)
    for env_id, kind in (("PointUMaze-v0", lane_env.PointStep),
                         ("AntUMaze-v0", lane_env.AntStep),
                         ("SwimmerUMaze-v0", lane_env.SwimmerStep)):
        assert isinstance(make_fast_step(tmmt.make_batched(env_id, 2,
                                                           device="cpu")),
                          kind)


class _Eel(SwimmerRobot):
    """Neither a known robot nor an engine-world robot."""

    NAME = "Eel"


def test_refusals(monkeypatch):
    """The twin roller (two rollers on slides of their own: unrelated
    bodies with spheres) lowers its one sphere-sphere pair as the JAX
    package does; the generic kernel refuses what it does not serve."""
    jtwin, twin = specs("Twin")
    assert len(twin.contact_set.pair_i) == 1
    es, ks = ep.spec_from_env(jtwin), engine_kernel.spec_from_env(twin)
    low = convert.lowered_spec(ks)
    assert ks.offsets["spair"][1] == 1 and ks.n_cand == 7
    lw = es.lw
    for name in ("pair_i", "pair_j", "sph_body"):
        np.testing.assert_array_equal(low[f"lw.{name}"],
                                      np.asarray(getattr(lw, name), np.int64))
    i, j = np.asarray(lw.pair_i), np.asarray(lw.pair_j)
    np.testing.assert_array_equal(low["spair.margin"],
                                  f32(lw.sph_margin[i] + lw.sph_margin[j]))
    np.testing.assert_array_equal(low["spair.solimp"],
                                  f32((lw.sph_solimp[i] + lw.sph_solimp[j]) / 2))
    for name in ("head_qadr", "head_base", "nq", "nv", "nu"):
        assert tuple(np.atleast_1d(low[name])) == tuple(
            np.atleast_1d(getattr(es, name))), name
    eel = MazeEnvSpec(_Eel(), GoalRewardUMaze, 4.0, device="cpu")
    with pytest.raises(NotImplementedError, match="neither a known robot"):
        BatchedMazeEnv(eel, 2)
    with pytest.raises(NotImplementedError, match="engine-world"):
        engine_kernel.spec_from_env(eel)
    roller = MazeEnvSpec(RollerRobot(), GoalRewardUMaze, 4.0, device="cpu")
    monkeypatch.setattr(roller.task, "sample_goals", lambda: True)
    with pytest.raises(NotImplementedError, match="item 8"):
        engine_kernel.spec_from_env(roller)


def test_arm_robot_lowers():
    """The ball-jointed test robot: a ball joint's 4 coordinates and 3 dofs,
    and the fluid constants in the body table."""
    _, ts = specs("Arm")
    ks = engine_kernel.spec_from_env(ts)
    assert (ks.nq, ks.nv) == (7, 6) and isinstance(ts.robot, TorchArmRoller)
    body = ks.table("body")
    assert np.all(body[:, 26:34] != 0.0)


def test_device_rule(monkeypatch):
    """The extension API's entry points run on CUDA unless asked for the
    CPU: without a card they raise instead of carrying on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MazeEnvSpec(RollerRobot(), GoalRewardUMaze, 4.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_roller_umaze(8)
    assert MazeEnvSpec(RollerRobot(), GoalRewardUMaze, 4.0,
                       device="cpu").device.type == "cpu"
    env = make_roller_umaze(8, device="cpu")
    state, obs = env.reset(0)
    assert tuple(obs.shape) == (8, 7) and state.qpos.device.type == "cpu"


def test_params_struct_mirrors_the_header():
    """``lane_env.EngineParams`` passes by value what ``struct EngineParams``
    of ``csrc/engine_lane.cuh`` declares, field for field and type for
    type (a mismatch would show only on the card)."""
    import ctypes
    import pathlib
    import re

    header = (pathlib.Path(engine_kernel.__file__).parent.parent / "csrc"
              / "engine_lane.cuh").read_text()
    body = re.search(r"struct EngineParams \{(.*?)\};", header, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        kind, names = decl.split(None, 1)
        fields += [(n.strip(), kind) for n in names.split(",")]
    ctype = {ctypes.c_int: "int", ctypes.c_float: "float"}
    assert fields == [(n, ctype[t]) for n, t in lane_env.EngineParams._fields_]
