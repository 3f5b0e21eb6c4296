"""The Ant world of the PyTorch port vs the JAX package: static data.

On AntUMaze-v0 and Ant4Rooms-v0: the composed ``RigidModel`` arrays and
the contact set (spheres, boxes, floor) are equal to the JAX package's;
the effective dof masses ``_dof_meff`` agree at rtol 1e-5 (both sides
build M in float32 and invert it in float64; their float32 products round
differently); the Ant kernels' lowered tables equal, in float32, what the
JAX kernel reads from ``ant_math.consts_from_model``,
``ant_math.world_from_spec(n_near_boxes=4)`` and
``ant_pallas.spec_from_env``.  And over the registry: each of the 21
object-free Ant IDs and each of the 21 with movable blocks builds on the
CPU, and each of the 3 with object balls raises ``NotImplementedError``
naming its ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import ant_pallas  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_step  # noqa: E402

IDS = ["AntUMaze-v0", "Ant4Rooms-v0"]
ANT_IDS = [i for i in tmmt.env_ids() if tmmt.entry(i).robot_name == "Ant"]
OBJECT_FREE = [
    "AntSimpleRoom-v0", "AntSimpleRoom-v1", "AntSquareRoom-v0",
    "AntSquareRoom-v1", "AntSquareRoom-v2", "AntUMaze-v0", "AntUMaze-v1",
    "Ant2Rooms-v0", "Ant2Rooms-v1", "Ant2Rooms-v2", "Ant4Rooms-v0",
    "Ant4Rooms-v1", "Ant4Rooms-v2", "AntTRoom-v0", "AntTRoom-v1",
    "AntTRoom-v2", "AntCorridor-v0", "AntCorridor-v1", "AntCorridor-v2",
    "AntLongCorridor-v0", "AntLongCorridor-v1",
]
MODEL_FIELDS = (
    "nbody", "body_parent", "body_pos", "body_quat", "body_mass", "body_com",
    "body_inertia", "njnt", "jnt_type", "jnt_body", "jnt_axis", "jnt_pos",
    "jnt_qposadr", "jnt_dofadr", "jnt_limited", "jnt_range", "nq", "nv",
    "dof_armature", "dof_damping", "nu", "act_dofadr", "act_gear",
    "act_ctrlrange", "gravity", "timestep", "viscosity", "fluid_density",
    "qpos0", "body_fluid_box",
)


@pytest.fixture(scope="module", params=IDS)
def sides(request):
    jspec = jmmt.make_spec(request.param)
    tspec = tmmt.make_spec(request.param, device="cpu")
    return jspec, tspec


def test_registry_lists_the_object_free_ant_ids():
    assert len(ANT_IDS) == 45
    assert set(OBJECT_FREE) <= set(ANT_IDS)


def test_rigid_model_matches(sides):
    jspec, tspec = sides
    jm, tm = jspec.dynamic_model, tspec.dynamic_model
    for name in MODEL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert [b for b, _ in tm.geoms] == [b for b, _ in jm.geoms]
    for tg, jg in zip([g for _, g in tm.geoms] + tm.static_geoms,
                      [g for _, g in jm.geoms] + jm.static_geoms):
        for f in dataclasses.fields(jg):
            np.testing.assert_array_equal(np.asarray(getattr(tg, f.name)),
                                          np.asarray(getattr(jg, f.name)),
                                          err_msg=f.name)
    assert len(tm.static_geoms) == len(jm.static_geoms)
    np.testing.assert_allclose(tm._dof_meff, jm._dof_meff, rtol=1e-5)
    assert (tspec.nq, tspec.nv, tspec.obs_dim) == (jspec.nq, jspec.nv,
                                                   jspec.obs_dim) == (15, 14, 30)
    np.testing.assert_array_equal(tspec.init_qpos, jspec.init_qpos)


def test_contact_set_matches(sides):
    jspec, tspec = sides
    jc, tc = jspec.contact_set, tspec.contact_set
    assert jc._fields == tc._fields
    for name in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    assert len(tc.sph_body) == 37


def test_lowered_tables_match_the_jax_kernel(sides):
    jspec, tspec = sides
    es = ant_pallas.spec_from_env(jspec)
    ks = make_fast_step(tmmt.make_batched(tspec_id(tspec), 2, device="cpu")).ks
    ours = convert.lowered_spec(ks)
    checked = 0
    for name, val in ours.items():
        src = (es.ac if name in es.ac._fields
               else es.aw if name in es.aw._fields else es)
        ref = getattr(src, name)
        if name == "inertias":
            # the kernel reads the upper triangle of the (symmetric) inertia
            ref = np.asarray(ref)
            np.testing.assert_allclose(ref, np.swapaxes(ref, 1, 2), atol=1e-12)
            iu = np.triu_indices(3)
            ref, val = ref[:, iu[0], iu[1]], val[:, iu[0], iu[1]]
        if isinstance(ref, (np.ndarray, tuple, list)):
            ref = np.asarray(ref)
            if ref.dtype.kind == "f":
                ref = ref.astype(np.float32)
            np.testing.assert_array_equal(np.asarray(val), ref, err_msg=name)
        elif isinstance(ref, float):
            assert np.float32(val) == np.float32(ref), name
        else:
            assert val == ref, name
        checked += 1
    assert checked == len(ours) >= 40
    # the JAX kernel tests each sphere against the 4 boxes nearest the
    # torso; the port's against every box within the ant's reach of it
    assert es.aw.n_near_boxes == 4 and 1.0 < ks.reach < 1.5
    assert es.solver_iters == ks.solver_iters == 4


def tspec_id(tspec):
    for env_id in IDS:
        e = tmmt.entry(env_id)
        if type(tspec.task) is e.task_cls and tspec.task.scale == e.maze_size_scaling:
            return env_id
    raise KeyError(tspec)


@pytest.mark.parametrize("env_id", ANT_IDS)
def test_object_free_ant_ids_build_and_the_rest_are_queued(env_id):
    """The object-free and the block-world Ant IDs build (the block worlds'
    static data: tests/test_torch_ant_blocks_static.py); so do the three
    with a free object ball (their static data:
    tests/test_torch_ball_world_static.py)."""
    if env_id in OBJECT_FREE:
        spec = tmmt.make_spec(env_id, device="cpu")
        assert (spec.nq, spec.nv, spec.obs_dim) == (15, 14, 30)
        assert len(spec.contact_set.sph_body) == 37
        assert len(spec.contact_set.box_center) == len(spec.structure.block_pos) > 0
    elif "Billiard" not in env_id:
        spec = tmmt.make_spec(env_id, device="cpu")
        assert spec.nq > 15 and spec.nv == spec.nq - 1
        assert spec.block_runtimes
    else:
        spec = tmmt.make_spec(env_id, device="cpu")
        assert (spec.nq, spec.nv, spec.obs_dim) == (22, 20, 33)
        assert len(spec.contact_set.pair_i) == 37
