"""The Point object worlds of the PyTorch port vs the JAX package: static data.

For each of the 27 Point IDs with movable blocks or hinge balls (Push,
MultiPush, MultiPushSmall, PushMaze, Fall, MultiFall-v2, BlockMaze,
BlockCarry, Billiard, SmallBilliard): nq and nv, the qpos addresses of the
blocks' slides and the balls' dofs, the reduced solve's dof order
(``_object_dof_idx``), the observation width, the reset observation
against the JAX ``_observe`` of the same state, and the lowered object
solve (``convert.lowered_spec``) against the JAX package's
``object_lanes.spec_from_env`` field by field, and against its Pallas
``point_pallas.spec_from_env``.  Each ID is built once per module on both
sides; nothing is traced.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.envs.env import EnvState as JEnvState  # noqa: E402
from mujoco_maze_tpu.ops import object_lanes as jol  # noqa: E402
from mujoco_maze_tpu.ops import point_pallas  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import object_lanes, point_kernel  # noqa: E402

# (ID): (nq, object dofs, balls, blocks, z slides, candidate rows R of one
# forward evaluation, obs width, heads' offset)
CENSUS = {
    "PointPush-v0": (5, 2, 0, 1, 0, 180, 10, 0),
    "PointPush-v1": (5, 2, 0, 1, 0, 180, 10, 0),
    "PointMultiPush-v0": (7, 4, 0, 2, 0, 528, 13, 0),
    "PointMultiPush-v1": (7, 4, 0, 2, 0, 528, 13, 0),
    "PointMultiPush-v2": (7, 4, 0, 2, 0, 528, 13, 0),
    "PointMultiPushSmall-v0": (9, 6, 0, 3, 0, 604, 16, 0),
    "PointMultiPushSmall-v1": (9, 6, 0, 3, 0, 604, 16, 0),
    "PointMultiPushSmall-v2": (9, 6, 0, 3, 0, 604, 16, 0),
    "PointPushMaze-v0": (9, 6, 0, 3, 0, 676, 16, 0),
    "PointPushMaze-v1": (9, 6, 0, 3, 0, 676, 16, 0),
    "PointPushMaze-v2": (9, 6, 0, 3, 0, 676, 16, 0),
    "PointFall-v0": (5, 2, 0, 1, 1, 156, 10, 0),
    "PointFall-v1": (5, 2, 0, 1, 1, 156, 10, 0),
    "PointMultiFall-v2": (5, 2, 0, 1, 1, 156, 10, 0),
    "PointBlockMaze-v0": (5, 2, 0, 1, 0, 116, 10, 0),
    "PointBlockMaze-v1": (5, 2, 0, 1, 0, 116, 10, 0),
    "PointBlockCarry-v0": (5, 2, 0, 1, 0, 156, 10, 3),
    "PointBlockCarry-v1": (5, 2, 0, 1, 0, 156, 10, 3),
    "PointBlockCarry-v2": (5, 2, 0, 1, 0, 156, 10, 3),
    "PointBilliard-v0": (6, 3, 1, 0, 0, 108, 10, 3),
    "PointBilliard-v1": (6, 3, 1, 0, 0, 108, 10, 3),
    "PointBilliard-v2": (6, 3, 1, 0, 0, 108, 10, 3),
    "PointBilliard-v3": (6, 3, 1, 0, 0, 124, 10, 3),
    "PointBilliard-v4": (6, 3, 1, 0, 0, 108, 10, 3),
    "PointSmallBilliard-v0": (6, 3, 1, 0, 0, 76, 10, 3),
    "PointSmallBilliard-v1": (6, 3, 1, 0, 0, 76, 10, 3),
    "PointSmallBilliard-v2": (6, 3, 1, 0, 0, 76, 10, 3),
}
ANT_BALLS = ("AntSmallBilliard-v0", "AntSmallBilliard-v1", "AntSmallBilliard-v2")
CONSTANTS = ("nd", "masses", "sphere_r", "sphere_z", "invw_r", "arrow_off",
             "arrow_half_l", "arrow_half_w", "arrow_z_lo", "arrow_z_hi", "dt",
             "mu", "tc", "zeta", "dmin", "dmax", "width", "f_dmin", "f_dmax",
             "f_width", "newton_iters", "ls_iters")


@pytest.fixture(scope="module", params=sorted(CENSUS))
def sides(request):
    jspec = jmmt.make_spec(request.param)
    tspec = tmmt.make_spec(request.param, device="cpu")
    ks = point_kernel.spec_from_env(tspec)
    return request.param, jspec, tspec, ks


def test_registry_census():
    """All 145 IDs build; the Point IDs with an object solve are the 27
    above; the three AntSmallBilliard IDs build the engine world, their
    ball a free one."""
    built, objects = [], []
    for env_id in tmmt.env_ids():
        spec = tmmt.make_spec(env_id, device="cpu")
        built.append(env_id)
        if env_id in ANT_BALLS:
            assert spec.object_spec is None
            assert [b.kind for b in spec.ball_runtimes] == ["free"]
        if spec.object_spec is not None:
            assert spec.robot.NAME == "Point"
            objects.append(env_id)
    assert len(built) == 145
    assert sorted(objects) == sorted(CENSUS)


def test_layout(sides):
    env_id, jspec, tspec, ks = sides
    nq, nd, n_ball, n_blk, n_z, rows, n_obs, offset = CENSUS[env_id]
    assert (tspec.nq, tspec.nv) == (jspec.nq, jspec.nv) == (nq, nq)
    assert tspec.obs_dim == jspec.obs_dim == n_obs
    assert len(tspec.ball_runtimes) == len(jspec.ball_runtimes) == n_ball
    assert len(tspec.block_runtimes) == len(jspec.block_runtimes) == n_blk
    for tb, jb in zip(tspec.block_runtimes, jspec.block_runtimes):
        assert tb.qpos_idx == jb.qpos_idx[:3]
        np.testing.assert_array_equal(tb.xy_lo, np.asarray(jb.xy_lo))
        np.testing.assert_array_equal(tb.xy_hi, np.asarray(jb.xy_hi))
    for tb, jb in zip(tspec.ball_runtimes, jspec.ball_runtimes):
        assert tb.qpos_idx == jb.qpos_idx
        assert tb.size == jb.size
    assert tspec._object_dof_idx() == jspec._object_dof_idx()
    assert ks.object_dof_idx == jspec._object_dof_idx()
    assert ks.n_world == nd and ks.object_spec.nd == nd
    assert sum(b.dof_z >= 0 for b in ks.object_spec.blocks) == n_z
    assert ks.max_rows == object_lanes.row_count(ks.object_spec) == rows
    assert ks.obs_offset == offset


def test_reset_observation(sides):
    """The port's reset states: world dofs at 0, at rest; each env's
    observation equal to the JAX ``_observe`` of the same state."""
    _, jspec, tspec, _ = sides
    state, obs = tspec.reset(torch.Generator().manual_seed(3), 4)
    n_robot = tspec.robot.nq
    assert torch.all(state.qpos[:, n_robot:] == 0)
    assert torch.all(state.qvel[:, n_robot:] == 0)
    for e in range(4):
        jst = JEnvState(qpos=state.qpos[e].numpy(), qvel=state.qvel[e].numpy(),
                        t=np.int32(0), key=jax.random.PRNGKey(0))
        np.testing.assert_array_equal(np.asarray(jspec._observe(jst)),
                                      obs[e].numpy())


def test_lowered_object_spec(sides):
    """``convert.lowered_spec`` against the JAX package's lowering: the
    object solve's walls, balls, blocks (reach sets and limits
    included), masses and contact constants, and the Pallas spec's
    ``n_world``, ``obs_offset`` and ``object_dof_idx``."""
    _, jspec, _, ks = sides
    low = convert.lowered_spec(ks)
    jks = jol.spec_from_env(jspec)
    np.testing.assert_array_equal(low["object_spec.wb_c"], jks.wb_c)
    np.testing.assert_array_equal(low["object_spec.wb_h"], jks.wb_h)
    assert low["object_spec.wb_c"].dtype == np.float32
    for name in CONSTANTS:
        assert low[f"object_spec.{name}"] == getattr(jks, name), name
    assert low["object_spec.balls"] == [b._asdict() for b in jks.balls]
    assert low["object_spec.blocks"] == [b._asdict() for b in jks.blocks]
    pks = point_pallas.spec_from_env(jspec)
    for name in ("n_world", "obs_offset"):
        assert low[name] == getattr(pks, name), name
    assert low["object_dof_idx"] == tuple(pks.object_dof_idx)
