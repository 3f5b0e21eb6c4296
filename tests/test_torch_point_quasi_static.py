"""A Point robot without the object solve: the routing and the lowering of
the Point kernels' quasi-static rows, against the JAX package.

* The repair of ``USES_POINT_WORLD``: a Point robot that sets it to False
  gets no object solve in either package, the stock robot does.
* The quasi-static table of ``point_kernel.spec_from_env`` against JAX
  ``point_pallas.spec_from_env``'s ``blocks``/``balls``/``objball_walls_*``/
  ``ball_*`` fields on the 27 Point object tasks (no JAX compile).
* The heads' anchor on BlockCarry and Billiard, read through qpos
  addresses; the bounds of the one build raise above them.
* ``convert.from_jax_state`` on float64 states and on the quasi worlds'
  qpos layout.
"""

import _torch_threads  # noqa: F401  (one PyTorch intra-op thread)
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_point_quasi as pq  # noqa: E402
from mujoco_maze_tpu.ops import point_pallas  # noqa: E402

from mujoco_maze_tpu_torch import convert, registry  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import EnvState, MazeEnvSpec  # noqa: E402
from mujoco_maze_tpu_torch.models.point import PointRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import point_kernel as pk  # noqa: E402

from _torch_threads import one_intraop_thread  # noqa: E402,F401


def _object_task(env_id):
    _, tspec = pq.specs(env_id)
    return tspec.nq > 3


POINT_OBJECT_TASKS = [i for i in registry.env_ids()
                      if i.startswith("Point") and _object_task(i)]


def test_twenty_seven_object_tasks():
    assert len(POINT_OBJECT_TASKS) == 27


@pytest.mark.parametrize("env_id", pq.WORLDS)
def test_uses_point_world_gate(env_id):
    """The repair (ROADMAP queue 3): the object solve only for a robot with
    ``USES_POINT_WORLD``, as JAX env.py:171-172 decides."""
    jspec, tspec = pq.specs(env_id)
    assert jspec.object_world is None
    assert tspec.object_world is None and tspec.object_spec is None
    assert PointRobot.USES_POINT_WORLD and not pq.QuasiPoint.USES_POINT_WORLD
    stock = registry.make_spec(env_id, device="cpu")
    assert stock.object_spec is not None
    assert tspec.nq == jspec.nq == stock.nq


@pytest.mark.parametrize("env_id", POINT_OBJECT_TASKS)
def test_quasi_table_matches_point_pallas(env_id):
    """The quasi-static table, read back as the kernel reads it
    (``convert.lowered_spec``), against ``point_pallas.spec_from_env``
    with the JAX quasi robot (whose ``object_spec`` is None)."""
    jspec, tspec = pq.specs(env_id)
    jks = point_pallas.spec_from_env(jspec)
    ks = pk.spec_from_env(tspec)
    assert jks.object_spec is None and ks.object_spec is None
    assert ks.quasi_table is not None and ks.quasi_table.dtype == torch.float32
    low = convert.lowered_spec(ks)
    f = np.float32
    assert len(low["blocks"]) == len(jks.blocks)
    for ours, theirs in zip(low["blocks"], jks.blocks):
        for name, n in (("body_pos", 3), ("half", 2), ("axis_mask", 2),
                        ("xy_lo", 2), ("xy_hi", 2)):
            np.testing.assert_array_equal(
                f(ours[name]), f(getattr(theirs, name)[:n]), err_msg=name)
        assert ours["qpos_idx"] == tuple(theirs.qpos_idx[:3])
        assert theirs.qpos_idx[3] == -1       # no spin slot
    assert len(low["balls"]) == len(jks.balls)
    for ours, theirs in zip(low["balls"], jks.balls):
        np.testing.assert_array_equal(f(ours["body_pos"]), f(theirs.body_pos))
        assert ours["reach"] == f(jks.robot_geom_r + theirs.size)
        assert ours["qpos_idx"] == tuple(theirs.qpos_idx[:2])
    mask = np.asarray(jks.objball_walls_mask, bool)
    for end in ("p1", "p2"):
        np.testing.assert_array_equal(
            low[f"objball_walls_{end}"],
            np.asarray(getattr(jks, f"objball_walls_{end}"))[mask])
    assert low["ball_kick"] == jks.ball_kick
    assert low["ball_keep"] == f(1.0) - f(jks.ball_decay)
    assert low["push_radius"] == f(ks.radius) == f(jks.radius)
    assert ks.n_world == jks.n_world and ks.obs_offset == jks.obs_offset
    assert ks.quasi_counts == (len(jks.blocks), len(jks.balls),
                               int(mask.sum()))
    # the table holds these and nothing more
    assert ks.quasi_table.numel() == (
        pk.QUASI_HEAD + pk.QUASI_BLOCK * len(jks.blocks)
        + pk.QUASI_BALL * len(jks.balls) + 4 * int(mask.sum()))


@pytest.mark.parametrize("env_id", ["PointBlockCarry-v0", "PointBilliard-v0"])
def test_heads_anchor_through_qpos_addresses(env_id):
    """OBS_OFFSET = 3: the anchor is the first observed object's centre,
    read through its qpos addresses (a ball's z is 0, a block's its body
    z plus its z slide), equal to the observation the plain heads read and
    to JAX ``point_pallas._first_object_pos``."""
    jspec, tspec = pq.specs(env_id)
    ks = pk.spec_from_env(tspec)
    assert ks.obs_offset == 3
    low = convert.lowered_spec(ks)
    head_qadr = low["head_qadr"]
    assert low["head_base"] == ks.head_base
    q, v, t, _ = pk.quasi_states(tspec, 32, 7)
    obs = tspec._observe(EnvState(qpos=torch.as_tensor(q),
                                  qvel=torch.as_tensor(v),
                                  t=torch.as_tensor(t)))
    anchor = [np.float32(ks.head_base[a]) + (
        q[:, head_qadr[a]] if head_qadr[a] >= 0
        else np.zeros(32, np.float32)) for a in range(3)]
    np.testing.assert_array_equal(np.stack(anchor, 1).astype(np.float32),
                                  obs[:, 3:6].numpy())
    jks = point_pallas.spec_from_env(jspec)
    cols = tuple(np.asarray(q[:, i]) for i in range(q.shape[1]))
    theirs = point_pallas._first_object_pos(jks, cols)
    np.testing.assert_allclose(np.stack([np.broadcast_to(x, (32,))
                                         for x in theirs], 1),
                               obs[:, 3:6].numpy(), atol=0)
    if env_id == "PointBilliard-v0":
        assert head_qadr[2] == -1 and ks.head_base[2] == 0.0
    else:
        b = tspec.block_runtimes[0]
        assert head_qadr == b.qpos_idx
        assert ks.head_base[2] == np.float32(b.body_pos[2])


@pytest.mark.parametrize("what", ["blocks", "balls"])
def test_bounds_raise(what):
    """Above 3 blocks or 1 ball the lowering raises; it never falls back."""
    env_id = "PointMultiPushSmall-v0" if what == "blocks" else "PointBilliard-v0"
    _, tspec = pq.specs(env_id)
    pk.spec_from_env(tspec)             # within the bounds
    rt = getattr(tspec, f"{what[:-1]}_runtimes")
    setattr(tspec, f"{what[:-1]}_runtimes", tuple(rt) + (rt[0],))
    with pytest.raises(NotImplementedError, match="quasi-static bounds"):
        pk.spec_from_env(tspec)


def test_stock_point_object_world_keeps_the_solve():
    """The stock Point robot's object worlds lower to the object solve and
    not to the quasi table."""
    ks = pk.spec_from_env(registry.make_spec("PointPush-v0", device="cpu"))
    assert ks.object_spec is not None and ks.quasi_table is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_convert_keeps_dtype_and_quasi_layout(dtype):
    """``convert.from_jax_state``: float64 states stay float64 (never
    rounded through float32), float32 stay float32; the quasi worlds' qpos
    layout (robot, block slides, ball x/y/rot) carries across as it is."""
    jspec, tspec = pq.specs("PointBilliard-v0")
    rng = np.random.RandomState(3)
    qpos = rng.uniform(-1, 1, (4, jspec.nq)).astype(dtype) / 3.0
    qvel = rng.uniform(-1, 1, (4, jspec.nv)).astype(dtype) / 7.0
    st = convert.from_jax_state(qpos, qvel, np.arange(4), device="cpu",
                                dtype=torch.float64 if dtype == np.float64
                                else torch.float32)
    assert st.qpos.dtype == (torch.float64 if dtype == np.float64
                             else torch.float32)
    np.testing.assert_array_equal(st.qpos.numpy(), qpos)
    np.testing.assert_array_equal(st.qvel.numpy(), qvel)
    # the layout: robot (3), then the ball's x, y, rot
    assert tspec.ball_runtimes[0].qpos_idx == jspec.ball_runtimes[0].qpos_idx
    _, tpush = pq.specs("PointMultiPushSmall-v0")
    jpush, _ = pq.specs("PointMultiPushSmall-v0")
    assert [b.qpos_idx for b in tpush.block_runtimes] == [
        tuple(b.qpos_idx[:3]) for b in jpush.block_runtimes]
    lowered = convert.lowered_spec(pk.spec_from_env(tpush))
    assert [b["qpos_idx"] for b in lowered["blocks"]] == [
        tuple(b.qpos_idx[:3]) for b in jpush.block_runtimes]


def test_quasi_spec_is_a_plain_mazespec():
    """The quasi robot is a fixture: ``MazeEnvSpec(QuasiPoint(), task,
    scaling)`` with nothing else changed."""
    e = registry.entry("PointPush-v0")
    spec = MazeEnvSpec(pq.QuasiPoint(), e.task_cls, e.maze_size_scaling,
                       device="cpu")
    assert spec.object_spec is None and spec.nq == 5
    assert spec.block_runtimes[0].axis_mask.tolist() == [1.0, 1.0, 0.0]
