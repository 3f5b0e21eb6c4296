"""The Ant block worlds of the PyTorch port vs the JAX package: static data.

For each of the 21 Ant IDs with movable blocks (AntPush, AntFall,
AntMultiFall, AntMultiPush, AntMultiPushSmall, AntPushMaze, AntBlockMaze,
AntBlockCarry): nq, nv, the reset pose, the composed ``RigidModel`` (the
blocks' slide joints and travel ranges included), the contact set (the
static boxes, platforms included, and the sphere-vs-moving-box pairs
``Q``), the falling-support tables, the observation width, and the Ant
kernels' lowered tables against what the JAX kernel reads from
``ant_pallas.spec_from_env`` (``ant_math.consts_from_model``,
``ant_math.world_from_spec`` and its ``AntBlock`` list), in float32.
Each ID is built once per module on both sides; nothing is traced.
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
from mujoco_maze_tpu_torch.ops import ant_kernel, lane_env  # noqa: E402
from mujoco_maze_tpu_torch.physics.contact import (  # noqa: E402
    MAX_ACTIVE_CONTACTS, candidate_count)

# (ID, blocks, world dofs, static boxes, obs width): the census of the
# block worlds
BLOCK_IDS = {
    "AntPush-v0": (1, 2, 19, 33), "AntPush-v1": (1, 2, 19, 33),
    "AntBlockMaze-v0": (1, 2, 20, 33), "AntBlockMaze-v1": (1, 2, 20, 33),
    "AntBlockCarry-v0": (1, 2, 16, 33), "AntBlockCarry-v1": (1, 2, 16, 33),
    "AntBlockCarry-v2": (1, 2, 16, 33),
    "AntFall-v0": (1, 2, 38, 33), "AntFall-v1": (1, 2, 38, 33),
    "AntMultiFall-v2": (1, 2, 38, 33),
    "AntMultiFall-v0": (1, 3, 56, 33), "AntMultiFall-v1": (1, 3, 56, 33),
    "AntMultiPush-v0": (2, 4, 29, 36), "AntMultiPush-v1": (2, 4, 29, 36),
    "AntMultiPush-v2": (2, 4, 29, 36),
    "AntMultiPushSmall-v0": (3, 6, 31, 39),
    "AntMultiPushSmall-v1": (3, 6, 31, 39),
    "AntMultiPushSmall-v2": (3, 6, 31, 39),
    "AntPushMaze-v0": (3, 6, 30, 39), "AntPushMaze-v1": (3, 6, 30, 39),
    "AntPushMaze-v2": (3, 6, 30, 39),
}
MODEL_FIELDS = (
    "nbody", "body_parent", "body_pos", "body_quat", "body_mass", "body_com",
    "body_inertia", "njnt", "jnt_type", "jnt_body", "jnt_axis", "jnt_pos",
    "jnt_qposadr", "jnt_dofadr", "jnt_limited", "jnt_range", "nq", "nv",
    "dof_armature", "dof_damping", "nu", "act_dofadr", "act_gear",
    "act_ctrlrange", "gravity", "timestep", "qpos0",
)


@pytest.fixture(scope="module", params=sorted(BLOCK_IDS))
def sides(request):
    jspec = jmmt.make_spec(request.param)
    tspec = tmmt.make_spec(request.param, device="cpu")
    ks = ant_kernel.spec_from_env(tspec)
    return request.param, jspec, tspec, ks


def test_registry_census():
    ids = [i for i in tmmt.env_ids() if tmmt.entry(i).robot_name == "Ant"]
    specs = {i: tmmt.make_spec(i, device="cpu") for i in ids}
    blocky = [i for i in ids if specs[i].block_runtimes]
    assert sorted(blocky) == sorted(BLOCK_IDS)
    # the three others with world bodies carry a ball (no blocks)
    balls = [i for i in ids if specs[i].ball_runtimes]
    assert sorted(balls) == [f"AntSmallBilliard-v{k}" for k in range(3)]


def test_sizes_and_reset_pose(sides):
    env_id, jspec, tspec, _ = sides
    n_blk, n_w, n_box, n_obs = BLOCK_IDS[env_id]
    assert (tspec.nq, tspec.nv) == (jspec.nq, jspec.nv) == (15 + n_w, 14 + n_w)
    assert tspec.obs_dim == jspec.obs_dim == n_obs
    assert len(tspec.block_runtimes) == len(jspec.block_runtimes) == n_blk
    np.testing.assert_array_equal(tspec.init_qpos, jspec.init_qpos)
    np.testing.assert_array_equal(tspec.init_qvel, jspec.init_qvel)
    for tb, jb in zip(tspec.block_runtimes, jspec.block_runtimes):
        assert tb.qpos_idx == tuple(jb.qpos_idx[:3])
        assert tb.falling == jb.falling
        np.testing.assert_array_equal(np.float32(tb.body_pos),
                                      np.asarray(jb.body_pos))
        np.testing.assert_array_equal(np.float32(tb.half), np.asarray(jb.half))


def test_rigid_model_and_travel_ranges_match(sides):
    _, jspec, tspec, _ = sides
    jm, tm = jspec.dynamic_model, tspec.dynamic_model
    for name in MODEL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for tg, jg in zip([g for _, g in tm.geoms] + tm.static_geoms,
                      [g for _, g in jm.geoms] + jm.static_geoms):
        for f in dataclasses.fields(jg):
            np.testing.assert_array_equal(np.asarray(getattr(tg, f.name)),
                                          np.asarray(getattr(jg, f.name)),
                                          err_msg=f.name)
    assert len(tm.static_geoms) == len(jm.static_geoms)
    # the blocks' slides: limited x / y travel, the falling z unlimited
    for j in range(tm.njnt):
        if int(tm.jnt_body[j]) >= 13:
            falling = float(tm.jnt_axis[j][2]) == 1.0
            assert bool(tm.jnt_limited[j]) is not falling


def test_contact_set_matches(sides):
    env_id, jspec, tspec, _ = sides
    n_blk, _, n_box, _ = BLOCK_IDS[env_id]
    jc, tc = jspec.contact_set, tspec.contact_set
    assert jc._fields == tc._fields
    for name in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    assert len(tc.box_center) == n_box and len(tc.pair_i) == 0
    assert len(tc.qpair_s) == 37 * n_blk
    assert candidate_count(tc) == 37 * (3 + n_blk) <= MAX_ACTIVE_CONTACTS


def test_falling_support_tables_match(sides):
    env_id, jspec, tspec, _ = sides
    assert tspec._falling_support == jspec._falling_support
    assert bool(tspec._falling_support) == ("Fall" in env_id)


def test_kernel_tables_match_the_jax_kernel(sides):
    _, jspec, tspec, ks = sides
    es = ant_pallas.spec_from_env(jspec)
    ours = convert.lowered_spec(ks)
    for name, val in ours.items():
        src = (es.ac if name in es.ac._fields
               else es.aw if name in es.aw._fields else es)
        ref = getattr(src, name)
        if name in ("masses", "coms", "inertias", "armature", "damping"):
            # the JAX constants run over every body and dof; the kernel's
            # body and dof tables hold the ant's, the blocks' masses sit
            # in the world-dof table and their dofs have neither armature
            # nor damping
            ref = np.asarray(ref)
            if name in ("armature", "damping"):
                assert not np.any(ref[len(val):])
            ref = ref[:len(val)]
        if name == "inertias":
            iu = np.triu_indices(3)
            ref, val = np.asarray(ref)[:, iu[0], iu[1]], val[:, iu[0], iu[1]]
        if isinstance(ref, (np.ndarray, tuple, list)):
            ref = np.asarray(ref)
            if ref.dtype.kind == "f":
                ref = ref.astype(np.float32)
            np.testing.assert_array_equal(np.asarray(val), ref, err_msg=name)
        elif isinstance(ref, float):
            assert np.float32(val) == np.float32(ref), name
        else:
            assert val == ref, name
    blocks = convert.lowered_blocks(ks)
    assert len(blocks) == len(es.aw.blocks) == ks.n_blk
    for ours_b, jb in zip(blocks, es.aw.blocks):
        for name in ("base", "half", "inv_mass", "axes", "vadr", "ranges"):
            np.testing.assert_array_equal(
                ours_b[name], np.asarray(getattr(jb, name), np.float32)
                if name not in ("axes", "vadr") else np.asarray(getattr(jb, name)),
                err_msg=name)
        assert ours_b["falling_zdof"] == jb.falling_zdof
        np.testing.assert_allclose(ours_b["margin"], jb.margin, rtol=1e-6)
        np.testing.assert_array_equal(
            ours_b["plats"], np.asarray(jb.plats, np.float32).reshape(-1, 5))
    assert ks.n_w == es.nv - 14 and ks.obs_offset == es.obs_offset


def test_pair_table_mixes_sphere_and_block(sides):
    """Each sphere-block pair's constants are the contact set's pair mix
    (JAX contact.py:474-477): margins added, friction the larger, solimp
    and solref averaged, the time constant clamped to 2 dt."""
    _, _, tspec, ks = sides
    cs = tspec.contact_set
    q = ks.table("qpair")
    for row, (s, b) in enumerate(zip(cs.qpair_s, cs.qpair_b)):
        ours = q[int(b) * 37 + int(s)]
        np.testing.assert_array_equal(ours[0], np.float32(
            cs.sph_margin[s] + cs.dbox_margin[b]))
        np.testing.assert_array_equal(ours[2:5], np.float32(
            (cs.sph_solimp[s] + cs.dbox_solimp[b]) / 2))
        assert ours[5] == max(np.float32((cs.sph_solref[s, 0]
                                          + cs.dbox_solref[b, 0]) / 2),
                              np.float32(0.04))
    assert len(q) == len(cs.qpair_s)


def test_params_and_bounds(sides):
    env_id, _, tspec, ks = sides
    n_blk, n_w, n_box, _ = BLOCK_IDS[env_id]
    p = lane_env.ant_params(ks)
    assert (p.n_w, p.n_blk, p.n_box, p.n_sph) == (n_w, n_blk, n_box, 37)
    assert p.obs_offset == (3 if "BlockCarry" in env_id else 0)
    assert n_w <= ant_kernel.MAX_WORLD_DOFS and n_blk <= ant_kernel.MAX_BLOCKS
    assert p.n_floats == ks.packed.numel()
    assert 1.0 < ks.reach < 1.5


def _random_poses(spec, n, seed):
    """Ant poses from a seed anywhere over the walkable cells: the torso
    0.2-1.0 above the floor or platform, hips and ankles anywhere in
    [-1, 1]; returns the test spheres' centres (n, S, 3) and the torso
    positions (n, 3), float64."""
    from mujoco_maze_tpu_torch.maze.cells import MazeCell
    from mujoco_maze_tpu_torch.physics import engine

    rng = np.random.RandomState(seed)
    ms, model, cs = spec.structure, spec.dynamic_model, spec.contact_set
    s = ms.size_scaling
    cells = [(i, j) for i in range(ms.grid.shape[0])
             for j in range(ms.grid.shape[1])
             if not MazeCell(ms.grid[i, j]).is_block()
             and not MazeCell(ms.grid[i, j]).is_chasm()]
    q = np.tile(model.qpos0, (n, 1))
    for e in range(n):
        i, j = cells[rng.randint(len(cells))]
        q[e, 0] = j * s - ms.torso_x + rng.uniform(-s / 2, s / 2)
        q[e, 1] = i * s - ms.torso_y + rng.uniform(-s / 2, s / 2)
        q[e, 2] = ms.height_offset + rng.uniform(0.2, 1.0)
    q[:, 7:15] = rng.uniform(-1, 1, (n, 8))
    fkr = engine.fk(model, torch.as_tensor(q))
    sb = cs.sph_body
    R = torch.stack(fkr.body_rot, 1)[:, sb].numpy()
    c = (torch.stack(fkr.body_pos, 1)[:, sb].numpy()
         + np.einsum("bsij,sj->bsi", R, cs.sph_local))
    return c, q[:, :3]


@pytest.mark.parametrize("env_id", ["AntUMaze-v0", "AntFall-v0",
                                    "AntMultiFall-v0", "AntPushMaze-v0"])
def test_reach_prune_keeps_every_contact(env_id):
    """The kernel tests each sphere against the static boxes within
    ``ks.reach`` of the torso: every box a sphere meets (dist < margin)
    lies within it, so the kernel's picks are those among all boxes, as
    the plain version takes them.  The JAX kernel's prune to the 4 boxes
    nearest the torso drops some of those contacts in the Fall worlds."""
    spec = tmmt.make_spec(env_id, device="cpu")
    ks = ant_kernel.spec_from_env(spec)
    cs = spec.contact_set
    c, torso = _random_poses(spec, 2048, seed=0)
    bc, bh = cs.box_center, cs.box_half
    local = c[:, :, None, :] - bc
    out = np.linalg.norm(np.maximum(np.abs(local) - bh, 0.0), axis=-1)
    inside = -np.min(bh - np.abs(local), axis=-1)
    dist = np.where(out > 0, out, inside) - cs.sph_radius[:, None]
    touch = dist < cs.sph_margin[:, None] + cs.box_margin    # (n, S, nbox)
    torso_d = np.linalg.norm(np.maximum(np.abs(torso[:, None] - bc) - bh, 0),
                             axis=-1)                         # (n, nbox)
    assert touch.any()
    within = np.broadcast_to((torso_d <= ks.reach)[:, None, :], touch.shape)
    assert within[touch].all()
    near4 = np.argsort(torso_d, axis=1, kind="stable")[:, :4]
    kept = np.zeros_like(torso_d, dtype=bool)
    np.put_along_axis(kept, near4, True, axis=1)
    dropped = (touch & ~kept[:, None, :]).any(axis=(1, 2)).sum()
    if env_id == "AntMultiFall-v0":
        assert dropped > 0
    if env_id == "AntUMaze-v0":
        assert dropped == 0
