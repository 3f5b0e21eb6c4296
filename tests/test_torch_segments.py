"""Batched segment ops of the PyTorch port vs the JAX package and the numpy
oracle.

``detect``, ``resolve``, ``impedance_eject`` and ``tip_impedance_eject`` of
``mujoco_maze_tpu_torch.ops.segments`` against ``mujoco_maze_tpu.ops.
segments`` under ``jax.vmap`` on the same numpy inputs, and ``detect`` /
``resolve`` against ``CollisionDetector`` the way tests/test_collision.py
holds the JAX ops to it.  atol 1e-4 (float32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

from mujoco_maze_tpu.ops import segments as jseg  # noqa: E402

from mujoco_maze_tpu_torch.maze.collision import CollisionDetector  # noqa: E402
from mujoco_maze_tpu_torch.models.point import PointRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import segments as tseg  # noqa: E402
from mujoco_maze_tpu_torch.tasks.library import TaskRegistry  # noqa: E402

ATOL = 1e-4
MAZES = ["UMaze", "4Rooms", "Corridor", "TRoom"]
N = 256
MARGIN, LAM, DT, MU = (PointRobot.WALL_CONTACT_MARGIN, PointRobot.CONTACT_LAM,
                       PointRobot.timestep, PointRobot.CONTACT_MU)
MASS, ARM, I_PRIME, RADIUS = (PointRobot.BODY_MASS, PointRobot.COUPLE_ARM,
                              PointRobot.SPIN_INERTIA_PRIME, PointRobot.RADIUS)


def _walls(maze_id):
    task = TaskRegistry.tasks(maze_id)[0](4.0)
    structure = task.create_maze()
    torso = next((j * 4.0, i * 4.0) for i, row in enumerate(structure)
                 for j, c in enumerate(row) if c.is_robot())
    det = CollisionDetector(structure, 4.0, torso[0], torso[1], RADIUS)
    segs = np.asarray([[line.p1, line.p2] for line in det.lines])
    # padded slots exercise the mask on both sides
    return det, tseg.pad_walls(segs, len(segs) + 3), jseg.pad_walls(segs, len(segs) + 3)


def _near_wall_points(det, rng, n):
    """Points within ~0.6 of random wall segments: contact-rich inputs."""
    idx = rng.randint(len(det.lines), size=n)
    s = rng.uniform(-0.1, 1.1, n)
    p = np.stack([det.lines[i].p1 + s[k] * det.lines[i].v1
                  for k, i in enumerate(idx)])
    return p + rng.uniform(-0.6, 0.6, (n, 2))


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("maze_id", MAZES)
def test_detect_and_resolve_match_jax(maze_id):
    det, tw, jw = _walls(maze_id)
    rng = np.random.RandomState(1)
    old = _near_wall_points(det, rng, N)
    new = old + rng.uniform(-1.5, 1.5, (N, 2))
    tr = tseg.detect(tw, _t(old), _t(new))
    jr = jax.vmap(lambda o, n: jseg.detect(jw, o, n))(_j(old), _j(new))
    hit = np.asarray(jr.hit)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(tr.hit.numpy(), hit)
    np.testing.assert_allclose(tr.point.numpy()[hit], np.asarray(jr.point)[hit],
                               atol=ATOL)
    np.testing.assert_allclose(tr.reflection.numpy()[hit],
                               np.asarray(jr.reflection)[hit], atol=ATOL)
    res_t = tseg.resolve(tw, _t(old), _t(new), 0.8)
    res_j = jax.vmap(lambda o, n: jseg.resolve(jw, o, n, 0.8))(_j(old), _j(new))
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=ATOL)


@pytest.mark.parametrize("maze_id", MAZES)
def test_detect_and_resolve_match_numpy_oracle(maze_id):
    det, tw, _ = _walls(maze_id)
    rng = np.random.RandomState(0)
    old = rng.uniform(-4, 14.0, (300, 2))
    new = old + rng.uniform(-3, 3, (300, 2))
    res = tseg.detect(tw, _t(old), _t(new))
    resolved = tseg.resolve(tw, _t(old), _t(new), 0.8).numpy()
    for k in range(len(old)):
        ref = det.detect(old[k], new[k])
        if ref is None:
            # f32 vs f64 can flip razor-thin grazing hits; only flag clear ones
            if bool(res.hit[k]):
                assert min(line.distance(new[k]) for line in det.lines) < 1e-3
            continue
        assert bool(res.hit[k])
        np.testing.assert_allclose(res.point[k].numpy(), ref.point, atol=ATOL)
        np.testing.assert_allclose(res.reflection[k].numpy(), ref.reflection,
                                   atol=ATOL)
        np.testing.assert_allclose(resolved[k], det.resolve(old[k], new[k], 0.8),
                                   atol=ATOL)


def test_no_move_is_no_hit():
    _, tw, _ = _walls("UMaze")
    z = torch.zeros(4, 2)
    assert not tseg.detect(tw, z, z).hit.any()


@pytest.mark.parametrize("maze_id", MAZES)
def test_impedance_eject_matches_jax(maze_id):
    det, tw, jw = _walls(maze_id)
    rng = np.random.RandomState(2)
    p = _near_wall_points(det, rng, N)
    old = p + rng.uniform(-0.8, 0.8, (N, 2))
    v = rng.uniform(-3, 3, (N, 2))
    out_t = tseg.impedance_eject(tw, _t(p), _t(v), MARGIN, LAM, DT, MU,
                                 old=_t(old)).numpy()
    out_j = np.asarray(jax.vmap(lambda pp, vv, oo: jseg.impedance_eject(
        jw, pp, vv, MARGIN, LAM, DT, MU, old=oo))(_j(p), _j(v), _j(old)))
    assert (np.abs(out_j) > 1e-3).any(axis=1).sum() > 10  # contacts occurred
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    # without the orienting pre-move position
    out_t = tseg.impedance_eject(tw, _t(p), _t(v), MARGIN, LAM, DT, MU).numpy()
    out_j = np.asarray(jax.vmap(lambda pp, vv: jseg.impedance_eject(
        jw, pp, vv, MARGIN, LAM, DT, MU))(_j(p), _j(v)))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("maze_id", MAZES)
def test_tip_impedance_eject_matches_jax(maze_id):
    det, tw, jw = _walls(maze_id)
    rng = np.random.RandomState(3)
    center = _near_wall_points(det, rng, N)
    theta = rng.uniform(-np.pi, np.pi, N)
    tip = center + 1.1 * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    old = center + rng.uniform(-0.3, 0.3, (N, 2))
    v3 = rng.uniform(-3, 3, (N, 3))
    args = (RADIUS, LAM, DT, MASS, ARM, I_PRIME)
    out_t = tseg.tip_impedance_eject(tw, _t(center), _t(tip), _t(v3), _t(theta),
                                     *args, old=_t(old)).numpy()
    out_j = np.asarray(jax.vmap(lambda c, tp, vv, th, oo: jseg.tip_impedance_eject(
        jw, c, tp, vv, th, *args, old=oo))(_j(center), _j(tip), _j(v3),
                                           _j(theta), _j(old)))
    assert (np.abs(out_j) > 1e-3).any(axis=1).sum() > 10  # contacts occurred
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_walls", [1, 16, 48])
def test_wall_sums_fold_in_wall_order(n_walls):
    # the CUDA kernel accumulates per-wall contributions left to right from
    # 0; the plain version must round the same way, bit for bit
    rng = np.random.RandomState(n_walls)
    x = rng.standard_normal((64, n_walls)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.5] = 0.0  # inactive walls add 0
    want = np.zeros(64, dtype=np.float32)
    for w in range(n_walls):
        want = want + x[:, w]
    got = tseg._sum_in_wall_order(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
