"""The launch of the Point object kernels, on the CPU.

The object step and rollout kernels (``csrc/point_lane.cu`` with
``csrc/point_objects.cuh``) step one env per group of 8 lanes
(``kLanes``), four envs a warp, a full block of 256 threads; each env's
row store (every candidate row of its world) and active mask live in
shared memory beside the staged tables and the item list where a full
block's fit, and else in a global buffer of the same layout.  Held here,
without a card and without JAX:

* ``ops/lane_env.obj_geometry`` gives every one of the 27 Point object
  worlds a launch that fits a block's 227 KB, derived from the world's
  candidate rows R and its tables; PointPushMaze-v0 (R = 676, the most)
  is not refused, and neither is a planted ball maze of 2268 rows, whose
  stores do not fit shared memory at one warp of envs;
* the row-field count, the group width and the threads a block have one
  definition, the header, which the wrapper reads; the wrapper's
  ``ObjParams`` mirrors ``struct ObjParams`` field for field;
* the solve without active rows that the launch passes is the plain
  version's.
"""

import ctypes
import pathlib
import re

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

from mujoco_maze_tpu_torch import registry  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec  # noqa: E402
from mujoco_maze_tpu_torch.models.point import PointRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import lane_env, object_lanes  # noqa: E402
from mujoco_maze_tpu_torch.ops.point_kernel import (  # noqa: E402
    object_states, point_step_plain, spec_from_env)
from mujoco_maze_tpu_torch.tasks import library  # noqa: E402

PKG = pathlib.Path(__file__).resolve().parent.parent / "mujoco_maze_tpu_torch"
HEADER = (PKG / "csrc" / "point_objects.cuh").read_text()
OBJECT_IDS = ["PointPush-v0", "PointPush-v1", "PointMultiPush-v0",
              "PointMultiPush-v1", "PointMultiPush-v2",
              "PointMultiPushSmall-v0", "PointMultiPushSmall-v1",
              "PointMultiPushSmall-v2", "PointPushMaze-v0",
              "PointPushMaze-v1", "PointPushMaze-v2", "PointFall-v0",
              "PointFall-v1", "PointMultiFall-v2", "PointBlockMaze-v0",
              "PointBlockMaze-v1", "PointBlockCarry-v0", "PointBlockCarry-v1",
              "PointBlockCarry-v2", "PointBilliard-v0", "PointBilliard-v1",
              "PointBilliard-v2", "PointBilliard-v3", "PointBilliard-v4",
              "PointSmallBilliard-v0", "PointSmallBilliard-v1",
              "PointSmallBilliard-v2"]
_KS = {}


def _ks(env_id):
    if env_id not in _KS:
        _KS[env_id] = spec_from_env(registry.make_spec(env_id, device="cpu"))
    return _KS[env_id]


def _planted(n: int):
    """chip_smoke.py's planted ball maze at n x n cells: the Billiard
    task's ball, walls on the border and on every cell of an even row and
    column (at n = 42: 564 walls, 2268 candidate rows)."""

    class PlantedBallMaze(library.GoalRewardBilliard):
        @staticmethod
        def create_maze():
            m = [[library.B if i in (0, n - 1) or j in (0, n - 1)
                  or (i % 2 == 0 and j % 2 == 0) else library.E
                  for j in range(n)] for i in range(n)]
            m[3][3], m[4][3] = library.R, library.OB
            return m

    spec = MazeEnvSpec(PointRobot(), PlantedBallMaze, maze_size_scaling=3.0,
                       device="cpu")
    return spec, spec_from_env(spec)


def test_the_27_object_worlds():
    ids = sorted(i for i in registry.env_ids() if i.startswith("Point")
                 and registry.make_spec(i, device="cpu").object_spec
                 is not None)
    assert ids == sorted(OBJECT_IDS)


@pytest.mark.parametrize("env_id", OBJECT_IDS)
def test_launch_fits_the_card(env_id):
    ks = _ks(env_id)
    c = lane_env.obj_constants()
    geo = lane_env.obj_geometry(ks)
    R = ks.max_rows
    assert R == object_lanes.row_count(ks.object_spec)
    # a row store of every candidate row (J's nd columns and kRowFixed
    # more fields, on an odd stride), and R bits of active mask
    assert geo.row_stride >= R and geo.row_stride % 2 == 1
    nd = ks.object_spec.nd
    assert 1 <= nd <= 6
    assert geo.group_floats == ((nd + c["kRowFixed"]) * geo.row_stride
                                + lane_env.trace_words(ks))
    # the tables first, then the item list (a count and two ints an item,
    # at most one item per two rows), then the envs where their row stores
    # live in shared memory
    tables = ks.walls.numel() + ks.goals.numel() + ks.obj_table.numel()
    assert geo.off_items == tables
    items = lane_env.obj_items(ks)
    assert 2 * items <= R
    assert geo.off_groups == geo.off_items + 1 + 2 * items
    stores = geo.groups * geo.group_floats
    assert geo.smem_bytes == 4 * (geo.off_groups
                                  + (stores if geo.shared_rows else 0))
    assert geo.smem_bytes <= lane_env.SMEM_BLOCK_MAX
    # a full block of whole warps; the stores in shared memory where the
    # full block's fit
    assert geo.threads == geo.groups * c["kLanes"] == c["kMaxThreads"]
    assert geo.threads % 32 == 0
    assert geo.shared_rows == (
        4 * (geo.off_groups + stores) <= lane_env.SMEM_BLOCK_MAX)
    assert geo.groups_per_sm >= geo.groups
    # the struct carries the launch
    p = lane_env.obj_params(ks)
    assert (p.groups, p.row_stride, p.group_floats, p.off_items,
            p.off_groups, p.shared_rows, p.max_rows) == (
        geo.groups, geo.row_stride, geo.group_floats, geo.off_items,
        geo.off_groups, int(geo.shared_rows), R)


def test_the_largest_store_is_not_refused():
    ks = _ks("PointPushMaze-v0")
    assert ks.max_rows == max(_ks(i).max_rows for i in OBJECT_IDS) == 676
    geo = lane_env.obj_geometry(ks)
    assert geo.groups >= 1 and geo.smem_bytes <= lane_env.SMEM_BLOCK_MAX
    assert not geo.shared_rows      # 27 KB an env: global memory
    launch = lane_env.PointStep(ks, 4).obj
    assert launch.params(torch.device("cpu")).groups == geo.groups
    assert launch.geo == geo


def test_constants_have_one_definition():
    c = lane_env.obj_constants()
    assert set(c) == {"kRowFixed", "kLanes", "kMaxThreads"}
    assert c["kRowFixed"] == 4 and 32 % c["kLanes"] == 0
    for name in c:
        # the Point kernels' sources (the Ant and engine kernels have their
        # own lanes)
        defs = [p.name for p in sorted((PKG / "csrc").glob("point_*.cu*"))
                if re.search(rf"\b{name}\s*=", p.read_text())]
        assert defs == ["point_objects.cuh"], name
    # the wrapper reads them and keeps no copy of its own
    wrapper = (PKG / "ops" / "lane_env.py").read_text()
    assert "OBJ_ROW_FIELDS" not in wrapper and "OBJ_LANES" not in wrapper
    assert lane_env.obj_constants() is c     # read once


def test_struct_fields_follow_the_header():
    body = re.search(r"struct ObjParams \{(.*?)\};", HEADER, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for kind, decl in re.findall(r"\b(int|float) ([^;]*);", body):
        names += [(n.strip(), kind) for n in decl.split(",")]
    have = [(n, "int" if t is ctypes.c_int else
             "float" if t is ctypes.c_float else f"float[{t._length_}]")
            for n, t in lane_env.ObjParams._fields_]
    assert have == [(n.split("[")[0], f"float[{n.split('[')[1][:-1]}]")
                    if "[" in n else (n, k) for n, k in names]


def test_a_world_past_shared_memory_keeps_its_rows_in_global_memory():
    spec, ks = _planted(42)
    assert ks.max_rows == 2268
    # a warp's row stores overflow a block's shared memory, so the stores
    # live in a global buffer of the same layout, a full block of envs
    assert (lane_env.obj_layout(ks, 4, True).smem_bytes
            > lane_env.SMEM_BLOCK_MAX)
    geo = lane_env.obj_geometry(ks)
    assert not geo.shared_rows and geo.groups == 32
    assert geo.smem_bytes == 4 * geo.off_groups <= lane_env.SMEM_BLOCK_MAX
    launch = lane_env.PointStep(ks, 40).obj
    launch.params(torch.device("cpu"))
    launch.rows(torch.device("cpu"), 40)
    # one store for each group of each block: 2 blocks of 32 envs
    assert launch._rows.numel() == 64 * geo.group_floats
    # the CPU steps it through the plain version
    q, v, t = (torch.as_tensor(x) for x in object_states(spec, 4, 3))
    a = torch.as_tensor(np.random.RandomState(3).uniform(-1, 1, (4, 2)),
                        dtype=torch.float32)
    out = lane_env.PointStep(ks, 4)(q, v, t, a)
    assert all(torch.equal(x, y) for x, y in zip(
        out, point_step_plain(ks, q, v, t, a)))


@pytest.mark.parametrize("n", [44, 46])
def test_the_tables_bound_the_launch_as_before(n):
    # the one-thread-per-env object kernels staged the tables in at most
    # 48 KB of shared memory a block; any world within that launches here
    spec, ks = _planted(n)
    geo = lane_env.obj_layout(ks, 32, False)
    assert 4 * geo.off_items <= 48 * 1024
    assert lane_env.obj_geometry(ks) == geo


@pytest.mark.parametrize("env_id", ["PointPush-v0", "PointFall-v0"])
def test_the_solve_without_rows_is_the_plain_versions(env_id):
    ks = _ks(env_id)
    x = lane_env.obj_free_solve(ks, "cpu")
    nd = ks.object_spec.nd
    assert len(x) == 6 and x[nd:] == (0.0,) * (6 - nd)
    # a forward evaluation of the plain version far from every contact
    o = ks.object_spec
    B = 2
    none = torch.zeros((0, B))
    want = object_lanes._solve_newton(
        o, [none] * nd, none, none, [torch.zeros(B)] * nd,
        object_lanes.gravity(o))
    assert all(float(w[0]) == xi for w, xi in zip(want, x))
    p = lane_env.PointStep(ks, 4).obj.params(torch.device("cpu"))
    assert tuple(p.x_free) == x
