"""The launch of the swimmer kernels, on the CPU.

The Swimmer and Reacher step and rollout kernels (``csrc/swimmer_lane.cu``)
step one env per group of ``kLanes`` lanes, ``kThreads / kLanes`` envs a
block; lane k writes coordinate k of the env's row, world dofs included.
Held here, without a card and without JAX:

* the wrapper's ``SwimmerParams`` mirrors ``struct SwimmerParams`` field
  for field, names and types;
* the group width and the threads a block have one definition, the
  source, which the wrapper reads (the envs a block follow from them, in
  the source and in the wrapper alike);
* the wrappers' launch covers every env of the batch, with a lane for
  each coordinate of the env's row, for 2 and 3 links;
* the wrappers refuse a wrong dtype, shape or device and run the plain
  version for CPU tensors, counting no launch.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

from mujoco_maze_tpu_torch import registry  # noqa: E402
from mujoco_maze_tpu_torch.ops import lane_env  # noqa: E402
from mujoco_maze_tpu_torch.ops.swimmer_kernel import (  # noqa: E402
    spec_from_env, swimmer_rollout_plain, swimmer_step_plain)

PKG = pathlib.Path(__file__).resolve().parent.parent / "mujoco_maze_tpu_torch"
SOURCE = (PKG / "csrc" / "swimmer_lane.cu").read_text()
# one ID of each link count: the Reacher (2 links) and the Swimmer (3)
IDS = {2: "ReacherUMaze-v0", 3: "SwimmerUMaze-v0"}
_KS = {}


def _ks(env_id):
    if env_id not in _KS:
        _KS[env_id] = spec_from_env(registry.make_spec(env_id, device="cpu"))
    return _KS[env_id]


def _states(ks, n, seed):
    """Float32 (qpos, qvel, t, actions) made with numpy: joint angles over
    +-2 rad (past the +-1.745 limits in some envs), t near the episode's
    end."""
    rng = np.random.RandomState(seed)
    nq = 2 + ks.dyn.n_links + ks.n_world
    q = rng.uniform(-2.0, 2.0, (n, nq)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, (n, nq)).astype(np.float32)
    t = rng.randint(995, 1000, n).astype(np.int32)
    a = rng.uniform(-1.2, 1.2, (n, ks.dyn.n_act)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (q, v, t, a))


def test_struct_fields_follow_the_source():
    body = re.search(r"struct SwimmerParams \{(.*?)\};", SOURCE, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for kind, decl in re.findall(r"\b(int|float) ([^;]*);", body):
        names += [(n.strip(), kind) for n in decl.split(",")]
    have = [(n, "int" if t is ctypes.c_int else "float")
            for n, t in lane_env.SwimmerParams._fields_]
    assert have == names
    assert len(names) == 27


def test_launch_constants_have_one_definition():
    c = lane_env.swimmer_constants()
    assert set(c) == {"kLanes", "kThreads"}
    for name in c:
        defs = [p.name for p in sorted((PKG / "csrc").glob("swimmer*.cu*"))
                if re.search(rf"\b{name}\s*=", p.read_text())]
        assert defs == ["swimmer_lane.cu"], name
    # the source's envs a block and grid follow from the two constants
    assert re.search(r"constexpr int kEnvs = kThreads / kLanes;", SOURCE)
    assert re.search(r"return \(n \+ kEnvs - 1\) / kEnvs;", SOURCE)
    # the wrapper reads them once and keeps no copy of its own
    wrapper = (PKG / "ops" / "lane_env.py").read_text()
    assert "SWIMMER_LANES" not in wrapper and "SWIMMER_THREADS" not in wrapper
    assert lane_env.swimmer_constants() is c
    # a lane for each coordinate of the 3-link chain's row with its two
    # world dofs, whole warps of whole groups, and a lane for each Philox
    # block of a rollout step (2 action words and 2 (5 + 2) reset words)
    assert c["kLanes"] >= 5 + 2 and 32 % c["kLanes"] == 0
    assert c["kThreads"] % 32 == 0 and c["kThreads"] <= 1024
    assert 4 * c["kLanes"] >= 2 + 2 * 7


@pytest.mark.parametrize("n_links", [2, 3])
@pytest.mark.parametrize("num_envs", [1, 31, 4093, 4096, 512000])
def test_the_grid_covers_every_env(n_links, num_envs):
    c = lane_env.swimmer_constants()
    ks = _ks(IDS[n_links])
    for wrapper in (lane_env.SwimmerStep(ks, num_envs),
                    lane_env.SwimmerRollout(ks, num_envs, 4)):
        geo = wrapper.geo
        assert geo == lane_env.swimmer_geometry(n_links, num_envs)
        assert geo.lanes == c["kLanes"] >= n_links + 2 + 2
        assert geo.threads == c["kThreads"] == geo.envs * geo.lanes
        # every env has a group, and no block is wholly past the batch
        assert geo.blocks * geo.envs >= num_envs > (geo.blocks - 1) * geo.envs


def test_the_geometry_refuses_another_chain():
    with pytest.raises(ValueError, match="2 or 3 links"):
        lane_env.swimmer_geometry(4, 8)


@pytest.mark.parametrize("env_id", ["ReacherUMaze-v0", "SwimmerPush-v0"])
def test_cpu_tensors_run_the_plain_versions(env_id):
    ks = _ks(env_id)
    n = 5
    q, v, t, a = _states(ks, n, 3)
    before = dict(lane_env.LAUNCHES)
    got = lane_env.SwimmerStep(ks, n)(q, v, t, a)
    want = swimmer_step_plain(ks, q, v, t, a)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    got = lane_env.SwimmerRollout(ks, n, 3).per_env(q, v, t, 11)
    want = swimmer_rollout_plain(ks, q, v, t, 11, 3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(got[4].sum()) >= 1        # t from 995: some env resets
    assert lane_env.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "stride"])
def test_the_wrappers_refuse_malformed_inputs(bad):
    ks = _ks("ReacherUMaze-v0")
    n = 4
    q, v, t, a = _states(ks, n, 5)
    if bad == "dtype":
        q, err = q.double(), TypeError
    elif bad == "shape":
        q, err = q[:, :3], ValueError
    elif bad == "device":
        q, err = q.to("meta"), ValueError
    else:
        q, err = q.t().contiguous().t(), ValueError
    before = dict(lane_env.LAUNCHES)
    with pytest.raises(err):
        lane_env.SwimmerStep(ks, n)(q, v, t, a)
    with pytest.raises(err):
        lane_env.SwimmerRollout(ks, n, 2)(q, v, t, 1)
    assert lane_env.LAUNCHES == before
