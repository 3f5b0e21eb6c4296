"""What surrounds the generic engine kernel's groups of lanes, on the CPU.

The step kernel (``csrc/engine_lane.cuh``) steps one env per group of 8
or 32 lanes, with the env's state sized to the model and one contact
slot per candidate contact in shared memory beside the staged tables.
Held here, without a card:

* ``ops/lane_env.engine_geometry`` picks, for every world the kernel
  serves (the Roller in the UMaze, Push, Fall, BlockCarry and SmallBilliard
  tasks, the twin roller, the ball-jointed arm in a fluid, the Roller with
  60 test spheres inside its own in the SmallBilliard task, and the Ant
  model's AntUMaze-v0, AntPush-v0, AntFall-v0 and AntSmallBilliard-v0
  worlds), the smallest size class that holds its dofs, coordinates,
  bodies and, on its lanes, its largest tree, or one env a block of the
  largest class where a warp of that class's groups does not fit; the
  launch fits a block's 227 KB of shared memory and an SM, and gives each
  group a slot for every candidate that ``contact.candidate_count``
  counts, and room for the plain version's 256 candidates with the
  tables at their cap;
* the layout mirrors the source: the caps and size classes, the lane
  widths each class builds, the record and row constants, the fields of
  ``struct EngineParams``' layout and ``struct BlockLists``, the phase
  counters' names;
* each contact's row entries lie on the columns the kernel computes for
  it (the dofs on the root paths of its two bodies): the plain engine's
  dense contact Jacobian has no nonzero entry elsewhere, on contact-rich
  states of RollerUMaze, Roller · SmallBilliard and the AntUMaze-v0 world;
* a model past the caps or past the layout's shared memory raises at the
  wrapper, before any launch.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import chip_smoke  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec  # noqa: E402
from mujoco_maze_tpu_torch.examples.custom_robot import RollerRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import ant_kernel, engine_kernel, lane_env  # noqa: E402
from mujoco_maze_tpu_torch.physics import contact, engine  # noqa: E402
from mujoco_maze_tpu_torch.physics.model import SLIDE, Body, Geom, Joint  # noqa: E402
from mujoco_maze_tpu_torch.tasks.library import GoalRewardUMaze  # noqa: E402

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "mujoco_maze_tpu_torch" / "csrc")
SOURCE = (CSRC / "engine_lane.cuh").read_text()
WORLDS = ["GoalRewardUMaze", "GoalRewardPush", "GoalRewardFall",
          "GoalRewardBlockCarry", "GoalRewardSmallBilliard", "Twin", "Arm",
          "Studded", "AntUMaze-v0", "AntPush-v0", "AntFall-v0",
          "AntSmallBilliard-v0"]
COLUMN_WORLDS = ["GoalRewardUMaze", "GoalRewardSmallBilliard", "AntUMaze-v0"]
B = 6


class TwinRoller(RollerRobot):
    """Two rollers on slides of their own: two trees and a sphere-sphere
    pair between two of the robot's bodies."""

    NAME = "TwinRoller"
    nq = 6
    nv = 6

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        bodies.append(Body(
            name="twin", parent=-1, pos=(1.0, 0.0, torso_z),
            joints=[Joint(SLIDE, axis=a, name=f"twin_{n}")
                    for a, n in (((1, 0, 0), "x"), ((0, 1, 0), "y"),
                                 ((0, 0, 1), "z"))],
            geoms=[Geom(gtype=0, size=(0.4,), contype=1, conaffinity=1,
                        **self.WORLD_GEOM_DEFAULTS)]))
        return bodies, actuators


def _spec(world):
    if world == "Twin":
        return MazeEnvSpec(TwinRoller(), GoalRewardUMaze, 4.0, device="cpu")
    return chip_smoke.engine_spec(world, "cpu")


_KS = {}


def _ks(world):
    if world not in _KS:
        _KS[world] = engine_kernel.spec_from_env(_spec(world))
    return _KS[world]


def _fits(ks) -> bool:
    try:
        lane_env.engine_geometry(ks)
    except NotImplementedError:
        return False
    return True


def _room(ks, own_class=True) -> int:
    """The most candidate contacts ``engine_geometry`` takes for ``ks``'s
    sizes: at a warp of its own size class's groups (``own_class``), or
    at all (one env a block of the largest class past that)."""
    lo, hi = 0, 1 << 14
    while lo < hi:
        mid = (lo + hi + 1) // 2
        x = ks._replace(n_cand=mid)
        ok = _fits(x) and (not own_class
                           or lane_env.engine_geometry(x).cls
                           == lane_env._engine_class(x))
        lo, hi = (mid, hi) if ok else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("world", WORLDS)
def test_geometry_holds_the_model(world):
    ks = _ks(world)
    geo = lane_env.engine_geometry(ks)
    nv_max, nb_max, lanes = lane_env.ENGINE_CLASSES[geo.cls]
    nb = ks.offsets["body"][1]
    tree = lane_env.engine_tree_max(ks)
    assert ks.nv <= nv_max and nb <= nb_max and tree <= lanes == geo.lanes
    assert ks.nq <= lane_env.ENGINE_CAPS["nq"]
    # the smallest class that holds it ...
    own = lane_env._engine_class(ks)
    for smaller in lane_env.ENGINE_CLASSES[:own]:
        assert ks.nv > smaller[0] or nb > smaller[1] or tree > smaller[2]
    # ... unless a warp of its groups overflows a block: then one env a
    # block of the largest class
    if geo.cls != own:
        assert (geo.cls, geo.groups) == (len(lane_env.ENGINE_CLASSES) - 1, 1)
        assert ks.n_cand > _room(ks)
    assert geo.threads == geo.groups * geo.lanes
    assert geo.threads % 32 == 0 and geo.threads <= lane_env.ENGINE_CAPS["threads"]
    assert geo.smem_bytes <= lane_env.SMEM_BLOCK_MAX
    assert geo.groups_per_sm >= 1
    assert geo.smem_bytes == 4 * (-(-ks.packed.numel() // 4) * 4
                                  + geo.blk_floats
                                  + geo.groups * geo.g_floats)
    # the Roller worlds take 8 lanes an env, the Ant model's and the
    # studded roller's (past its class's block) a warp
    wide = world.startswith("Ant") or world == "Studded"
    assert geo.lanes == (32 if wide else 8)
    assert (geo.cls != own) == (world == "Studded")


@pytest.mark.parametrize("world", WORLDS)
def test_room_for_the_plain_versions_candidates(world):
    """With its tables at the cap, every world's sizes take the plain
    version's most candidates (``contact.MAX_ACTIVE_CONTACTS``), and one
    env a block of the largest class takes at least as many as a warp of
    the model's own class."""
    ks = _ks(world)
    cap = lane_env.ENGINE_CAPS["table_floats"]
    full = ks._replace(packed=torch.cat(
        [ks.packed, torch.zeros(cap - ks.packed.numel())]))
    assert _fits(full._replace(n_cand=contact.MAX_ACTIVE_CONTACTS))
    assert _room(ks, own_class=False) >= _room(ks) >= ks.n_cand or (
        world == "Studded")


@pytest.mark.parametrize("world", WORLDS)
def test_a_slot_for_every_candidate(world):
    ks = _ks(world)
    cs = ks.env_spec.contact_set
    assert ks.n_cand == contact.candidate_count(cs)
    groups = int(cs.has_floor) + min(ks.offsets["box"][1], 2)
    # the kernel's slots: sphere by sphere its floor and two picks, then
    # the sphere-sphere pairs, then the sphere-vs-moving-box pairs
    assert ks.n_cand == (ks.n_static * groups + ks.offsets["spair"][1]
                         + ks.offsets["pair"][1])
    fields = dict(lane_env.engine_group_fields(ks))
    assert fields["slot"] == ks.n_cand * (lane_env.ENGINE_REC
                                          + engine_kernel.row_floats(ks.nv))
    assert fields["list"] == ks.n_cand


@pytest.mark.parametrize("world", WORLDS)
def test_layout_is_disjoint_and_sized_to_the_model(world):
    """Each group field lies after the previous one and the group's floats
    cover them all; nothing is sized to the caps: M and M^-1 hold the
    trees' blocks, the dof fields nv entries, the body fields nb."""
    ks = _ks(world)
    geo = lane_env.engine_geometry(ks)
    p = lane_env.engine_params(ks, geo)
    fields = lane_env.engine_group_fields(ks)
    assert [n for n, _ in fields] == list(lane_env.ENGINE_GROUP_FIELDS)
    end = 0
    for name, n in fields:
        assert getattr(p, f"o_{name}") == end
        end += n
    assert end <= geo.g_floats < end + 32
    trees = engine_kernel._trees(ks.env_spec.dynamic_model)
    assert dict(fields)["M"] == p.m_floats == sum(len(t) ** 2 for t in trees)
    assert p.tree_max == max(len(t) for t in trees)
    nb = ks.offsets["body"][1]
    assert dict(fields)["R"] == 9 * nb and dict(fields)["cdof"] == 6 * ks.nv
    blk = lane_env.engine_block_fields(ks)
    assert [n for n, _ in blk] == list(lane_env.ENGINE_BLOCK_FIELDS)
    end = 0
    for name, n in blk:
        assert getattr(p, f"b_{name}") == end
        end += n
    assert end <= geo.blk_floats
    assert p.n_mpairs == sum(len(t) * (len(t) + 1) // 2 for t in trees)
    depth = []
    for par in ks.table("body")[:, 0].astype(int):
        depth.append(0 if par < 0 else depth[par] + 1)
    assert p.n_levels == max(depth) + 1


def _constant(name):
    return int(re.search(rf"\b{name} = (\d+)[,;]", SOURCE).group(1))


def test_constants_and_classes_are_the_sources():
    assert _constant("kRec") == lane_env.ENGINE_REC
    assert _constant("kRowFixed") == engine_kernel.ROW_FIXED
    assert _constant("kMaxThreads") == lane_env.ENGINE_CAPS["threads"]
    for key, name in (("bodies", "kMaxBodies"), ("nv", "kMaxNv"),
                      ("nq", "kMaxNq"), ("nu", "kMaxNu"),
                      ("table_floats", "kMaxTableFloats")):
        assert _constant(name) == lane_env.ENGINE_CAPS[key], key
    # the caps are no lower than the one-thread kernel's
    assert lane_env.ENGINE_CAPS["bodies"] >= 16 and lane_env.ENGINE_CAPS["nv"] >= 24
    assert lane_env.ENGINE_CAPS["nq"] >= 32 and lane_env.ENGINE_CAPS["nu"] >= 16
    small, mid, large = lane_env.ENGINE_CLASSES
    assert small[:2] == (_constant("kSmallNv"), _constant("kSmallNb"))
    assert mid[:2] == (_constant("kMidNv"), _constant("kMidNb"))
    assert large[:2] == (lane_env.ENGINE_CAPS["nv"],
                         lane_env.ENGINE_CAPS["bodies"])
    # the lane width each .cu file instantiates
    for (_, _, lanes), name in zip(lane_env.ENGINE_CLASSES,
                                   ("engine_lane", "engine_mid",
                                    "engine_large")):
        text = (CSRC / f"{name}.cu").read_text()
        call = re.search(r"ENGINE_CLASS_DISPATCH\((.*?)\)\n", text, re.S)
        assert int(call.group(1).split(",")[-1]) == lanes, name


def test_struct_fields_follow_the_layout():
    body = re.search(r"struct EngineParams \{(.*?)\};", SOURCE, re.S).group(1)
    names = re.findall(r"\b(o_\w+|b_\w+)\b", body)
    assert names == ([f"o_{f}" for f in lane_env.ENGINE_GROUP_FIELDS]
                     + [f"b_{f}" for f in lane_env.ENGINE_BLOCK_FIELDS])
    lists = re.search(r"struct BlockLists \{(.*?)\n\};", SOURCE, re.S).group(1)
    members = re.findall(r"const int\* (\w+);", lists)
    assert members == ["rowoff", "dinfo", "binfo", "chain", "jinfo",
                       "sphere_of", "mpairs"]
    assert len(members) == len(lane_env.ENGINE_BLOCK_FIELDS)


def test_phase_names_follow_the_counters():
    """chip_smoke.py --engine-phases names the counters of enum
    EnginePhase."""
    body = re.search(r"enum EnginePhase {(.*?)};", SOURCE, re.S).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "kEngPhaseCount"
    assert len(names) - 1 == len(chip_smoke.ENGINE_PHASES)


def _pairs_bodies(ks):
    """Per candidate, in ``contact._detect``'s order (the kernel's trace
    bits), its two bodies (-1: the static world)."""
    sph, spair, pair = ks.table("sph"), ks.table("spair"), ks.table("pair")
    dbox = ks.table("dbox")
    static = {int(k): s for s, k in enumerate(sph[:, 13]) if k >= 0}
    groups = (ks.n_cand - len(spair) - len(pair)) // max(ks.n_static, 1)
    out = [(int(sph[static[k], 0]), -1)
           for _ in range(groups) for k in range(ks.n_static)]
    out += [(int(sph[int(i), 0]), int(sph[int(j), 0])) for i, j in spair[:, :2]]
    out += [(int(sph[int(s), 0]), int(dbox[int(b), 0])) for s, b in pair[:, :2]]
    return out


@pytest.mark.parametrize("world", COLUMN_WORLDS)
def test_contact_rows_lie_on_the_kernels_columns(world):
    ks = _ks(world)
    spec = ks.env_spec
    model, cs = spec.dynamic_model, spec.contact_set
    if spec.ball_runtimes:
        q, v, _ = engine_kernel.ball_states(spec, B, 3)
    elif world.startswith("Ant"):
        q, v, _ = ant_kernel.contact_states(spec, B, 3)
    else:
        q, v, _ = engine_kernel.sphere_robot_states(spec, B, 3)
    q, v = torch.as_tensor(q), torch.as_tensor(v)
    _, chain_mask, _, _ = engine.get_masks(model)
    kd = engine.kin_dyn(model, q, v)
    K = contact._consts(model, cs, chain_mask, q)
    dist, pos, normal, margin, _ = contact._detect(cs, K, kd)
    # contact_qfrc's rows of the normal direction
    cdof_T = kd.cdof.transpose(-1, -2)
    J = torch.cat([torch.cat([torch.linalg.cross(
        pos - kd.body_origin[:, root, None], normal), normal], dim=-1)
        @ cdof_T[:, :, dofs] for root, dofs in K.trees], dim=-1)
    J = J[..., K.tree_order] * K.sign_mask                  # (B, C, nv)
    bodies = _pairs_bodies(ks)
    assert len(bodies) == J.shape[1] == ks.n_cand
    chain = ks.table("body")[:, 25].astype(np.int64)
    nonzero = (J != 0).numpy()
    for c, (a, b) in enumerate(bodies):
        bits = int(chain[a]) | (int(chain[b]) if b >= 0 else 0)
        off = [d for d in range(ks.nv) if not (bits >> d) & 1]
        assert not nonzero[:, c, off].any(), (world, c, a, b)
    # the states reach contacts, and in the ball world the ball's columns
    active = (dist < margin).numpy()
    assert active.any()
    if spec.ball_runtimes:
        ball = nonzero[:, :, 3:].any(axis=-1) & active
        assert ball.any()


def test_past_the_layout_or_the_caps_raises(monkeypatch):
    ks = _ks("AntSmallBilliard-v0")
    many = ks._replace(n_cand=4000)
    with pytest.raises(NotImplementedError, match="shared memory"):
        lane_env.engine_geometry(many)
    # the wrapper checks it before anything is launched or built
    with pytest.raises(NotImplementedError, match="shared memory"):
        lane_env.EngineStep(many, 4).launch_shape()
    with pytest.raises(NotImplementedError, match="caps"):
        lane_env.engine_geometry(ks._replace(nu=17))
    # the Roller past a warp of its class's groups: one env a block of the
    # largest class; past that, the limit
    roller = _ks("GoalRewardUMaze")
    n = _room(roller)
    assert lane_env.engine_geometry(roller._replace(n_cand=n)).cls == 0
    geo = lane_env.engine_geometry(roller._replace(n_cand=n + 1))
    assert (geo.cls, geo.lanes, geo.groups) == (2, 32, 1)
    with pytest.raises(NotImplementedError, match="shared memory"):
        lane_env.engine_geometry(roller._replace(
            n_cand=_room(roller, own_class=False) + 1))
    # a tree larger than 8 lanes takes the warp-wide class
    monkeypatch.setattr(lane_env, "engine_tree_max", lambda ks: 12)
    geo = lane_env.engine_geometry(_ks("GoalRewardSmallBilliard"))
    assert (geo.cls, geo.lanes) == (2, 32)
