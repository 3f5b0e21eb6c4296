"""What surrounds the Ant kernels' groups of lanes, on the CPU.

The step and rollout kernels (``csrc/ant_lane.cuh``) step one env per warp,
with the env's state and one contact slot per candidate contact in shared
memory beside the staged tables.  Held here, without a card:

* the launch shape ``ops/lane_env.ant_geometry`` computes for every one of
  the 45 Ant IDs fits a block's 227 KB of shared memory and an SM, and
  gives each group a slot for every candidate contact a sphere can have
  (floor, two static boxes, each block, the ball) and for the ball's own
  three, counted here from the contact set;
* the layout constants it mirrors are the source's;
* each contact's row entries lie on the columns the kernel keeps for it
  (the sphere body's root-path dofs, the pair's block slides, the ball's
  six): the plain engine's dense contact Jacobian (``physics/contact.py``
  ``contact_qfrc``'s rows) has no nonzero entry elsewhere, on the
  contact-rich states of AntUMaze-v0, AntPush-v0, AntFall-v0 and
  AntSmallBilliard-v0.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

from mujoco_maze_tpu_torch import registry  # noqa: E402
from mujoco_maze_tpu_torch.ops import ant_kernel, lane_env  # noqa: E402
from mujoco_maze_tpu_torch.physics import contact, engine  # noqa: E402

SOURCE = (pathlib.Path(__file__).resolve().parent.parent
          / "mujoco_maze_tpu_torch" / "csrc" / "ant_lane.cuh").read_text()
ANT_IDS = [i for i in registry.env_ids() if i.startswith("Ant")]
COLUMN_IDS = ["AntUMaze-v0", "AntPush-v0", "AntFall-v0",
              "AntSmallBilliard-v0"]
B = 6


def _ks(env_id):
    return ant_kernel.spec_from_env(registry.make_spec(env_id, device="cpu"))


def test_every_ant_id_is_here():
    assert len(ANT_IDS) == 45


@pytest.mark.parametrize("env_id", ANT_IDS)
def test_launch_shape_fits_and_holds_every_candidate(env_id):
    ks = _ks(env_id)
    geo = lane_env.ant_geometry(ks)
    cs = ks.env_spec.contact_set
    spheres = int((cs.sph_vs_static & (cs.sph_body < ant_kernel.NB)).sum())
    per_sphere = 3 + ks.n_blk + ks.n_ball      # floor, two boxes, objects
    assert geo.slots >= spheres * per_sphere + 3 * ks.n_ball
    # the candidates the plain engine detects, the ant's and the ball's
    assert geo.slots >= contact.candidate_count(cs)
    assert geo.smem_bytes <= lane_env.SMEM_BLOCK_MAX
    assert geo.groups_per_sm >= 1
    assert geo.threads == geo.groups * lane_env.ANT_LANES <= 256
    w, nb = ((ant_kernel.MAX_WORLD_DOFS, ant_kernel.MAX_BLOCKS) if ks.n_w
             else (0, 0))
    nv = 14 + w + 6 * ks.n_ball
    group = (lane_env.ant_group_floats(w, nb, ks.n_ball)
             + geo.slots * (lane_env.ANT_CON_STRIDE + 1)
             + lane_env.ANT_LANES * (nv + 1))
    assert geo.smem_bytes >= 4 * (ks.packed.numel() + geo.groups * group)
    # no count of groups a block that the default passes over holds more
    # groups on an SM
    for g in (1, 2, 4, 8):
        try:
            other = lane_env.ant_geometry(ks, g)
        except NotImplementedError:
            continue
        assert other.groups_per_sm <= geo.groups_per_sm


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_layout_constants_are_the_sources():
    assert _constant("kLanes") == lane_env.ANT_LANES
    assert _constant("kConStride") == lane_env.ANT_CON_STRIDE
    assert _constant("kMaxThreads") == lane_env.ANT_MAX_GROUPS * lane_env.ANT_LANES
    # the contact slot's last field, three forces, ends the slot
    assert _constant("kCF") + 3 == lane_env.ANT_CON_STRIDE
    nb, bd = _constant("kNb"), _constant("kBodyDofs")
    assert lane_env.ANT_SCRATCH_FLOATS == nb * bd * 9 + nb * 18


def test_phase_names_follow_the_counters():
    """chip_smoke.py --ant-phases names the counters of enum AntPhase."""
    import chip_smoke

    body = re.search(r"enum AntPhase {(.*?)};", SOURCE, re.S).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "kPhaseCount"
    assert len(names) - 1 == len(chip_smoke.ANT_PHASES)


@pytest.mark.parametrize("w, nb, nball", [(0, 0, 0), (6, 3, 0), (0, 0, 1)])
def test_group_floats_count_the_group_struct(w, nb, nball):
    """``ant_group_floats`` against the members of ``struct Group`` (and
    the ``Kin``, ``Ball`` and ``BallSlot`` it holds) as the source
    declares them, every one 4 bytes."""
    nv = 14 + w + 6 * nball
    sizes = {"kNq": nv + 1 + nball, "kNv": nv, "kNu": 8, "kNb": 13,
             "kNa": 14, "NBLK > 0 ? NBLK : 1": max(nb, 1)}

    def count(struct):
        body = re.search(rf"struct {struct} {{(.*?)\n}};", SOURCE, re.S)
        n = 0
        for decl in body.group(1).split(";"):
            decl = re.sub(r"//.*", "", decl).strip()
            if not decl or decl.startswith(("static", "Kin", "BallSlot",
                                            "Ball ")):
                continue
            for var in decl.split(" ", 1)[1].split(","):
                k = 1
                for dim in re.findall(r"\[([^\]]+)\]", var):
                    k *= sizes[dim] if dim in sizes else int(dim)
                n += k
        return n

    ball = count("Ball") + 36 if nball else 1
    assert (count("Group") + count("Kin") + ball
            == lane_env.ant_group_floats(w, nb, nball))


def _kernel_columns(ks, bit):
    """The dofs the kernel keeps for the contact of trace bit ``bit``."""
    S = ks.offsets["sph"][1]
    ball_bit = (3 + ks.n_blk) * S
    body, sph = ks.table("body"), ks.table("sph")
    cols = set()

    def path(s):
        return set(range(6)) | {int(d) for d in body[int(sph[s, 0]), 2:4]
                                if d >= 0}

    if bit < ball_bit:
        kind, s = divmod(bit, S)
        cols |= path(s)
        if kind >= 3:
            first, count = (int(x) for x in ks.table("blk")[kind - 3, 6:8])
            cols |= set(range(first, first + count))
        return cols
    va = int(ks.table("ball")[0, 1])
    if bit - ball_bit >= 3:
        cols |= path(bit - ball_bit - 3)
    return cols | set(range(va, va + 6))


@pytest.mark.parametrize("env_id", COLUMN_IDS)
def test_contact_rows_lie_on_the_kernels_columns(env_id):
    ks = _ks(env_id)
    spec = ks.env_spec
    model, cs = spec.dynamic_model, spec.contact_set
    draw = (ant_kernel.ball_states if ks.n_ball else ant_kernel.block_states
            if ks.n_w else ant_kernel.contact_states)
    q, v, _ = (torch.as_tensor(x) for x in draw(spec, B, 3))
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
    _, info = ant_kernel.active_trace(
        ks, q, v, torch.zeros(B, 8), detail=True)
    bits = info["bits"].tolist()
    assert len(bits) == J.shape[1]
    nonzero = (J != 0).numpy()
    active = (dist < margin).numpy()
    for c, bit in enumerate(bits):
        off = sorted(set(range(J.shape[2])) - _kernel_columns(ks, bit))
        assert not nonzero[:, c, off].any(), (env_id, c, bit)
    # the states reach the objects: some active rows carry a block's or
    # the ball's columns
    if ks.n_w or ks.n_ball:
        world = nonzero[:, :, 14:].any(axis=-1) & active
        assert world.any()
