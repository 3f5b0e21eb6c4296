"""The Ant kernel's ball worlds (AntSmallBilliard-v0, -v1, -v2): what the
port lowers for the CUDA ``ant_balls_step`` / ``ant_balls_rollout``
kernels, against what the JAX kernel reads, and the plain versions' parts
that the card's checks lean on.  Nothing is traced.

* The lowered tables against ``ant_pallas.spec_from_env`` (its
  ``AntConsts``, ``AntWorld`` and ``AntEnvKernelSpec``), float32: the
  ball's row against ``aw.balls[0]`` (``ant_math.AntBall``) and each
  sphere-ball pair's mixed constants against those of
  ``ant_math._ball_rows`` (:862-866: margins summed, solimp averaged, the
  larger time constant and friction), exactly.
* The kernel's scalars, bounds and launch names; the step wrapper's
  shapes at nq 22, nv 20.
* ``active_trace``: every candidate's kernel bit (the ball's after the
  ant's 111, 151 in all) set exactly where ``contact._detect`` finds the
  candidate active.
* ``ball_states`` covers each case it promises, the ant 50-80 m from the
  ball among them.
* ``ant_rollout_plain``: an env that resets draws the ant's reset exactly
  and puts the ball back at ``qpos0`` (position and quaternion), at rest.
* A second ball, or a ball beside movable blocks, is refused (no stock ID
  has either).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import ant_pallas  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec  # noqa: E402
from mujoco_maze_tpu_torch.maze.cells import MazeCell  # noqa: E402
from mujoco_maze_tpu_torch.models.ant import AntRobot  # noqa: E402
from mujoco_maze_tpu_torch.ops import (ant_kernel, lane_env,  # noqa: E402
                                       make_fast_rollout, make_fast_step)
from mujoco_maze_tpu_torch.physics import contact, engine  # noqa: E402
from mujoco_maze_tpu_torch.physics.model import _quat_to_mat_np  # noqa: E402
from mujoco_maze_tpu_torch.tasks import library  # noqa: E402

IDS = ["AntSmallBilliard-v0", "AntSmallBilliard-v1", "AntSmallBilliard-v2"]
B = 64


@pytest.fixture(scope="module", params=IDS)
def sides(request):
    jspec = jmmt.make_spec(request.param)
    tspec = tmmt.make_spec(request.param, device="cpu")
    return jspec, tspec, ant_kernel.spec_from_env(tspec)


@pytest.fixture(scope="module")
def states():
    spec = tmmt.make_spec(IDS[0], device="cpu")
    ks = ant_kernel.spec_from_env(spec)
    return spec, ks, ant_kernel.ball_states(spec, B, 3)


def test_kernel_tables_match_the_jax_kernel(sides):
    jspec, _, ks = sides
    es = ant_pallas.spec_from_env(jspec)
    for name, val in convert.lowered_spec(ks).items():
        src = (es.ac if name in es.ac._fields
               else es.aw if name in es.aw._fields else es)
        ref = getattr(src, name)
        if name in ("masses", "coms", "inertias", "armature", "damping"):
            # the JAX constants run over every body and dof; the kernel's
            # body and dof tables hold the ant's, the ball's mass and
            # inertia sit in its own table and its dofs have neither
            # armature nor damping
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
    assert (ks.n_w, ks.n_blk, ks.n_ball) == (0, 0, 1)
    assert (es.nq, es.nv, es.obs_offset) == (22, 20, 3)


def test_ball_and_pair_tables_match_the_jax_ball_rows(sides):
    jspec, _, ks = sides
    aw = ant_pallas.spec_from_env(jspec).aw
    (jb,) = aw.balls
    (ours,) = convert.lowered_balls(ks)
    f32 = np.float32
    for name in ("qadr", "vadr"):
        assert ours[name] == getattr(jb, name), name
    for name in ("radius", "mass", "inertia", "margin", "solref_tc",
                 "friction"):
        assert ours[name] == f32(getattr(jb, name)), name
    for name in ("com", "solimp"):
        np.testing.assert_array_equal(ours[name],
                                      np.asarray(getattr(jb, name), f32),
                                      err_msg=name)
    assert ours["floor_margin"] == f32(f32(jb.margin + aw.floor_margin)
                                       - f32(jb.margin))
    assert ours["dampr"] == 1.0
    # _ball_rows :858-866, sphere s against the ball
    S = len(aw.sph_body)
    assert len(ours["pair_margin"]) == S == 37
    for s in range(S):
        np.testing.assert_array_equal(
            ours["pair_margin"][s], f32(float(aw.sph_margin[s]) + jb.margin))
        np.testing.assert_array_equal(
            ours["pair_solimp"][s],
            np.asarray([0.5 * (float(aw.sph_solimp[s][k]) + jb.solimp[k])
                        for k in range(3)], f32))
        assert ours["pair_solref_tc"][s] == f32(max(aw.solref_tc,
                                                    jb.solref_tc))
        assert ours["pair_friction"][s] == f32(max(aw.friction, jb.friction))
        assert ours["pair_dampr"][s] == 1.0


def test_params_bounds_and_route(sides):
    _, tspec, ks = sides
    p = lane_env.ant_params(ks)
    assert (p.n_w, p.n_blk, p.n_ball, p.n_sph, p.n_box) == (0, 0, 1, 37, 16)
    assert (p.off_ball, p.off_bpair) == (ks.offsets["ball"][0],
                                         ks.offsets["bpair"][0])
    assert p.n_floats == ks.packed.numel() == p.off_bpair + 37 * 7
    assert lane_env._ant_dims(ks) == (22, 20)
    assert lane_env._ant_kernel_name(ks, "step") == "ant_balls_step"
    assert lane_env._ant_kernel_name(ks, "rollout") == "ant_balls_rollout"
    assert {"ant_balls_step", "ant_balls_rollout"} <= set(lane_env.LAUNCHES)
    # the worlds without a ball keep their tables, offsets and names
    for env_id, name in (("AntUMaze-v0", "ant_step"),
                         ("AntPush-v0", "ant_blocks_step")):
        other = ant_kernel.spec_from_env(tmmt.make_spec(env_id, device="cpu"))
        assert other.n_ball == 0 and other.offsets["ball"][1] == 0
        assert other.offsets["bpair"] == (other.packed.numel(), 0, 7)
        assert lane_env._ant_kernel_name(other, "step") == name


def test_step_wrapper_shapes_and_checks():
    env = tmmt.make_batched(IDS[0], 4, device="cpu")
    step = make_fast_step(env)
    assert isinstance(step, lane_env.AntStep)
    assert isinstance(make_fast_rollout(env, 2), lane_env.AntRollout)
    state, _ = env.reset(0)
    before = dict(lane_env.LAUNCHES)
    q, v, t, r, m = step(state.qpos, state.qvel, state.t, torch.zeros(4, 8))
    assert lane_env.LAUNCHES == before           # the plain version
    assert q.shape == (4, 22) and v.shape == (4, 20)
    assert torch.isfinite(q).all() and torch.isfinite(v).all()
    with pytest.raises(ValueError):
        step(state.qpos[:, :21], state.qvel, state.t, torch.zeros(4, 8))
    with pytest.raises(ValueError):
        step(state.qpos, state.qvel[:, :14], state.t, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="kernel"):
        step(state.qpos, state.qvel, state.t, torch.zeros(4, 8), trace=True)


def test_active_trace_ball_bits_match_detect(states):
    """Each candidate's kernel bit (``detail``: the bits of _detect's
    order) is set at every forward evaluation exactly where dist <
    margin; at the first evaluation (the start state) that is
    ``contact._detect``'s own verdict; the ball's 40 candidates take bits
    111-150 (floor, box picks, then the 37 sphere pairs)."""
    spec, ks, (q, v, _) = states
    q, v = torch.as_tensor(q[:16]), torch.as_tensor(v[:16])
    a = torch.as_tensor(np.random.RandomState(0).uniform(-30, 30, (16, 8)),
                        dtype=torch.float32)
    tr, info = ant_kernel.active_trace(ks, q, v, a, detail=True)
    bits = info["bits"].tolist()
    assert len(bits) == len(set(bits)) == 151 and max(bits) == 150
    cs = spec.contact_set
    ball = [c for c, b in enumerate(bits) if b >= 111]
    statics = np.nonzero(cs.sph_vs_static)[0]
    assert [bits[c] for c in ball] == [111, 112, 113] + list(range(114, 151))
    assert [int(statics[c % 38]) for c in ball[:3]] == [37, 37, 37]
    words = tr.to(torch.int64) & 0xFFFFFFFF
    b = torch.as_tensor(bits)
    on = ((words[:, :, b // 32] >> (b % 32)) & 1).bool()      # (B, E, C)
    assert torch.equal(on, info["gap"] < 0)
    # the start state, by contact._detect directly
    model = spec.dynamic_model
    q0 = engine.integrate_pos(model, q, v, 0.0)
    _, chain_mask, _, _ = engine.get_masks(model)
    kd = engine.kin_dyn(model, q0, v)
    dist, _, _, margin, _ = contact._detect(
        cs, contact._consts(model, cs, chain_mask, q0), kd)
    assert torch.equal(on[:, 0], dist < margin)
    assert on[:, :, ball].any(), "no ball contact in the checked states"


def test_ball_states_cover_every_case(states):
    spec, ks, (q, v, t) = states
    assert q.shape == (B, 22) and v.shape == (B, 20) and t.shape == (B,)
    assert q.dtype == v.dtype == np.float32 and t.dtype == np.int32
    cs, model = spec.contact_set, spec.dynamic_model
    floor, walls, pairs = (x.numpy() for x in ant_kernel.ball_census(
        ks, torch.as_tensor(q)))
    mode = np.arange(B) % 8
    R = np.stack([_quat_to_mat_np(x) for x in q[:, 18:22]])
    centre = q[:, 15:18] + R @ cs.sph_local[37]
    # on the floor but in the capsule presses
    bottom = centre[:, 2] - 0.4
    assert np.all(np.abs(bottom[mode != 4]) <= 0.0101)
    assert floor[mode != 4].all()
    assert (pairs[mode == 0] >= 1).all()               # a leg on the ball
    assert (walls[(mode == 1) | (mode == 5)] >= 1).all()  # walls, corners
    assert (walls[(mode == 1) | (mode == 5)] >= 2).any()
    assert (pairs[mode == 4] >= 1).all()               # a capsule pressed
    assert (pairs[mode == 4] >= 2).mean() >= 0.75      # two spheres of it
    far = np.linalg.norm(q[:, :2] - q[:, 15:17], axis=1)
    assert np.all((far[mode == 5] >= 50.0) & (far[mode == 5] <= 80.0))
    assert np.all(far[mode != 5] < 10.0)
    g = spec.heads.goals
    d = np.linalg.norm((q[:, 15:18] - g.pos[0].numpy()) * g.dim_mask[0].numpy(),
                       axis=1)
    thr = float(g.threshold[0])
    assert np.all(np.abs(d[mode == 6] - thr) <= 0.02)   # the knife edge
    assert (d[mode == 6] < thr).any() and (d[mode == 6] > thr).any()
    spin = np.einsum("bij,bj->bi", R, v[:, 17:20])     # world spin
    fast = np.abs(spin[mode == 7, 2])
    assert np.all((fast >= 10.0 - 1e-4) & (fast <= 20.0 + 1e-4))
    assert np.abs(spin[mode == 7, :2]).max() < 5.0     # about the vertical
    assert np.abs(v[mode != 7, 17:20]).max() < 15.0
    # no test sphere more than 0.02 into a wall
    c = ant_kernel._sphere_offsets(spec, q.astype(np.float64))[:, :37]
    c = c + q[:, None, :3]
    r = cs.sph_radius[:37]
    for e in range(B):
        assert ant_kernel._box_dist(c[e], r, cs.box_center,
                                    cs.box_half).min() >= -0.0201
    assert t.min() < 200 and t.max() > 800


def test_rollout_plain_resets_the_ball():
    """Envs at t = 999 truncate on the rollout's only step and end on that
    step's reset draw: the ant's drawn, the ball at qpos0 (its position
    and quaternion) and at rest."""
    env = tmmt.make_batched(IDS[0], 4, device="cpu")
    spec, ks = env.spec, make_fast_step(env).ks
    q, v, _ = (torch.as_tensor(x) for x in ant_kernel.ball_states(spec, 4, 5))
    t0 = torch.full((4,), 999, dtype=torch.int32)
    qo, vo, to, rew, eps = ant_kernel.ant_rollout_plain(ks, q, v, t0, 5, 1)
    idx = torch.arange(4, dtype=torch.int64)
    q_r, v_r = ant_kernel.rollout_reset(idx, 0, 5, spec.init_qpos, spec.nv)
    assert q_r.shape == (4, 22) and v_r.shape == (4, 20)
    torch.testing.assert_close(qo, q_r, rtol=0, atol=0)
    torch.testing.assert_close(vo, v_r, rtol=0, atol=0)
    qpos0 = torch.as_tensor(spec.init_qpos[15:], dtype=torch.float32)
    assert (qo[:, 15:] == qpos0).all() and (vo[:, 14:] == 0).all()
    assert qpos0[3] == 1.0                       # the identity quaternion
    assert (to == 0).all() and (eps == 1).all() and torch.isfinite(rew).all()
    # the ant's draws are the object-free mazes' words
    q15, v14 = ant_kernel.rollout_reset(idx, 0, 5, spec.init_qpos[:15])
    torch.testing.assert_close(q_r[:, :15], q15, rtol=0, atol=0)
    torch.testing.assert_close(v_r[:, :14], v14, rtol=0, atol=0)


class _TwoBalls(library.GoalRewardSmallBilliard):
    @staticmethod
    def create_maze():
        maze = library.GoalRewardSmallBilliard.create_maze()
        maze[1][1] = MazeCell.OBJECT_BALL
        return maze


class _BallAndBlock(library.GoalRewardSmallBilliard):
    OBSERVE_BLOCKS = True

    @staticmethod
    def create_maze():
        maze = library.GoalRewardSmallBilliard.create_maze()
        maze[1][1] = MazeCell.XY_BLOCK
        return maze


@pytest.mark.parametrize("task", [_TwoBalls, _BallAndBlock])
def test_a_second_ball_or_a_ball_beside_blocks_is_refused(task):
    spec = MazeEnvSpec(AntRobot(), task, 2.0, device="cpu")
    with pytest.raises(NotImplementedError, match="no stock ID"):
        ant_kernel.spec_from_env(spec)
