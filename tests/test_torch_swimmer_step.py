"""The port's Swimmer and Reacher env step vs the JAX package's XLA step
(``spec.step``).

On SwimmerUMaze-v0 (dist reward), SwimmerUMaze-v1 (goal reward),
ReacherUMaze-v0 (2 links, one actuator), SwimmerPush-v0 (a block with two
slide dofs, observed) and SwimmerFall-v0 (an elevated goal whose z the
heads hold against θ, a reference quirk) at B = 8, teacher-forced for 3
steps (every port step starts from the JAX state), from states made with
numpy from a seed: anywhere in the maze, the tail hinges past their ±100°
limits in some envs, blocks displaced, one env on the goal and one at
t = 999.  Bounds: qpos, qvel, obs and reward 1e-4 (the JAX package's
bound between its swimmer kernel and this path, tests/test_swimmer_fast.py);
terminated, truncated and t exactly.

On the CPU the port's step goes through the step kernel's wrapper, which
runs the kernel's plain version (``swimmer_kernel.swimmer_step_plain``,
the closed form of ``ops/swimmer_math.py``).  The JAX reference is one
``jax.jit(jax.vmap(spec.step))`` per ID, compiled once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import swimmer_pallas  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import lane_env, make_fast_step  # noqa: E402

IDS = ["SwimmerUMaze-v0", "SwimmerUMaze-v1", "ReacherUMaze-v0",
       "SwimmerPush-v0", "SwimmerFall-v0"]
B = 8
STEPS = 3
TOL = 1e-4


def swimmer_states(spec, n, seed):
    """Float32 ``(qpos, qvel, t)``: the torso anywhere in the maze's box,
    joint angles over ±2 rad (beyond the ±1.745 limits in envs 3 and 4,
    and in others by chance), world dofs ±0.5, velocities ±1, t over the
    episode."""
    rng = np.random.RandomState(seed)
    xmin, xmax, ymin, ymax = spec.structure.xy_limits()
    s = spec.structure.size_scaling
    q = rng.uniform(-2.0, 2.0, (n, spec.nq))
    q[:, 0] = rng.uniform(xmin * s - spec.structure.torso_x,
                          xmax * s - spec.structure.torso_x, n)
    q[:, 1] = rng.uniform(ymin * s - spec.structure.torso_y,
                          ymax * s - spec.structure.torso_y, n)
    q[:, spec.robot.nq:] *= 0.25
    q[3, 3], q[4, spec.robot.nq - 1] = 1.9, -1.9   # past the limits
    v = rng.uniform(-1.0, 1.0, (n, spec.nv))
    t = rng.randint(0, 999, n).astype(np.int32)
    return q.astype(np.float32), v.astype(np.float32), t


@pytest.fixture(scope="module", params=IDS)
def sides(request):
    jspec = jmmt.make_spec(request.param)
    tenv = tmmt.make_batched(request.param, B, auto_reset=False, device="cpu")
    jstate, _ = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    q, v, t = swimmer_states(tenv.spec, B, seed=len(request.param))
    goal = np.asarray(jspec.heads.goals.pos)[0]
    mask = np.asarray(jspec.heads.goals.dim_mask)[0] > 0
    q[1, :3][mask] = goal[mask]    # on the goal: terminated
    t[2] = 999                     # truncated at the episode limit
    jstate = jstate._replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                             t=jnp.asarray(t))
    return jax.jit(jax.vmap(jspec.step)), jspec, jstate, tenv


def _assert_close(tres, jres):
    for got, want in ((tres.state.qpos, jres.state.qpos),
                      (tres.state.qvel, jres.state.qvel),
                      (tres.obs, jres.obs), (tres.reward, jres.reward)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    for got, want in ((tres.state.t, jres.state.t),
                      (tres.terminated, jres.terminated),
                      (tres.truncated, jres.truncated)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("reward_forward", "reward_ctrl", "position"):
        np.testing.assert_allclose(tres.info[key].numpy(),
                                   np.asarray(jres.info[key]), atol=TOL,
                                   rtol=1e-5)


def test_step_teacher_forced(sides):
    jstep, _, jstate, tenv = sides
    q = np.asarray(jstate.qpos)
    assert (np.abs(q[:, 3:tenv.spec.robot.nq]) > 1.75).any()   # at a limit
    rng = np.random.RandomState(0)
    for k in range(STEPS):
        act = rng.uniform(-1.2, 1.2, (B, tenv.spec.robot.action_dim))
        act = act.astype(np.float32)
        jres = jstep(jstate, jnp.asarray(act))
        tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                        device="cpu")
        tres = tenv.step(tstate, torch.as_tensor(act))
        _assert_close(tres, jres)
        if k == 0:
            assert bool(np.asarray(jres.terminated)[1])
            assert bool(np.asarray(jres.truncated)[2])
        jstate = jres.state


def test_world_dofs_pass_through(sides):
    """The block dofs of SwimmerPush and SwimmerFall never move, and the
    observation carries the block's centre, ``body_pos`` + its slides."""
    jstep, _, jstate, tenv = sides
    spec = tenv.spec
    state = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                   device="cpu")
    res = tenv.step(state, torch.zeros(B, spec.robot.action_dim))
    nr = spec.robot.nq
    torch.testing.assert_close(res.state.qpos[:, nr:], state.qpos[:, nr:],
                               rtol=0, atol=0)
    torch.testing.assert_close(res.state.qvel[:, nr:], state.qvel[:, nr:],
                               rtol=0, atol=0)
    assert res.obs.shape == (B, spec.obs_dim)
    for i, b in enumerate(spec.block_runtimes):
        centre = torch.as_tensor(b.body_pos, dtype=torch.float32).repeat(B, 1)
        for axis, k in enumerate(b.qpos_idx):
            if k >= 0:
                centre[:, axis] = centre[:, axis] + state.qpos[:, k]
        torch.testing.assert_close(res.obs[:, 3 + 3 * i:6 + 3 * i], centre,
                                   rtol=0, atol=0)


def test_step_spec_and_wrapper_agree(sides):
    """The batched env's step (the step wrapper, plain on the CPU) and
    ``spec.step`` give the same state, reward and flags."""
    _, _, jstate, tenv = sides
    state = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                   device="cpu")
    act = torch.as_tensor(np.random.RandomState(1).uniform(
        -1, 1, (B, tenv.spec.robot.action_dim)), dtype=torch.float32)
    a, b = tenv.step(state, act), tenv.spec.step(state, act)
    for x, y in ((a.state.qpos, b.state.qpos), (a.state.qvel, b.state.qvel),
                 (a.reward, b.reward), (a.terminated, b.terminated),
                 (a.obs, b.obs)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_lowered_spec_matches(sides):
    """The kernels' data, field by field, against the JAX package's
    ``swimmer_pallas.spec_from_env``."""
    _, jspec, _, tenv = sides
    step = make_fast_step(tenv)
    assert isinstance(step, lane_env.SwimmerStep)
    got = convert.lowered_spec(step.ks)
    want = swimmer_pallas.spec_from_env(jspec)._asdict()
    dyn = want.pop("dyn")._asdict()
    want.update({f"dyn.{k}": x for k, x in dyn.items()})
    assert set(got) == set(want)
    for name, x in want.items():
        if isinstance(x, (str, bool, int)):
            assert got[name] == x, name
        else:
            np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                       np.asarray(x, np.float64), rtol=1e-7,
                                       err_msg=name)
