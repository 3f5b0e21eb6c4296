"""The port's Ant env step vs the JAX package's XLA step (``spec.step``).

On AntUMaze-v0 (dist reward), AntUMaze-v1 (goal reward) and Ant4Rooms-v0
at B = 8, teacher-forced for a few steps (every port step starts from the
JAX state), from states made with numpy from a seed that put the feet on
the floor and half the ants against a wall, anywhere in the maze
(``ant_kernel.contact_states``), with one env on the goal and one at
t = 999.  Bounds: qpos 5e-4 (tests/test_ant_fast.py's one-step bound for
the JAX ant kernel against this path), qvel 5e-3, obs within those two,
reward 1e-4, terminated, truncated and t exactly.

Measured on these states: qpos within 6e-6 and qvel within 3e-4 of the
JAX step, with the ants up to 34 from the world origin.

On the CPU the port's step goes through the step kernel's wrapper, which
runs the kernel's plain version (``ant_kernel.ant_step_plain``, the
batched engine).  The JAX reference is one ``jax.jit(jax.vmap(spec.step))``
per ID, compiled once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_step  # noqa: E402
from mujoco_maze_tpu_torch.ops.ant_kernel import (contact_census,  # noqa: E402
                                                  contact_states)

IDS = ["AntUMaze-v0", "AntUMaze-v1", "Ant4Rooms-v0"]
B = 8
STEPS = 3
QPOS_TOL, QVEL_TOL, REWARD_TOL = 5e-4, 5e-3, 1e-4


@pytest.fixture(scope="module", params=IDS)
def sides(request):
    jspec = jmmt.make_spec(request.param)
    tenv = tmmt.make_batched(request.param, B, auto_reset=False, device="cpu")
    jstate, _ = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    q, v, t = contact_states(tenv.spec, B, seed=len(request.param))
    goal = np.asarray(jspec.heads.goals.pos)[0]
    q[1, :2] = goal[:2]            # on the goal: terminated, goal reward
    t[2] = 999                     # truncated at the episode limit
    jstate = jstate._replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                             t=jnp.asarray(t))
    return jax.jit(jax.vmap(jspec.step)), jstate, tenv


def _assert_close(tres, jres):
    tq, jq = tres.state.qpos.numpy(), np.asarray(jres.state.qpos)
    np.testing.assert_allclose(tq, jq, atol=QPOS_TOL, rtol=0)
    np.testing.assert_allclose(tres.state.qvel.numpy(),
                               np.asarray(jres.state.qvel), atol=QVEL_TOL, rtol=0)
    np.testing.assert_array_equal(tres.state.t.numpy(), np.asarray(jres.state.t))
    np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                               atol=REWARD_TOL, rtol=0)
    np.testing.assert_array_equal(tres.terminated.numpy(),
                                  np.asarray(jres.terminated))
    np.testing.assert_array_equal(tres.truncated.numpy(),
                                  np.asarray(jres.truncated))
    tobs, jobs = tres.obs.numpy(), np.asarray(jres.obs)
    np.testing.assert_allclose(tobs[:, :15], jobs[:, :15], atol=QPOS_TOL, rtol=0)
    np.testing.assert_allclose(tobs[:, 15:], jobs[:, 15:], atol=QVEL_TOL, rtol=0)
    for key in ("reward_forward", "reward_ctrl", "position"):
        np.testing.assert_allclose(tres.info[key].numpy(),
                                   np.asarray(jres.info[key]), atol=REWARD_TOL,
                                   rtol=1e-5)


def test_step_teacher_forced(sides):
    jstep, jstate, tenv = sides
    ks = make_fast_step(tenv).ks
    floor, walls = contact_census(ks, torch.tensor(np.asarray(jstate.qpos)))
    assert (floor > 0).sum() >= B // 2 and (walls > 0).sum() >= 1
    rng = np.random.RandomState(0)
    for k in range(STEPS):
        act = rng.uniform(-30, 30, (B, 8)).astype(np.float32)
        jres = jstep(jstate, jnp.asarray(act))
        tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                        device="cpu")
        tres = tenv.step(tstate, torch.as_tensor(act))
        _assert_close(tres, jres)
        if k == 0:
            assert bool(np.asarray(jres.terminated)[1])
            assert bool(np.asarray(jres.truncated)[2])
        jstate = jres.state


def test_step_spec_and_wrapper_agree(sides):
    """The batched env's step (the step wrapper, plain on the CPU) and
    ``spec.step`` give the same state, reward and flags."""
    _, jstate, tenv = sides
    state = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                   device="cpu")
    act = torch.as_tensor(np.random.RandomState(1).uniform(-30, 30, (B, 8)),
                          dtype=torch.float32)
    a, b = tenv.step(state, act), tenv.spec.step(state, act)
    for x, y in ((a.state.qpos, b.state.qpos), (a.state.qvel, b.state.qvel),
                 (a.reward, b.reward), (a.terminated, b.terminated),
                 (a.obs, b.obs)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_heading_matches(sides):
    """``get_ori``: the torso's x axis projected on the xy plane."""
    _, jstate, tenv = sides
    q = np.asarray(jstate.qpos).copy()
    q[:, 3:7] = np.random.RandomState(3).normal(size=(B, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    jrobot = jmmt.make_spec("AntUMaze-v0").robot
    jori = np.asarray(jax.vmap(jrobot.get_ori)(jnp.asarray(q)))
    tori = tenv.spec.robot.get_ori(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(tori, jori, atol=1e-5)
