"""The port's Ant env step in the block worlds vs the JAX package's XLA
step (``spec.step``).

On AntPush-v0, AntFall-v0, AntBlockCarry-v0 (the heads read the block's
center) and AntMultiPushSmall-v0 (three blocks) at B = 8, one step, from
states made with numpy from a seed that put legs on
block faces, blocks at and beyond their travel limits and the Fall block
perched or over the chasm (``ant_kernel.block_states``), with one env on
the goal where the goal can be reached and one at t = 999.  Bounds:
qpos 5e-4 (tests/test_ant_fast.py:256, the JAX kernel's one-step bound
against this path), qvel 5e-3, obs within those two, reward 1e-4,
terminated, truncated and t exactly.

And the Fall mechanic (tests/test_ant_world.py:114-153): from the JAX
reset, 25 zero-action steps perch the falling block (3.80 < z < 4.0; the
MuJoCo probe gives 3.9217), and pushed one cell +y it drops flush
(z < 0.05) within 30 more, on both sides, which agree to 5e-4.

On the CPU the port's step goes through the step kernel's wrapper, which
runs the kernel's plain version (the batched engine).  The JAX reference
is one ``jax.jit(spec.step)`` per ID, compiled once for the module and
called env by env.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops.ant_kernel import block_states  # noqa: E402

IDS = ["AntPush-v0", "AntFall-v0", "AntBlockCarry-v0", "AntMultiPushSmall-v0"]
B = 8
STEPS = 1
QPOS_TOL, QVEL_TOL, REWARD_TOL = 5e-4, 5e-3, 1e-4


def _per_env(fn):
    """``fn`` over a batch, one env at a time: a jitted single-env step
    compiles in about half the time of a vmapped one."""
    def batched(state, act):
        outs = [fn(jax.tree_util.tree_map(lambda x: x[i], state), act[i])
                for i in range(act.shape[0])]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)
    return batched


@functools.lru_cache(maxsize=None)
def _sides(env_id):
    jspec = jmmt.make_spec(env_id)
    tenv = tmmt.make_batched(env_id, B, auto_reset=False, device="cpu")
    jstate, _ = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    return jspec, _per_env(jax.jit(jspec.step)), jstate, tenv


@pytest.fixture(scope="module", params=IDS)
def sides(request):
    env_id = request.param
    jspec, jstep, jstate, tenv = _sides(env_id)
    q, v, t = block_states(tenv.spec, B, seed=len(env_id))
    if env_id == "AntBlockCarry-v0":      # the block on the goal
        (blk,) = tenv.spec.block_runtimes
        goal = np.asarray(jspec.heads.goals.pos)[0]
        for k in range(2):
            q[1, blk.qpos_idx[k]] = goal[k] - blk.body_pos[k]
    elif env_id != "AntFall-v0":          # the ant on the goal (AntFall's
        goal = np.asarray(jspec.heads.goals.pos)[0]   # is out of reach)
        q[1, :2] = goal[:2]
    t[2] = 999                     # truncated at the episode limit
    jstate = jstate._replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                             t=jnp.asarray(t))
    return env_id, jstep, jstate, tenv


def _assert_close(tres, jres, n_blk):
    np.testing.assert_allclose(tres.state.qpos.numpy(),
                               np.asarray(jres.state.qpos), atol=QPOS_TOL, rtol=0)
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
    assert tobs.shape == jobs.shape == (B, 30 + 3 * n_blk)
    pos = 15 + 3 * n_blk           # robot qpos and block centers, then qvel
    np.testing.assert_allclose(tobs[:, :pos], jobs[:, :pos], atol=QPOS_TOL, rtol=0)
    np.testing.assert_allclose(tobs[:, pos:], jobs[:, pos:], atol=QVEL_TOL, rtol=0)
    for key in ("reward_forward", "reward_ctrl", "position"):
        np.testing.assert_allclose(tres.info[key].numpy(),
                                   np.asarray(jres.info[key]), atol=REWARD_TOL,
                                   rtol=1e-5)


def test_step_teacher_forced(sides):
    env_id, jstep, jstate, tenv = sides
    n_blk = len(tenv.spec.block_runtimes)
    rng = np.random.RandomState(0)
    for k in range(STEPS):
        act = rng.uniform(-30, 30, (B, 8)).astype(np.float32)
        jres = jstep(jstate, jnp.asarray(act))
        tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                        device="cpu")
        tres = tenv.step(tstate, torch.as_tensor(act))
        _assert_close(tres, jres, n_blk)
        if k == 0:
            assert bool(np.asarray(jres.terminated)[1]) == (env_id != "AntFall-v0")
            assert bool(np.asarray(jres.truncated)[2])
        jstate = jres.state


def test_step_spec_and_wrapper_agree(sides):
    """The batched env's step (the step wrapper, plain on the CPU) and
    ``spec.step`` give the same state, reward and flags."""
    _, _, jstate, tenv = sides
    state = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                   device="cpu")
    act = torch.as_tensor(np.random.RandomState(1).uniform(-30, 30, (B, 8)),
                          dtype=torch.float32)
    a, b = tenv.step(state, act), tenv.spec.step(state, act)
    for x, y in ((a.state.qpos, b.state.qpos), (a.state.qvel, b.state.qvel),
                 (a.reward, b.reward), (a.terminated, b.terminated),
                 (a.obs, b.obs)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_fall_block_perch_and_chasm_drop():
    jspec, jstep, jstate, tenv = _sides("AntFall-v0")
    (blk,) = tenv.spec.block_runtimes
    _, yq, zq = blk.qpos_idx       # looked up by name, not by adjacency
    zero = np.zeros((B, 8), np.float32)
    tstate = convert.from_jax_state(jstate.qpos, jstate.qvel, jstate.t,
                                    device="cpu")
    for n_steps, push in ((25, False), (30, True)):
        if push:                   # one cell +y: over the chasm
            q = np.asarray(jstate.qpos).copy()
            q[:, yq] = tenv.spec.structure.size_scaling
            jstate = jstate._replace(qpos=jnp.asarray(q))
            tstate = tstate._replace(qpos=torch.as_tensor(q))
        for _ in range(n_steps):
            jstate = jstep(jstate, jnp.asarray(zero)).state
            tstate = tenv.step(tstate, torch.as_tensor(zero)).state
        jz, tz = np.asarray(jstate.qpos)[:, zq], tstate.qpos[:, zq].numpy()
        np.testing.assert_allclose(tz, jz, atol=QPOS_TOL, rtol=0)
        if not push:
            assert (3.80 < tz).all() and (tz < 4.0).all(), tz
        else:
            assert (tz < 0.05).all(), tz
