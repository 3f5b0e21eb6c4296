"""The studded roller's phase-22 failure, settled on the CPU: float32
rounding on the reference side, with the port held to its readings.

``studded_roller_133.npz`` holds the 26 env-steps of seed 133 that float32
rounding alone put past phase 22's bounds (qpos 1e-5, qvel 1e-4, reward
1e-5) on the Roller with 60 test spheres of 0.1 m at 0.25 m inside its own
(in the SmallBilliard task, 247 candidate contacts): their inputs, and the
generic kernel's outputs (``kq``, ``kv``, ``kr``) and the plain version's
(``pq``, ``pv``, ``pr``) on the card, from one run of ``chip_smoke.py``'s
phase 22 on that placement (NVIDIA H100 80GB HBM3, 700.00 W; the code that
saved them was not kept).  There the kernel lands up to 2.052 times the
float32 spread from the float64 step, past phase 22's limit of 2; phase
22 keeps its studs of 0.05 m at 0.2 m.

Here the same robot is built in both packages (``tests/_torch_engine.py``)
and the same env-steps go through the port's plain version in float32 and
float64 and the JAX package's XLA step (one compile at B = 26 a test):

* in float64 the JAX step is the port's, to 1e-9 in qpos, 1e-7 in qvel
  and 1e-6 in the reward: the same contacts, limits and branches;
* the port's float32 step and the kernel's saved outputs stay within
  BOUND of the float64 step, twice the readings (qpos / qvel / reward:
  plain 1.75e-4 / 5.08e-3 / 2.28e-5, kernel 2.56e-4 / 2.92e-2 / 2.18e-5),
  so that a regression of the port's arithmetic fails here;
* the JAX step lands up to 0.14 (qpos) and 4.7 (qvel) from it, in the
  free ball's velocity, and at least 10 times as far as the port (15.6
  times at the least) on the env-steps where the port finds no active
  contact in any of the 20 forward evaluations: there the ball flies at
  144-547 m/s, up to 108 m from the origin, after blowing up.  The JAX engine forms its
  spatial quantities about the world origin (``physics/engine.py``
  ``kin_dyn``: a rotation dof's ``cross(anchor, axis)``, the spatial
  inertia at the body's world centre of mass), whose terms of order
  |p|^2 |w|^2 cancel in float32; the port's engine turns each tree about
  its own root and forms none of them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401
from _torch_engine import (BALL_SCALE, BALL_TASK, JaxSpec,  # noqa: E402
                           JaxStuddedRoller, jax_library, jax_state, specs)

from mujoco_maze_tpu_torch.ops import engine_kernel  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "studded_roller_133.npz")
TOL = {"qpos": 1e-5, "qvel": 1e-4, "reward": 1e-5}   # phase 22's bounds
# twice the port's readings on these env-steps (plain float32, kernel)
BOUND = {"qpos": 5.2e-4, "qvel": 5.9e-2, "reward": 4.6e-5}
# JAX's float64 step against the port's (readings 1.7e-10 / 6.4e-9 /
# 1.2e-7)
BOUND64 = {"qpos": 1e-9, "qvel": 1e-7, "reward": 1e-6}


def _port64(ks, q, v, t, a):
    return engine_kernel.engine_step_plain(
        ks, torch.as_tensor(q).double(), torch.as_tensor(v).double(),
        torch.as_tensor(t), torch.as_tensor(a).double())


def test_the_jax_step_in_float64_is_the_ports():
    d = np.load(DATA)
    q, v, t, a = d["q"], d["v"], d["t"], d["a"]
    _, ts = specs("Studded")
    ks = engine_kernel.spec_from_env(ts)
    p64 = _port64(ks, q, v, t, a)
    with jax.enable_x64(True):
        task = getattr(jax_library, BALL_TASK)
        js = JaxSpec(robot=JaxStuddedRoller(), maze_task=task,
                     maze_size_scaling=BALL_SCALE,
                     inner_reward_scaling=task.INNER_REWARD_SCALING,
                     dtype=jnp.float64)
        res = jax.jit(jax.vmap(js.step))(
            jax_state(q.astype(np.float64), v.astype(np.float64), t),
            jnp.asarray(a, jnp.float64))
        jx = {"qpos": np.asarray(res.state.qpos),
              "qvel": np.asarray(res.state.qvel),
              "reward": np.asarray(res.reward)}
        term = np.asarray(res.terminated)
    for name, i in (("qpos", 0), ("qvel", 1), ("reward", 3)):
        assert jx[name].dtype == np.float64
        gap = np.abs(jx[name] - p64[i].numpy()).max()
        assert gap <= BOUND64[name], (name, gap)
    assert np.array_equal(term, p64[4].numpy())


def test_the_port_holds_its_readings_and_the_jax_step_does_not():
    d = np.load(DATA)
    q, v, t, a = d["q"], d["v"], d["t"], d["a"]
    assert len(q) == 26
    js, ts = specs("Studded")
    ks = engine_kernel.spec_from_env(ts)
    assert ks.n_cand == 247
    res = jax.jit(jax.vmap(js.step))(jax_state(q, v, t), jnp.asarray(a))
    jx = (res.state.qpos, res.state.qvel, res.reward)
    ins = [torch.as_tensor(x) for x in (q, v, t, a)]
    p32 = engine_kernel.engine_step_plain(ks, *ins)
    p64 = _port64(ks, q, v, t, a)
    # the env-steps where the port finds no active contact at all
    nw = (ks.n_cand + 31) // 32
    trace = engine_kernel.active_trace(ks, ins[0], ins[1], ins[3])
    free = ~(trace[:, :, :nw] != 0).flatten(1).any(dim=1).numpy()
    assert free.sum() >= 10
    kern = (d["kq"], d["kv"], d["kr"])
    far = {}
    for k, (name, i) in enumerate((("qpos", 0), ("qvel", 1), ("reward", 3))):
        ref = p64[i].numpy()

        def dist(x):
            return np.abs(np.asarray(x, np.float64) - ref).reshape(
                len(q), -1).max(axis=1)

        d_jax, d_port, d_kern = dist(jx[k]), dist(p32[i].numpy()), dist(kern[k])
        assert d_port.max() <= BOUND[name], name
        assert d_kern.max() <= BOUND[name], name
        far[name] = d_jax
    # JAX's float32 step lands past the bounds on most of these env-steps
    # and, where no contact is active, at least 10 times as far as the port
    beyond = (far["qpos"] > TOL["qpos"]) | (far["qvel"] > TOL["qvel"])
    assert beyond.sum() >= 20
    d_port = np.maximum(
        np.abs(p32[0].double().numpy() - p64[0].numpy()).max(axis=1),
        np.abs(p32[1].double().numpy() - p64[1].numpy()).max(axis=1))
    d_jax = np.maximum(far["qpos"], far["qvel"])
    assert (d_jax[free] >= 10 * d_port[free]).all()
    assert d_jax.max() > 10 * BOUND["qvel"]
    # t and terminated agree everywhere
    assert np.array_equal(np.asarray(res.state.t), p32[2].numpy())
    assert np.array_equal(np.asarray(res.terminated), p32[4].numpy())
