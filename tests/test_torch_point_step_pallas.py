"""The port's plain Point step vs the JAX package's Pallas step kernel.

The Pallas kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it, at 8 envs for 2 steps on PointUMaze-v0; teacher-forced, atol 1e-4
(the kernel-vs-XLA bound of tests/test_pallas.py), terminated exactly.  The
port's lowered spec data also equal ``point_pallas.spec_from_env``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.ops import point_pallas  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch import convert  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_step  # noqa: E402

ENV_ID = "PointUMaze-v0"
B = 8


@pytest.fixture(scope="module")
def sides():
    jenv = jmmt.make_batched(ENV_ID, B, auto_reset=False, fast_step=False)
    tenv = tmmt.make_batched(ENV_ID, B, auto_reset=False, device="cpu")
    return jenv, tenv


def test_lowered_spec_matches_pallas(sides):
    jenv, tenv = sides
    pk = point_pallas.spec_from_env(jenv.spec)
    ours = convert.lowered_spec(make_fast_step(tenv).ks)
    for name, value in ours.items():
        ref = getattr(pk, name)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, np.asarray(ref), err_msg=name)
        else:
            assert value == ref, name


def test_plain_step_matches_pallas_kernel_interpret(sides):
    jenv, tenv = sides
    kern = point_pallas.build_step_kernel(
        point_pallas.spec_from_env(jenv.spec), B, tile=B, interpret=True)
    step = make_fast_step(tenv)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    qpos, qvel = np.asarray(jstate.qpos), np.asarray(jstate.qvel)
    t = np.asarray(jstate.t)
    for _ in range(2):
        act = (rng.uniform(-1, 1, (B, 2)) * [1.0, 0.25]).astype(np.float32)
        kq, kv, kt, kr, km = (np.asarray(x) for x in kern(
            jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(t), jnp.asarray(act)))
        st = convert.from_jax_state(qpos, qvel, t, device="cpu")
        pq, pv, pt, pr, pm = (x.numpy() for x in step(
            st.qpos, st.qvel, st.t, torch.as_tensor(act)))
        np.testing.assert_allclose(pq[:, :2], kq[:, :2], atol=1e-4)
        dori = np.remainder(pq[:, 2] - kq[:, 2] + np.pi, 2 * np.pi) - np.pi
        np.testing.assert_allclose(dori, 0.0, atol=1e-4)
        np.testing.assert_allclose(pv, kv, atol=1e-4)
        np.testing.assert_allclose(pr, kr, atol=1e-4)
        np.testing.assert_array_equal(pt, kt)
        np.testing.assert_array_equal(pm, km)
        qpos, qvel, t = kq, kv, kt
