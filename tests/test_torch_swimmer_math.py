"""The Swimmer's and the Reacher's dynamics in the port vs the JAX package,
in float64.

Three routes compute the same accelerations: the generic engine with the
fluid drag (``physics/engine.py`` ``forward``, ``fluid_force``), the
closed form (``ops/swimmer_math.py``, the plain version of the swimmer
kernels) and, on the JAX side, both of them again.  Bounds are those of
the JAX package's own closed-form test (tests/test_swimmer_fast.py):
1e-9 on qacc, 1e-10 on qpos over a 50-step RK4 trajectory.  States are
drawn with numpy from a seed, with the tail hinges beyond their ±100°
limits in some envs so that the limit impedance acts.

The JAX functions run under ``jax.jit(jax.vmap(...))``, compiled once per
model for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

from mujoco_maze_tpu.models.reacher import build_reacher_model as j_reacher  # noqa: E402
from mujoco_maze_tpu.models.swimmer import build_swimmer_model as j_swimmer  # noqa: E402
from mujoco_maze_tpu.ops import swimmer_math as jsw  # noqa: E402
from mujoco_maze_tpu.physics import engine as jeng  # noqa: E402

from mujoco_maze_tpu_torch.models.swimmer import build_swimmer_model  # noqa: E402
from mujoco_maze_tpu_torch.ops import swimmer_math as tsw  # noqa: E402
from mujoco_maze_tpu_torch.physics import engine as teng  # noqa: E402

B = 8
FORWARD_TOL, TRAJ_TOL = 1e-9, 1e-10


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", params=[3, 2], ids=["swimmer", "reacher"])
def models(request, x64):
    n_links = request.param
    tm = teng.prepare(build_swimmer_model(n_links))
    jm = jeng.prepare(j_swimmer() if n_links == 3 else j_reacher())
    jks = jsw.spec_from_model(jm)
    n = 2 + n_links

    def j_closed(q, v, c):
        return jnp.stack(jsw.forward_swimmer(
            jks, tuple(q[i] for i in range(n)), tuple(v[i] for i in range(n)),
            tuple(c[i] for i in range(n_links - 1))))

    def j_fluid(q, v):
        return jeng.fluid_force(jm, jeng.kin_dyn(jm, q, v), v)

    jfns = {
        "forward": jax.jit(jax.vmap(lambda q, v, c: jeng.forward(jm, q, v, c))),
        "closed": jax.jit(jax.vmap(j_closed)),
        "fluid": jax.jit(jax.vmap(j_fluid)),
    }
    return tm, jm, jfns, n_links


def _inputs(n_links, seed):
    rng = np.random.RandomState(seed)
    n = 2 + n_links
    q = rng.uniform(-2.0, 2.0, (B, n))
    q[:2, 3:] = [[1.9], [-2.1]]         # past the ±1.745 rad limits
    v = rng.uniform(-2.0, 2.0, (B, n))
    c = rng.uniform(-1.2, 1.2, (B, n_links - 1))
    return q, v, c


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def test_model_matches(models):
    tm, jm, _, _ = models
    for name in ("body_mass", "body_com", "body_pos", "body_inertia",
                 "body_fluid_box", "dof_armature", "jnt_range", "act_gear",
                 "qpos0", "viscosity", "fluid_density", "timestep"):
        np.testing.assert_allclose(np.asarray(getattr(tm, name), np.float64),
                                   np.asarray(getattr(jm, name), np.float64),
                                   rtol=0, atol=1e-15, err_msg=name)


def test_fluid_force_matches(models):
    tm, _, jfns, n_links = models
    q, v, _ = _inputs(n_links, 0)
    tq, tv = _t(q, v)
    got = teng.fluid_force(tm, teng.kin_dyn(tm, tq, tv), tv).numpy()
    want = np.asarray(jfns["fluid"](jnp.asarray(q), jnp.asarray(v)))
    assert np.abs(want).max() > 10.0
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)


def test_engine_forward_matches(models):
    tm, _, jfns, n_links = models
    q, v, c = _inputs(n_links, 1)
    got = teng.forward(tm, *_t(q, v, c)).numpy()
    want = np.asarray(jfns["forward"](*map(jnp.asarray, (q, v, c))))
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)


def test_closed_form_matches_the_engine(models):
    tm, _, _, n_links = models
    ks = tsw.spec_from_model(tm)
    for seed in (2, 3):
        q, v, c = _inputs(n_links, seed)
        tq, tv, tc = _t(q, v, c)
        np.testing.assert_allclose(tsw.forward_swimmer(ks, tq, tv, tc).numpy(),
                                   teng.forward(tm, tq, tv, tc).numpy(),
                                   rtol=0, atol=FORWARD_TOL)


def test_closed_form_matches_jax(models):
    tm, _, jfns, n_links = models
    ks = tsw.spec_from_model(tm)
    q, v, c = _inputs(n_links, 4)
    got = tsw.forward_swimmer(ks, *_t(q, v, c)).numpy()
    want = np.asarray(jfns["closed"](*map(jnp.asarray, (q, v, c))))
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)


def test_closed_form_trajectory(models):
    """50 RK4 steps of the closed form track the engine's (the JAX
    package's test_closed_form_trajectory, batched)."""
    tm, _, _, n_links = models
    ks = tsw.spec_from_model(tm)
    rng = np.random.RandomState(3)
    n = 2 + n_links
    q, v = _t(rng.uniform(-0.3, 0.3, (B, n)), rng.uniform(-0.5, 0.5, (B, n)))
    qe, ve = q, v
    for _ in range(50):
        c = torch.as_tensor(rng.uniform(-1, 1, (B, n_links - 1)))
        q, v = tsw.rk4_step_swimmer(ks, q, v, c)
        qe, ve = teng.rk4_step(tm, qe, ve, c)
    np.testing.assert_allclose(q.numpy(), qe.numpy(), rtol=0, atol=TRAJ_TOL)


def test_cholesky_helpers(models):
    """The factor, the solve and diag(M⁻¹) against numpy on the engine's
    mass matrix."""
    tm, _, _, n_links = models
    q, v, _ = _inputs(n_links, 5)
    M = teng.crb_mass_matrix(tm, teng.kin_dyn(tm, *_t(q, v)))
    cols = tsw.chol_factor(M)
    n = M.shape[-1]
    L = np.zeros((B, n, n))
    for j, col in enumerate(cols):
        L[:, j:, j] = col.numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(M.numpy()), atol=1e-12)
    b = np.random.RandomState(6).normal(size=(B, n))
    x = tsw.chol_solve(cols, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(M.numpy(), b[..., None])[..., 0],
                               rtol=1e-12, atol=1e-12)
    Minv = np.linalg.inv(M.numpy())
    for d in range(3, n):
        np.testing.assert_allclose(tsw.minv_diag(cols, d).numpy(), Minv[:, d, d],
                                   rtol=1e-12)


def test_closed_form_refuses_another_geometry():
    model = build_swimmer_model(3)
    model.body_com = model.body_com.copy()
    model.body_com[1, 0] = -0.4
    with pytest.raises(ValueError, match="geometry"):
        tsw.spec_from_model(model)
