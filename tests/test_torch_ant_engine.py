"""The port's rigid-body engine vs the JAX package's, on the Ant world.

At random ant states made with numpy from a seed in the start cell of
AntUMaze-v0 (feet on the floor, half the envs within reach of the cell's
walls; ``ant_kernel.contact_states``), float32, B = 8: forward kinematics
at atol 1e-5, the CRB mass matrix and the RNE bias at rel 1e-5, the
contact force and the forward dynamics (qacc, limits and contacts
included) at rel 5e-5, the bounds tests/test_ant_fast.py holds the JAX ant
pipeline to against this engine.  rel = max|port - jax| / (1 + max|jax|).

The JAX engine takes spatial quantities about the world origin, the
port's about the ant's torso (``physics/engine.py``), so the JAX side's
float32 rounding grows with the square of the ant's distance r from the
origin: in far cells the two agree to within 2e-7 (1 + r^2) for M and
bias and 2e-6 (1 + r^2) for the contact force and qacc (measured at
r = 24: 8.6e-5 and 3.5e-4, i.e. 1.5e-7 and 5.9e-7 times 1 + r^2; in the
start cell, r < 4.4: 1.8e-6 and 2.2e-5).
``test_far_cells_round_with_the_distance`` holds that scaling.

Every JAX reference comes from one ``jax.jit(jax.vmap(...))`` of the JAX
engine, compiled once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.physics import contact as jcontact  # noqa: E402
from mujoco_maze_tpu.physics import engine as jeng  # noqa: E402
from mujoco_maze_tpu.physics.linalg import spd_inverse as jspd_inverse  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_step  # noqa: E402
from mujoco_maze_tpu_torch.ops.ant_kernel import (contact_census,  # noqa: E402
                                                  contact_states)
from mujoco_maze_tpu_torch.physics import contact as tcontact  # noqa: E402
from mujoco_maze_tpu_torch.physics import engine as teng  # noqa: E402
from mujoco_maze_tpu_torch.physics import linalg as tlinalg  # noqa: E402

ENV_ID = "AntUMaze-v0"
B = 8
SEEDS = (0, 1, 2)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (1.0 + np.abs(ref).max()))


@pytest.fixture(scope="module")
def sides():
    jspec = jmmt.make_spec(ENV_ID)
    model, cs = jspec.dynamic_model, jspec.contact_set
    _, chain_mask, _, _ = jeng.get_masks(model)

    def ref(q, v, ctrl):
        kd = jeng.kin_dyn(model, q, v)
        M = jeng.crb_mass_matrix(model, kd)
        bias = jeng.rne_bias(model, kd, v)
        Minv = jspd_inverse(M)
        tau = (jeng.actuator_force(model, ctrl)
               - jnp.asarray(model.dof_damping, q.dtype) * v)
        qacc0 = Minv @ (tau - bias)
        qc = jcontact.contact_qfrc(model, cs, kd, v, qacc0, Minv, chain_mask)

        def extra(kd_, qacc0_, Minv_, v_):
            return jcontact.contact_qfrc(model, cs, kd_, v_, qacc0_, Minv_,
                                         chain_mask)

        qacc = jeng.forward(model, q, v, ctrl, extra_qfrc=extra)
        return (jnp.stack(kd.fkr.body_pos), jnp.stack(kd.fkr.body_com),
                jnp.stack(kd.fkr.body_rot), M, bias, qc, qacc)

    tenv = tmmt.make_batched(ENV_ID, B, device="cpu")
    return jax.jit(jax.vmap(ref)), tenv.spec, make_fast_step(tenv).ks


def _inputs(spec, seed, start_cell_only=True):
    q, v, _ = contact_states(spec, B, seed, start_cell_only)
    ctrl = np.random.RandomState(100 + seed).uniform(-30, 30, (B, 8))
    return q, v, ctrl.astype(np.float32)


def _port(spec, q, v, ctrl):
    model, cs = spec.dynamic_model, spec.contact_set
    _, chain_mask, _, _ = teng.get_masks(model)
    q, v, ctrl = (torch.as_tensor(x) for x in (q, v, ctrl))
    kd = teng.kin_dyn(model, q, v)
    M = teng.crb_mass_matrix(model, kd)
    bias = teng.rne_bias(model, kd, v)
    Minv = tlinalg.spd_inverse(M)
    tau = (teng.actuator_force(model, ctrl)
           - torch.as_tensor(model.dof_damping, dtype=torch.float32) * v)
    qacc0 = teng.mat_vec(Minv, tau - bias)
    qc = tcontact.contact_qfrc(model, cs, kd, v, qacc0, Minv, chain_mask)

    def extra(kd_, qacc0_, Minv_, v_):
        return tcontact.contact_qfrc(model, cs, kd_, v_, qacc0_, Minv_,
                                     chain_mask)

    qacc = teng.forward(model, q, v, ctrl, extra_qfrc=extra)
    return (torch.stack(kd.fkr.body_pos, 1), torch.stack(kd.fkr.body_com, 1),
            torch.stack(kd.fkr.body_rot, 1), M, bias, qc, qacc)


@pytest.mark.parametrize("seed", SEEDS)
def test_states_touch_floor_and_walls(sides, seed):
    _, spec, ks = sides
    q, _, _ = _inputs(spec, seed)
    floor, walls = contact_census(ks, torch.as_tensor(q))
    assert (floor > 0).sum() >= B // 2
    assert (walls > 0).sum() >= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_fk_matches(sides, seed):
    ref, spec, _ = sides
    q, v, ctrl = _inputs(spec, seed)
    jout = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))
    tout = _port(spec, q, v, ctrl)
    for k in range(3):  # body positions, coms, rotations
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_mass_matrix_and_bias_match(sides, seed):
    ref, spec, _ = sides
    q, v, ctrl = _inputs(spec, seed)
    jout = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))
    tout = _port(spec, q, v, ctrl)
    assert _rel(tout[3].numpy(), jout[3]) < 1e-5, "crb_mass_matrix"
    assert _rel(tout[4].numpy(), jout[4]) < 1e-5, "rne_bias"


@pytest.mark.parametrize("seed", SEEDS)
def test_contact_force_and_forward_match(sides, seed):
    ref, spec, _ = sides
    q, v, ctrl = _inputs(spec, seed)
    jout = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))
    tout = _port(spec, q, v, ctrl)
    jqc, jqacc = np.asarray(jout[5]), np.asarray(jout[6])
    assert np.abs(jqc).max() > 1.0  # contacts carry force in these states
    assert _rel(tout[5].numpy(), jqc) < 5e-5, "contact_qfrc"
    assert _rel(tout[6].numpy(), jqacc) < 5e-5, "forward"


@pytest.mark.parametrize("seed", SEEDS)
def test_far_cells_round_with_the_distance(sides, seed):
    ref, spec, _ = sides
    q, v, ctrl = _inputs(spec, seed, start_cell_only=False)
    r2 = float((q[:, :2] ** 2).sum(axis=1).max())
    assert r2 > 100.0  # some ant more than 10 from the origin
    jout = ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))
    tout = _port(spec, q, v, ctrl)
    assert _rel(tout[3].numpy(), jout[3]) < 2e-7 * (1 + r2), "crb_mass_matrix"
    assert _rel(tout[4].numpy(), jout[4]) < 2e-7 * (1 + r2), "rne_bias"
    assert _rel(tout[5].numpy(), jout[5]) < 2e-6 * (1 + r2), "contact_qfrc"
    assert _rel(tout[6].numpy(), jout[6]) < 2e-6 * (1 + r2), "forward"


def test_spd_inverse_matches_on_a_mass_matrix(sides):
    ref, spec, _ = sides
    q, v, ctrl = _inputs(spec, 0)
    M = np.asarray(ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl))[3])
    jinv = np.asarray(jax.vmap(jspd_inverse)(jnp.asarray(M)))
    tinv = tlinalg.spd_inverse(torch.tensor(M)).numpy()
    assert _rel(tinv, jinv) < 1e-5
    np.testing.assert_allclose(tinv @ M, np.broadcast_to(np.eye(14), M.shape),
                               atol=1e-4)


def test_integrate_pos_matches_and_keeps_unit_quaternions(sides):
    _, spec, _ = sides
    q, v, _ = _inputs(spec, 1)
    v = v * 5.0
    model = spec.dynamic_model
    jq = np.asarray(jax.vmap(lambda a, b: jeng.integrate_pos(model, a, b, 0.01))(
        jnp.asarray(q), jnp.asarray(v)))
    tq = teng.integrate_pos(model, torch.as_tensor(q), torch.as_tensor(v), 0.01)
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tq[:, 3:7].numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_fluid_drag_waits_for_the_swimmer(sides):
    """The Ant has no fluid drag; set on its 13-body model (the Swimmer's
    viscosity and density), the ported drag is the JAX engine's."""
    _, spec, _ = sides
    model = spec.dynamic_model
    jmodel = jmmt.make_spec(ENV_ID).dynamic_model
    q, v, _ = _inputs(spec, 0)
    kd = teng.kin_dyn(model, torch.as_tensor(q), torch.as_tensor(v))
    assert float(teng.fluid_force(model, kd, torch.as_tensor(v)).abs().max()) == 0
    for m in (model, jmodel):
        m.viscosity, m.fluid_density = 0.1, 4000.0
    try:
        got = teng.fluid_force(model, kd, torch.as_tensor(v)).numpy()
        want = jax.vmap(lambda a, b: jeng.fluid_force(
            jmodel, jeng.kin_dyn(jmodel, a, b), b))(jnp.asarray(q), jnp.asarray(v))
    finally:
        for m in (model, jmodel):
            m.viscosity, m.fluid_density = 0.0, 0.0
    assert np.abs(got).max() > 1e-3
    assert _rel(got, want) < 5e-5
