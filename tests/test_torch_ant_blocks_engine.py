"""The port's engine in the Ant block worlds vs the JAX package's.

On AntPush-v0 (one block, two slides), AntFall-v0 (the falling block on
its platforms) and AntPushMaze-v0 (three blocks, six slides), float32,
B = 8, at states made with numpy from a seed (``ant_kernel.block_states``:
legs on block faces, blocks at and beyond their travel limits, the Fall
block perched or over the chasm): the forward dynamics with the contacts
(sphere-vs-moving-box rows included), the slide travel limits and the
falling blocks' support, against JAX ``engine.forward`` with the
tests/test_ant_fast.py:158-185 callback, at rel 1e-4, the bound that
test holds the JAX kernel to in these worlds (the near-rigid support
amplifies float32 rounding).  rel = max|port - jax| / (1 + max|jax|).

And ``contact.falling_support_force`` elementwise against the JAX
function on a grid that reaches its four branches (neither row, the
platform row alone, the limit alone, both coupled): equal to the bit
against the JAX function run op by op (jitted, XLA's rewrites round
differently: up to 2e-4 of 3 on this grid).

Every JAX reference is one ``jax.jit`` of a single-env function, compiled
once for the module and called env by env.
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

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_step  # noqa: E402
from mujoco_maze_tpu_torch.ops.ant_kernel import (block_census,  # noqa: E402
                                                  block_states)
from mujoco_maze_tpu_torch.physics import contact as tcontact  # noqa: E402
from mujoco_maze_tpu_torch.physics import engine as teng  # noqa: E402

IDS = ["AntPush-v0", "AntFall-v0", "AntPushMaze-v0"]
B = 8
SEEDS = (0, 1)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (1.0 + np.abs(ref).max()))


@pytest.fixture(scope="module", params=IDS)
def sides(request):
    jspec = jmmt.make_spec(request.param)
    model, cs = jspec.dynamic_model, jspec.contact_set
    _, chain_mask, _, _ = jeng.get_masks(model)

    def extra(kd, qacc0, Minv, v):
        return (jcontact.contact_qfrc(model, cs, kd, v, qacc0, Minv,
                                      chain_mask)
                + jspec.engine_support_qfrc(kd, qacc0, Minv, v))

    def ref(q, v, ctrl):
        return jeng.forward(model, q, v, ctrl, extra_qfrc=extra)

    tenv = tmmt.make_batched(request.param, B, device="cpu")
    ref1 = jax.jit(ref)   # a single-env function compiles in half the time

    def batched(q, v, ctrl):
        return jnp.stack([ref1(q[i], v[i], ctrl[i]) for i in range(len(q))])

    return batched, tenv.spec, make_fast_step(tenv).ks


def _inputs(spec, seed):
    q, v, _ = block_states(spec, B, seed)
    ctrl = np.random.RandomState(100 + seed).uniform(-30, 30, (B, 8))
    return q, v, ctrl.astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_forward_with_blocks_matches(sides, seed):
    ref, spec, ks = sides
    q, v, ctrl = _inputs(spec, seed)
    assert int((block_census(ks, torch.as_tensor(q)) > 0).sum()) >= 1
    jqacc = np.asarray(ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(ctrl)))
    tq, tv, tc = (torch.as_tensor(x) for x in (q, v, ctrl))
    tqacc = teng.forward(spec.dynamic_model, tq, tv, tc,
                         extra_qfrc=spec.world_extra_qfrc()).numpy()
    assert _rel(tqacc, jqacc) < 1e-4
    # the world dofs feel the contacts, the limits and the support
    assert np.abs(jqacc[:, 14:]).max() > 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_block_rows_carry_the_relative_velocity(sides, seed):
    """A sphere-vs-block row's entries on the block's slides are -dir[axis]:
    pushing a block with a sphere moves the block along the push."""
    _, spec, _ = sides
    model, cs = spec.dynamic_model, spec.contact_set
    q, v, ctrl = _inputs(spec, seed)
    kd = teng.kin_dyn(model, torch.as_tensor(q), torch.as_tensor(v))
    _, chain_mask, _, _ = teng.get_masks(model)
    K = tcontact._consts(model, cs, chain_mask, kd.origin)
    n_q = len(cs.qpair_s)
    sign = K.sign_mask[-n_q:].numpy()
    for row, b in zip(sign, cs.qpair_b):
        body = int(cs.dbox_body[b])
        dofs = [int(model.jnt_dofadr[j]) for j in range(model.njnt)
                if int(model.jnt_body[j]) == body]
        assert (row[dofs] == -1.0).all()
        others = np.setdiff1d(np.arange(14, model.nv), dofs)
        assert (row[others] == 0.0).all()


def _branches(z, bottom, s, vz, a0, w, tc):
    """The four cases of the coupled support solve, in float64: 0 neither
    row, 1 the platform row alone, 2 the limit alone, 3 both."""
    k_c, b_c = 0.995 / (0.995 ** 2 * tc ** 2), 2.0 / (0.995 * tc)
    pen_c = s - bottom
    aref_c = -b_c * vz + k_c * pen_c
    R_c = ((1 - 0.995) / 0.995) * 4.0 * w / 16.0
    pen_l = z + 0.01
    x = np.clip(pen_l / 0.001, 0, 1)
    y = np.where(x < 0.5, 2 * x * x, 1 - 2 * (1 - x) ** 2)
    d_l = 0.9 + y * 0.05
    aref_l = 2.0 / (0.95 * tc) * vz + d_l / (0.95 ** 2 * tc ** 2) * pen_l
    R_l = (1 - d_l) / d_l * w
    qa_b = (a0 + w * aref_c / R_c - w * aref_l / R_l) / (1 + w / R_c + w / R_l)
    qa_c = (a0 + w * aref_c / R_c) / (1 + w / R_c)
    qa_l = (a0 - w * aref_l / R_l) / (1 + w / R_l)
    use_c = (pen_c > 0) & ((aref_c - qa_c) / R_c > 0)
    use_l = (pen_l > 0) & ((aref_l + qa_l) / R_l > 0)
    both = (use_c & use_l & ((aref_c - qa_b) / R_c > 0)
            & ((aref_l + qa_b) / R_l > 0))
    return np.where(both, 3, np.where(use_c, 1, np.where(use_l, 2, 0)))


def test_falling_support_force_matches_on_all_branches():
    rng = np.random.RandomState(0)
    n = 4096
    z = rng.uniform(-0.3, 4.2, n)
    bottom = z + rng.uniform(-0.5, 0.5, n)        # base z - half z around 0
    s = np.where(rng.uniform(size=n) < 0.5, 0.0, 4.0)
    vz = rng.normal(0, 1.0, n)
    a0 = rng.normal(-9.81, 5.0, n)
    w = np.full(n, 1000.0)
    args = [a.astype(np.float32) for a in (z, bottom, s, vz, a0, w)]
    tc = 0.04
    cases = _branches(*(a.astype(np.float64) for a in args), tc)
    assert set(np.unique(cases)) == {0, 1, 2, 3}
    # op by op (not jitted: XLA's rewrites round otherwise), the same
    # float32 operations in the same order: equal to the bit
    jf = np.asarray(jcontact.falling_support_force(
        *(jnp.asarray(a) for a in args), tc))
    tf = tcontact.falling_support_force(*(torch.as_tensor(a) for a in args),
                                        tc).numpy()
    assert tf.dtype == np.float32
    np.testing.assert_array_equal(tf, jf)
    for case in range(4):
        sel = cases == case
        if case == 0:
            assert (tf[sel] == 0).all()
        elif case == 1:
            assert (tf[sel] >= 0).all()
        elif case == 2:
            assert (tf[sel] <= 0).all()
