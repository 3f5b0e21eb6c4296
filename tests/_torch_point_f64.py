"""Shared by ``test_torch_point_f64_ref_a.py`` / ``_b.py``: the port's
float64 Point step against the JAX package's float64 ``spec.step``.

Each file compiles one JAX float64 step (about a minute on the CPU), so
the two worlds sit in two files that ``--dist loadfile`` spreads over
workers.  The states are seeded: the robot anywhere in the free cells with
any heading, moving, half of them with the forward gain 0, and, in the
block world, ``point_kernel.quasi_states``' contact states (the robot on
the block's faces and inside it).  Per env-step the qpos error is the max
over its coordinates; the bounds are the issue's: the median below 1e-9
(most steps bit-equal, as the port and JAX both replicate mj_step), and
within 1e-12 on the contact-free env-steps (:func:`contact_free`).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mujoco_maze_tpu as jmmt

from mujoco_maze_tpu_torch import registry
from mujoco_maze_tpu_torch.envs.env import EnvState
from mujoco_maze_tpu_torch.maze.cells import MazeCell

B = 96
STEPS = 3
# what the robot can touch in a step: its arrow tip 1.1 from the centre,
# plus the move at speed <= 3 (0.06) and a margin; plus the kinematic
# write's forward gain
REACH = 1.3


def free_cell_states(spec, n, seed, no_spin_every=3):
    """``(qpos, qvel, actions)`` float64: the robot uniform in the free
    cells, any heading, speeds up to 3, no spin in every
    ``no_spin_every``-th env; world dofs at qpos0, at rest."""
    rng = np.random.RandomState(seed)
    ms = spec.structure
    s = ms.size_scaling
    cells = [(i, j) for i in range(ms.grid.shape[0])
             for j in range(ms.grid.shape[1])
             if not MazeCell(ms.grid[i, j]).is_block()]
    pick = rng.randint(len(cells), size=n)
    qpos = np.zeros((n, spec.nq))
    qvel = np.zeros((n, spec.nv))
    for e, k in enumerate(pick):
        i, j = cells[k]
        qpos[e, 0] = j * s - ms.torso_x + rng.uniform(-0.5, 0.5) * s
        qpos[e, 1] = i * s - ms.torso_y + rng.uniform(-0.5, 0.5) * s
    qpos[:, 2] = rng.uniform(-np.pi, np.pi, n)
    qvel[:, :3] = rng.uniform(-3.0, 3.0, (n, 3))
    qvel[::no_spin_every, 2] = 0.0   # no spin: no centrifugal bias
    act = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.25, 0.25, n)], 1)
    act[::2, 0] = 0.0
    return qpos, qvel, act


def wall_distance(spec, xy):
    """Distance from each robot centre to the nearest static box."""
    ms = spec.structure
    c = np.concatenate([np.asarray(ms.block_pos).reshape(-1, 3),
                        np.asarray(ms.platform_pos).reshape(-1, 3)])[:, :2]
    h = np.concatenate([np.asarray(ms.block_size).reshape(-1, 3),
                        np.asarray(ms.platform_size).reshape(-1, 3)])[:, :2]
    d = np.maximum(np.abs(xy[:, None, :] - c[None]) - h[None], 0.0)
    return np.sqrt((d * d).sum(-1)).min(1)


def contact_free(spec, qpos, qvel, act):
    """Env-steps without a contact row in either implementation: no wall
    within reach, no spin (so every RK4 stage keeps the heading of the
    kinematic write), and the floor switch off at that heading however
    ``c*c + s*s`` is rounded.  MuJoCo and the port round the two products
    and their sum each once; XLA's jit fuses one product into the sum (a
    fused multiply-add on this CPU: JAX's eager step and its jitted one
    differ there), and the switch, MuJoCo's knife edge on the last bit of
    that sum, can flip.  With spin, the stages' headings carry the last
    bits of the solve as well.  Such env-steps are held to the median."""
    from mujoco_maze_tpu_torch.physics import exact_trig
    from mujoco_maze_tpu_torch.physics import point_world as pw

    qk, _ = spec.robot.kinematic_step(torch.tensor(qpos), torch.tensor(qvel),
                                      torch.tensor(act))
    s, c = exact_trig.sincos(0.5 * qk[:, 2])
    off = ~pw._floor_switch(c, s)[0]
    for m22 in (exact_trig._fma(c, c, s * s), exact_trig._fma(s, s, c * c)):
        off &= ~(0.5 * m22 - 0.5 < 0.0)
    reach = REACH + np.abs(act[:, 0])
    return ((wall_distance(spec, qpos[:, :2]) > reach) & (qvel[:, 2] == 0.0)
            & off.numpy())


@contextlib.contextmanager
def solve_flips():
    """Within one port step: each Newton solve runs twice, with
    ``torch.linalg.solve`` (whose result the step keeps) and with XLA's
    ``jnp.linalg.solve`` in its place.  Yields a dict that receives, per
    env of the step, ``diff`` (some XLA solve's bits differ from
    PyTorch's on the same system), ``flip`` (some line-search branch
    differs between the two runs) and ``moved`` (the two runs' results
    differ by more than rounding, 1e-9 relative: a branch that moved the
    answer; once Newton has converged, its direction is rounding noise and
    the branches on it move nothing), each only where a contact row is
    active (elsewhere the step discards the solve)."""
    from mujoco_maze_tpu_torch.physics import point_world as pw

    orig = pw._solve_newton
    xla = jax.jit(jax.vmap(jnp.linalg.solve))   # as under spec.step's vmap
    rec = {}

    def twin(p, M, a0, J, aref, rinv):
        live = (rinv > 0.0).any(-1).numpy()
        diff = np.zeros(len(live), bool)

        def xla_solve(H, g):
            nonlocal diff
            ours = torch.linalg.solve(H, g)
            theirs = torch.from_numpy(np.array(xla(H.numpy(), g.numpy())))
            diff |= (ours != theirs).any(-1).numpy()
            return theirs

        mine, theirs = [], []
        x = orig(p, M, a0, J, aref, rinv, branches=mine)
        x_xla = orig(p, M, a0, J, aref, rinv, solve=xla_solve,
                     branches=theirs)
        flip = np.any([(a != b).numpy() for a, b in zip(mine, theirs)], 0)
        moved = ((x - x_xla).abs() > 1e-9 * (1.0 + x.abs())).any(-1).numpy()
        for name, hit in (("diff", diff), ("flip", flip), ("moved", moved)):
            rec[name] = rec.get(name, np.zeros(len(live), bool)) | (hit & live)
        return x

    pw._solve_newton = twin
    try:
        with jax.enable_x64(True):
            yield rec
    finally:
        pw._solve_newton = orig


def compare(env_id, qpos, qvel, act, extra_far=None):
    """STEPS teacher-forced steps of both float64 steps from the seeded
    states; returns the per-env-step qpos errors, which env-steps were
    contact-free (:func:`contact_free`, and ``extra_far``), and the counts
    of :func:`solve_flips` over them."""
    tspec = registry.make_spec(env_id, dtype=torch.float64, device="cpu")
    errs, far, flips = [], [], {"diff": 0, "flip": 0, "moved": 0}
    with jax.enable_x64(True):
        jspec = jmmt.make_spec(env_id, dtype=jnp.float64)
        s0, _ = jspec.reset(jax.random.PRNGKey(0))
        step = jax.jit(jax.vmap(jspec.step))
        n = len(qpos)
        rng = np.random.RandomState(1)
        for _ in range(STEPS):
            js = s0._replace(
                qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                t=jnp.zeros(n, jnp.int32),
                key=jnp.broadcast_to(s0.key, (n,) + s0.key.shape))
            jres = step(js, jnp.asarray(act))
            with solve_flips() as rec:
                tres = tspec.step(EnvState(qpos=torch.tensor(qpos),
                                           qvel=torch.tensor(qvel),
                                           t=torch.zeros(n, dtype=torch.int32)),
                                  torch.tensor(act))
            for name in flips:
                flips[name] += int(rec.get(name, np.zeros(0, bool)).sum())
            assert tres.state.qpos.dtype == torch.float64
            jq = np.asarray(jres.state.qpos)
            errs.append(np.abs(tres.state.qpos.numpy() - jq).max(1))
            ok = contact_free(tspec, qpos, qvel, act)
            if extra_far is not None:
                ok &= extra_far(qpos, REACH + np.abs(act[:, 0]))
            far.append(ok)
            qpos, qvel = jq, np.asarray(jres.state.qvel)
            act = np.stack([rng.uniform(-1, 1, n),
                            rng.uniform(-0.25, 0.25, n)], 1)
            act[::2, 0] = 0.0
    return np.concatenate(errs), np.concatenate(far), flips
