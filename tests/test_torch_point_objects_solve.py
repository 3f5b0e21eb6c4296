"""The port's reduced object solve vs the JAX package's monolith.

``ops/object_lanes.object_step_lanes`` (PyTorch, float32, batched) against
``physics/point_world.rk4_object_step(..., floor_always=True)``, the
JAX package's own oracle of its lane form, run eagerly one env at a time
as ``tests/test_object_lanes.py`` runs it: float32 within q 2e-5 and v 2e-3
(the bounds that file holds the JAX lane form to), and the float64
monolith within q 5e-4.  The inputs are ``point_kernel.object_states``:
the robot within reach of a ball or a block and moving at it, blocks at
and inside their travel limits, the Fall block perched, at the floor and
in between, on PointPush-v0, PointBilliard-v0, PointFall-v0,
PointMultiFall-v2 and PointMultiPushSmall-v0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu as jmmt  # noqa: E402
from mujoco_maze_tpu.physics import point_world  # noqa: E402

import mujoco_maze_tpu_torch as tmmt  # noqa: E402
from mujoco_maze_tpu_torch.ops import object_lanes, point_kernel  # noqa: E402

CASES = ["PointPush-v0", "PointBilliard-v0", "PointFall-v0",
         "PointMultiFall-v2", "PointMultiPushSmall-v0"]
N = 6          # envs compared in float32
N64 = 2        # of which compared with the float64 monolith too


def _f64_world(env_id):
    """The reduced world of ``env_id`` in float64 (test_object_lanes.py)."""
    spec64 = jmmt.make_spec(env_id, dtype=jnp.float64)
    if spec64.object_world is not None:
        return spec64.object_world
    ms = spec64.structure
    balls = (point_world.ball_world_from_structure(ms, dtype=jnp.float64)
             if ms.object_balls and spec64.robot.OBJBALL_TYPE == "hinge"
             else None)
    blocks = point_world.block_world_from_structure(ms, dtype=jnp.float64,
                                                    allow_z=True)
    params = point_world.params_for_world(
        any_blocks=bool(ms.movable_blocks), dt=spec64.robot.timestep,
        torso_z=(0.75 + ms.height_offset) if ms.elevated else 0.0)
    return (params, point_world.wall_boxes_from_structure(ms, dtype=jnp.float64),
            balls, blocks)


@pytest.mark.parametrize("env_id", CASES)
def test_object_step_matches_the_monolith(env_id):
    tspec = tmmt.make_spec(env_id, device="cpu")
    ks = tspec.object_spec
    idx = list(tspec._object_dof_idx())
    qpos, qvel, _ = point_kernel.object_states(tspec, N, seed=11)
    rq, rv = qpos[:, :3], qvel[:, :3]
    oq, ov = qpos[:, idx], qvel[:, idx]

    def lanes(a):
        return tuple(torch.tensor(a[:, k]) for k in range(a.shape[1]))

    active = []
    tq, tv = object_lanes.object_step_lanes(ks, lanes(rq), lanes(rv),
                                            lanes(oq), lanes(ov), active)
    tq = torch.stack(tq, dim=1).numpy()
    tv = torch.stack(tv, dim=1).numpy()
    # most envs touch an object: active rows beyond the balls' floor rows
    # (always active) at the first forward evaluation
    touching = int((active[0].sum(dim=0) > 4 * len(ks.balls)).sum())
    assert touching >= N // 2, f"{env_id}: only {touching} envs touch"

    owp, owb, oballs, oblocks = jmmt.make_spec(env_id).object_world
    step32 = functools.partial(point_world.rk4_object_step, owp, owb, oballs,
                               oblocks, floor_always=True)
    for e in range(N):
        jq, jv = step32(*(jnp.asarray(a[e], jnp.float32)
                          for a in (rq, rv, oq, ov)))
        qe = float(np.abs(tq[e] - np.asarray(jq)).max())
        ve = float(np.abs(tv[e] - np.asarray(jv)).max())
        assert qe < 2e-5, f"{env_id} env {e}: q err {qe:.2e}"
        assert ve < 2e-3, f"{env_id} env {e}: v err {ve:.2e}"

    with jax.enable_x64(True):
        owp, owb, oballs, oblocks = _f64_world(env_id)
        for e in range(N64):
            jq, _ = point_world.rk4_object_step(
                owp, owb, oballs, oblocks,
                *(jnp.asarray(a[e], jnp.float64) for a in (rq, rv, oq, ov)),
                floor_always=True)
            qe = float(np.abs(tq[e] - np.asarray(jq)).max())
            assert qe < 5e-4, f"{env_id} env {e}: q err vs float64 {qe:.2e}"
