"""The port's Point step in the object worlds vs the JAX package's XLA
step, teacher-forced: PointPush-v0 (one block), PointBilliard-v0 (a hinge ball,
the heads on it) and PointBlockCarry-v0 (the heads on the block).

The comparison and its bounds are in ``tests/_torch_point_objects.py``;
``test_torch_point_objects_step_b.py`` has the other IDs of
tests/test_pallas.py's object-world list.
"""

import jax
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import _torch_point_objects as common  # noqa: E402

IDS = ["PointPush-v0", "PointBilliard-v0", "PointBlockCarry-v0"]


@pytest.fixture(scope="module", params=IDS)
def envs(request):
    return common.make_envs(request.param)


def test_step_from_reset(envs):
    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    common.teacher_forced(jenv, tenv, jstate, seed=0)


def test_step_from_contact_states(envs):
    jenv, tenv = envs
    moved = common.teacher_forced(jenv, tenv,
                                  common.contact_state(jenv, tenv, seed=1),
                                  seed=1, obj_vel_atol=common.OBJ_VEL_ATOL)
    # the robot moved the objects
    assert moved > 0.05
