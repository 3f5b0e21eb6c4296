"""2-link "reacher", a cut-down swimmer (port of
``mujoco_maze_tpu.models.reacher``).

The reference ReacherEnv (mujoco-maze `reacher.py` + `assets/reacher.xml`):
the swimmer's slide-slide-hinge torso and one articulated tail link, one
gear-150 actuator, the same fluid.  The reference README marks Reacher as
untested (README.md:129-130); the port keeps parity with its code.
"""

from __future__ import annotations

from .swimmer import SwimmerRobot, build_swimmer_model


def build_reacher_model():
    """Content parity: assets/reacher.xml."""
    return build_swimmer_model(n_links=2)


class ReacherRobot(SwimmerRobot):
    NAME = "Reacher"

    N_LINKS = 2
    nq = 4
    nv = 4
    action_dim = 1
    frame_skip = 4      # reacher.py:29
    obs_dim = 8         # full qpos + qvel (reacher.py:49-53)
