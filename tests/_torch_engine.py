"""Shared set-up of the generic engine kernel's tests: the custom robots on
both sides (the JAX package's ``examples/custom_robot.py`` and the port's
``mujoco_maze_tpu_torch.examples.custom_robot``), composed with the stock
tasks, the ball-jointed test robot with fluid drag, and the twin roller.

No robot of either package has a BALL joint or runs the engine world with
fluid drag, so the tests define one twice over, once per package: the
Roller with a ball-jointed capsule arm hanging off its centre, in a model
whose viscosity and fluid density are set after the env composes it.  Nor
has any a sphere-sphere pair between two of its own bodies: the twin
roller, defined the same way, is two rollers on slides of their own.

The Roller's free-ball world is the SmallBilliard task at the task's own
scaling for engine-world robots (``MAZE_SIZE_SCALING.ant``, 2.0), as a
user composes it through the extension API.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import custom_robot as jax_custom  # noqa: E402  (the JAX package's example)
from mujoco_maze_tpu.envs.env import MazeEnvSpec as JaxSpec  # noqa: E402
from mujoco_maze_tpu.physics import model as jax_model  # noqa: E402
from mujoco_maze_tpu.tasks import library as jax_library  # noqa: E402

from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec as TorchSpec  # noqa: E402
from mujoco_maze_tpu_torch.examples import custom_robot as torch_custom  # noqa: E402
from mujoco_maze_tpu_torch.physics import model as torch_model  # noqa: E402
from mujoco_maze_tpu_torch.tasks import library as torch_library  # noqa: E402

# the arm's fluid: a viscous, light medium (drag on the roller and the arm
# of the order of their weight at 1 m/s)
VISCOSITY, FLUID_DENSITY = 0.1, 10.0
SCALE = 4.0   # maze_size_scaling of the Roller worlds, as the example's
BALL_TASK = "GoalRewardSmallBilliard"
BALL_SCALE = 2.0   # the SmallBilliard task's scaling for engine-world robots


def _arm_bodies(model_mod, bodies):
    """The arm: a capsule hanging from a damped ball joint at the roller's
    centre, colliding with the world."""
    bodies.append(model_mod.Body(
        name="arm", parent=0, pos=(0.0, 0.0, 0.0),
        joints=[model_mod.Joint(model_mod.BALL, damping=0.5, armature=0.01,
                                name="arm_ball")],
        geoms=[model_mod.Geom.capsule_fromto(
            (0, 0, 0), (0.3, 0.0, -0.35), 0.06, density=300.0, contype=1,
            conaffinity=1, friction=(1.0, 0.5, 0.5), solref=(0.02, 1.0),
            solimp=(0.8, 0.8, 0.01), margin=0.01)]))
    return bodies


class JaxArmRoller(jax_custom.RollerRobot):
    NAME = "ArmRoller"
    nq = 7
    nv = 6

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        return _arm_bodies(jax_model, bodies), actuators


class TorchArmRoller(torch_custom.RollerRobot):
    NAME = "ArmRoller"
    nq = 7
    nv = 6

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        return _arm_bodies(torch_model, bodies), actuators


def _twin_body(model_mod, torso_z, defaults):
    """A second roller 1 m along x from the first, on slides of its own."""
    return model_mod.Body(
        name="twin", parent=-1, pos=(1.0, 0.0, torso_z),
        joints=[model_mod.Joint(model_mod.SLIDE, axis=ax, name=f"twin_{n}")
                for n, ax in (("x", (1, 0, 0)), ("y", (0, 1, 0)),
                              ("z", (0, 0, 1)))],
        geoms=[model_mod.Geom(gtype=0, size=(0.4,), **defaults)])


class JaxTwinRoller(jax_custom.RollerRobot):
    NAME = "TwinRoller"
    nq = nv = 6

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        return bodies + [_twin_body(jax_model, torso_z,
                                    self.WORLD_GEOM_DEFAULTS)], actuators


class TorchTwinRoller(torch_custom.RollerRobot):
    NAME = "TwinRoller"
    nq = nv = 6

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        return bodies + [_twin_body(torch_model, torso_z,
                                    self.WORLD_GEOM_DEFAULTS)], actuators


# the studded roller of chip_smoke.py studded_roller_spec: STUDS test
# spheres inside the roller's own, here at the placement whose phase-22
# check once failed (studs of 0.1 m at 0.25 m), in the SmallBilliard task
STUDS, STUD_R, STUD_RING = 60, 0.1, 0.25


def _studs(model_mod, bodies, defaults):
    bodies[0].geoms.extend(
        model_mod.Geom(gtype=0, size=(STUD_R,),
                       pos=(STUD_RING * np.cos(2 * np.pi * k / STUDS),
                            STUD_RING * np.sin(2 * np.pi * k / STUDS), 0.0),
                       contype=1, conaffinity=1, **defaults)
        for k in range(STUDS))
    return bodies


class JaxStuddedRoller(jax_custom.RollerRobot):
    NAME = "StuddedRoller"

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        return _studs(jax_model, bodies, self.WORLD_GEOM_DEFAULTS), actuators


class TorchStuddedRoller(torch_custom.RollerRobot):
    NAME = "StuddedRoller"

    def build_bodies(self, torso_z: float = 0.75):
        bodies, actuators = super().build_bodies(torso_z)
        return _studs(torch_model, bodies, self.WORLD_GEOM_DEFAULTS), actuators


def specs(world: str):
    """``(jax_spec, torch_spec)`` of a Roller world: ``world`` names a
    stock task class (``"GoalRewardPush"``; the SmallBilliard task at
    BALL_SCALE, the others at SCALE), ``"Arm"`` for the ball-jointed robot
    with fluid drag in the UMaze, ``"Twin"`` for the twin roller in the
    UMaze, or ``"Studded"`` for the studded roller in the SmallBilliard
    task."""
    task = {"Arm": "GoalRewardUMaze", "Twin": "GoalRewardUMaze",
            "Studded": BALL_TASK}.get(world, world)
    robots = {"Arm": (JaxArmRoller, TorchArmRoller),
              "Twin": (JaxTwinRoller, TorchTwinRoller),
              "Studded": (JaxStuddedRoller, TorchStuddedRoller)}.get(
        world, (jax_custom.RollerRobot, torch_custom.RollerRobot))
    scale = BALL_SCALE if task == BALL_TASK else SCALE
    jtask, ttask = getattr(jax_library, task), getattr(torch_library, task)
    js = JaxSpec(robot=robots[0](), maze_task=jtask, maze_size_scaling=scale,
                 inner_reward_scaling=jtask.INNER_REWARD_SCALING)
    ts = TorchSpec(robot=robots[1](), maze_task=ttask, maze_size_scaling=scale,
                   inner_reward_scaling=ttask.INNER_REWARD_SCALING,
                   device="cpu")
    if world == "Arm":
        for s in (js, ts):
            s.dynamic_model.viscosity = VISCOSITY
            s.dynamic_model.fluid_density = FLUID_DENSITY
    return js, ts


def jax_state(qpos, qvel, t):
    """A batched JAX ``EnvState`` from numpy arrays (fixed keys)."""
    import jax
    import jax.numpy as jnp
    from mujoco_maze_tpu.envs.env import EnvState

    B = qpos.shape[0]
    return EnvState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                    t=jnp.asarray(t), key=jax.random.split(
                        jax.random.PRNGKey(0), B), goal_pos=None)


def actions(rng: np.random.RandomState, spec, B: int) -> np.ndarray:
    lo, hi = spec.robot.action_bounds()
    return rng.uniform(lo, hi, (B, len(hi))).astype(np.float32)
