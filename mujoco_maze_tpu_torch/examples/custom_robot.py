"""Custom robot through the extension API, stepped by the generic CUDA kernel.

Counterpart of ``examples/custom_robot.py`` (the JAX package's), in
PyTorch.  Subclass :class:`~mujoco_maze_tpu_torch.models.base.Robot`,
describe the body tree programmatically (``build_bodies``) and compose it
with any maze task through :class:`~mujoco_maze_tpu_torch.envs.env.MazeEnvSpec`.
Because the robot runs on the port's engine, it gets:

* the composed contact world (maze walls, movable blocks, the Fall
  worlds' platforms and falling support),
* the plain batch-first engine (``physics/engine.py``) on the CPU, and
* the generic CUDA step kernel (``csrc/engine_lane.cu``, through
  ``ops.make_fast_step``) on the card, with the observation and the
  auto-reset folded around it in PyTorch.

The demo robot is a "Roller": a force-actuated sphere on x/y/z slides that
falls onto the floor and rolls around the UMaze under contact dynamics.

Run:  python -m mujoco_maze_tpu_torch.examples.custom_robot
      (add ``--cpu`` to run the plain PyTorch path without a card)
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from .._device import DeviceLike
from ..envs.batched import BatchedMazeEnv
from ..envs.env import MazeEnvSpec
from ..models.base import Robot, uniform_from
from ..physics.model import SLIDE, Actuator, Body, Geom, Joint
from ..tasks.library import GoalRewardUMaze


class RollerRobot(Robot):
    """Force-actuated sphere on x/y/z slides (full contact dynamics)."""

    NAME = "Roller"
    MANUAL_COLLISION = False
    ORI_IND = None
    RADIUS = None
    OBJBALL_TYPE = "freejoint"
    USES_WORLD_ENGINE = True

    nq = 3
    nv = 3
    action_dim = 2
    frame_skip = 5
    timestep = 0.02
    obs_dim = 6

    FORWARD_REWARD_WEIGHT = 1.0
    CTRL_COST_WEIGHT = 1e-4
    WORLD_GEOM_DEFAULTS = dict(
        density=5.0,
        friction=(1.0, 0.5, 0.5),
        solref=(0.02, 1.0),
        solimp=(0.8, 0.8, 0.01),
        margin=0.01,
    )
    # reset noise law: qpos ~ U(-0.1, 0.1), qvel ~ 0.1 N(0, 1)
    QPOS_NOISE = (-0.1, 0.1)
    QVEL_STD = 0.1
    ZERO_WORLD_DOFS_ON_RESET = True

    def build_bodies(self, torso_z: float = 0.75):
        body = Body(
            name="roller",
            parent=-1,
            pos=(0.0, 0.0, torso_z),
            joints=[
                Joint(SLIDE, axis=(1, 0, 0), name="roller_x"),
                Joint(SLIDE, axis=(0, 1, 0), name="roller_y"),
                Joint(SLIDE, axis=(0, 0, 1), name="roller_z"),
            ],
            geoms=[Geom(gtype=0, size=(0.4,), contype=1, conaffinity=1,
                        **self.WORLD_GEOM_DEFAULTS)],
        )
        actuators = [
            Actuator("roller_x", gear=100.0, ctrlrange=(-1, 1)),
            Actuator("roller_y", gear=100.0, ctrlrange=(-1, 1)),
        ]
        return [body], actuators

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        high = np.ones(2)
        return -high, high

    def init_qpos(self, height_offset: float) -> np.ndarray:
        return np.zeros(3)

    def obs_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        high = np.full(self.obs_dim, np.inf)
        return -high, high

    def reset_noise(self, generator, num_envs, nq_total, nv_total):
        dev = generator.device
        uq = torch.rand((num_envs, nq_total), generator=generator, device=dev)
        nv = torch.randn((num_envs, nv_total), generator=generator, device=dev)
        return uniform_from(uq, *self.QPOS_NOISE), nv * self.QVEL_STD

    def dynamics_step(self, spec, qpos: torch.Tensor, qvel: torch.Tensor,
                      action: torch.Tensor):
        """frame_skip RK4 steps with contacts and the falling blocks'
        support: the engine drives any composed world."""
        return spec.world_step(qpos, qvel, action)

    def inner_reward_terms(self, xy_before: torch.Tensor,
                           xy_after: torch.Tensor, action: torch.Tensor):
        vel = (xy_after - xy_before) / self.dt
        forward = torch.sqrt(torch.sum(vel * vel, dim=1))
        return forward, self.CTRL_COST_WEIGHT * torch.sum(action * action, dim=1)

    def observe(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[:, :3], qvel[:, :3]], dim=1)

    def get_ori(self, qpos: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(qpos[:, 0])


def make_roller_umaze(num_envs: int = 64, device: DeviceLike = None,
                      **kwargs) -> BatchedMazeEnv:
    """Compose the custom robot with the stock UMaze task (``device=None``
    means CUDA; ``kwargs`` go to :class:`BatchedMazeEnv`)."""
    spec = MazeEnvSpec(
        robot=RollerRobot(),
        maze_task=GoalRewardUMaze,
        maze_size_scaling=4.0,
        inner_reward_scaling=GoalRewardUMaze.INNER_REWARD_SCALING,
        device=device,
    )
    return BatchedMazeEnv(spec, num_envs, **kwargs)


if __name__ == "__main__":
    env = make_roller_umaze(num_envs=64,
                            device="cpu" if "--cpu" in sys.argv[1:] else None)
    kind = type(env._kernel_step).__name__
    print(f"RollerUMaze: {env.num_envs} envs on {env.spec.device} through "
          f"{kind}")
    state, obs = env.reset(0)
    gen = torch.Generator(device=env.spec.device).manual_seed(1)
    final, (O, R, T) = env.rollout(state, env.random_policy(), 100, gen)
    print("rollout:", tuple(O.shape), "mean reward", float(R.mean()),
          "final height", float(final.qpos[:, 2].mean()))
