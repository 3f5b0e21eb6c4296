"""mujoco_maze_tpu_torch — the PyTorch/CUDA port of ``mujoco_maze_tpu``.

The same maze environments, stepped in lockstep for thousands of envs on
one NVIDIA GPU: plain PyTorch around hand-written CUDA kernels
(``csrc/point_lane.cu`` for the Point, with the object worlds' reduced
object solve in ``csrc/point_objects.cuh``; ``csrc/ant_lane.cuh`` built as
``ant_lane.cu`` and ``ant_blocks.cu`` for the Ant, ``csrc/swimmer_lane.cu``
for the Swimmer and the Reacher; ``csrc/engine_lane.cu`` steps any custom
robot composed through the extension API; ``csrc/roofline.cu`` measures
the card's fp32 peak).  It imports torch, numpy and the standard library
only — never JAX, gymnasium or the JAX package.

Entry points run on CUDA unless the caller passes ``device="cpu"``::

    import mujoco_maze_tpu_torch as mmt

    env = mmt.make_batched("PointUMaze-v0", num_envs=4096)
    state, obs = env.reset(seed=0)
    res = env.step(state, actions)        # one CUDA kernel + auto-reset

The port builds and steps, in float32, every one of the 145 registered
IDs through ``spec.step``, and batches 142 of them (``make_batched``,
one CUDA kernel a step on the card): the 21
object-free Point mazes, the 27 Point object worlds (PointPush,
PointMultiPush, PointMultiPushSmall, PointPushMaze, PointFall,
PointMultiFall-v2, PointBlockMaze, PointBlockCarry, PointBilliard,
PointSmallBilliard: movable blocks, the falling block on its platform and
hinge balls, stepped by the reduced object solve), the 21 object-free Ant
mazes, the 21 Ant block worlds (movable blocks and the Fall worlds'
platforms: AntPush, AntFall, AntMultiFall, AntMultiPush,
AntMultiPushSmall, AntPushMaze, AntBlockMaze, AntBlockCarry) and the 52
Swimmer and Reacher IDs (42 object-free, and Push, Fall and MultiFall
with one block that the swimmer never moves).  The 3 AntSmallBilliard
worlds (the Ant with a free object ball) step through ``spec.step`` on the
plain engine; their batched env raises ``NotImplementedError`` until the
Ant kernel takes the ball (ROADMAP queue 1 item 11d-2).

Custom robots: a ``models.base.Robot`` subclass with ``USES_WORLD_ENGINE``
and ``build_bodies``, composed with any task by ``envs.env.MazeEnvSpec``
and batched by ``envs.batched.BatchedMazeEnv``, is stepped by the generic
engine kernel (``examples/custom_robot.py``: ``make_roller_umaze``), in a
task with an object ball too (a free ball, as for the Ant)::

    from mujoco_maze_tpu_torch.examples.custom_robot import make_roller_umaze

    env = make_roller_umaze(4096)          # device="cpu" without a card
"""

from .maze.cells import MazeCell
from .registry import ENV_REGISTRY, EnvEntry, entry, env_ids, make_batched, make_spec
from .tasks.core import MazeGoal, MazeTask, Rgb, Scaling
from .tasks.library import TaskRegistry

__version__ = "0.1.0"

__all__ = [
    "ENV_REGISTRY",
    "EnvEntry",
    "MazeCell",
    "MazeGoal",
    "MazeTask",
    "Rgb",
    "Scaling",
    "TaskRegistry",
    "entry",
    "env_ids",
    "make_batched",
    "make_spec",
]
