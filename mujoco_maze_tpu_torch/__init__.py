"""mujoco_maze_tpu_torch — the PyTorch/CUDA port of ``mujoco_maze_tpu``.

The same maze environments, stepped in lockstep for thousands of envs on
one NVIDIA GPU: plain PyTorch around hand-written CUDA kernels
(``csrc/point_lane.cu`` for the Point, ``csrc/ant_lane.cuh`` built as
``ant_lane.cu`` and ``ant_blocks.cu`` for the Ant).  It imports torch,
numpy and the standard library only — never JAX, gymnasium or the JAX
package.

Entry points run on CUDA unless the caller passes ``device="cpu"``::

    import mujoco_maze_tpu_torch as mmt

    env = mmt.make_batched("PointUMaze-v0", num_envs=4096)
    state, obs = env.reset(seed=0)
    res = env.step(state, actions)        # one CUDA kernel + auto-reset

The port covers, in float32, 63 of the 145 registered IDs: the 21
object-free Point mazes, the 21 object-free Ant mazes and the 21 Ant block
worlds (movable blocks and the Fall worlds' platforms: AntPush, AntFall,
AntMultiFall, AntMultiPush, AntMultiPushSmall, AntPushMaze, AntBlockMaze,
AntBlockCarry).  The other IDs raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
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
