"""The PyTorch port stands alone: no JAX, no gymnasium, no JAX package.

The card machine has torch but neither JAX nor gymnasium, so the port and
``chip_smoke.py`` must import neither.  Also: the device rule of the entry
points, and the sources' build rules (no ``torch.utils.cpp_extension``, no
``--use_fast_math``).
"""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

import mujoco_maze_tpu_torch as mmt  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mujoco_maze_tpu_torch"

_BLOCKED_IMPORTS = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["gymnasium"] = None
sys.modules["mujoco_maze_tpu"] = None
"""


# A child process of these tests runs PyTorch with one intra-op thread, as
# the test processes do (tests/_torch_threads.py): a pool of one thread per
# core in each child competed with the other pytest workers for the cores.
CHILD_ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def _run(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          env=CHILD_ENV, capture_output=True, text=True,
                          timeout=120)


def test_port_runs_without_jax_or_gymnasium():
    proc = _run(_BLOCKED_IMPORTS + """
import torch
import mujoco_maze_tpu_torch as mmt
from mujoco_maze_tpu_torch import convert
from mujoco_maze_tpu_torch.ops import make_fast_rollout
env = mmt.make_batched("PointUMaze-v0", 8, device="cpu")
state, obs = env.reset(0)
policy = env.random_policy()
gen = torch.Generator().manual_seed(0)
for _ in range(3):
    res = env.step(state, policy(obs, gen))
    state, obs = res.state, res.obs
make_fast_rollout(env, 2)(state.qpos, state.qvel, state.t, 1)
ant = mmt.make_batched("AntUMaze-v0", 8, device="cpu")
a_state, a_obs = ant.reset(0)
a_state = ant.step(a_state, ant.random_policy()(a_obs, gen)).state
make_fast_rollout(ant, 1)(a_state.qpos, a_state.qvel, a_state.t, 1)
sw = mmt.make_batched("SwimmerPush-v0", 8, device="cpu")
s_state, s_obs = sw.reset(0)
s_state = sw.step(s_state, sw.random_policy()(s_obs, gen)).state
make_fast_rollout(sw, 1)(s_state.qpos, s_state.qvel, s_state.t, 1)
from mujoco_maze_tpu_torch.utils import roofline
roofline.fma_chain(torch.rand(8), 4)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "gymnasium",
                                         "mujoco_maze_tpu"))
print("LOADED", loaded, tuple(obs.shape), int(state.t.max()),
      tuple(a_obs.shape), int(a_state.t.max()), tuple(s_obs.shape),
      int(s_state.t.max()))
""")
    assert proc.returncode == 0, proc.stderr
    assert "LOADED [] (8, 7) 3 (8, 30) 1 (8, 14) 1" in proc.stdout


def test_point_object_worlds_run_without_jax_or_gymnasium():
    """The object worlds' modules (``physics/point_world.py``,
    ``ops/object_lanes.py``, the object tables of ``ops/point_kernel.py``)
    step, roll out and lower with JAX, gymnasium and the JAX package
    blocked."""
    proc = _run(_BLOCKED_IMPORTS + """
import torch
import mujoco_maze_tpu_torch as mmt
from mujoco_maze_tpu_torch import convert
from mujoco_maze_tpu_torch.ops import make_fast_rollout, make_fast_step
gen = torch.Generator().manual_seed(0)
shapes = []
for env_id in ("PointPush-v0", "PointBilliard-v0"):
    env = mmt.make_batched(env_id, 4, device="cpu")
    state, obs = env.reset(0)
    state = env.step(state, env.random_policy()(obs, gen)).state
    make_fast_rollout(env, 1)(state.qpos, state.qvel, state.t, 1)
    convert.lowered_spec(make_fast_step(env).ks)
    shapes.append(tuple(state.qpos.shape))
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "gymnasium",
                                         "mujoco_maze_tpu"))
print("LOADED", loaded, shapes)
""")
    assert proc.returncode == 0, proc.stderr
    assert "LOADED [] [(4, 5), (4, 6)]" in proc.stdout


def test_custom_robot_runs_without_jax_or_gymnasium():
    """The extension API's example, the generic engine kernel's module and
    its lowering step, reset and lower with JAX, gymnasium and the JAX
    package blocked, in a free-ball world too; the example runs as a
    module on the CPU."""
    proc = _run(_BLOCKED_IMPORTS + """
import torch
from mujoco_maze_tpu_torch import convert
from mujoco_maze_tpu_torch.examples import custom_robot
from mujoco_maze_tpu_torch.ops import engine_kernel, make_fast_step
env = custom_robot.make_roller_umaze(4, device="cpu")
state, obs = env.reset(0)
gen = torch.Generator().manual_seed(0)
state = env.step(state, env.random_policy()(obs, gen)).state
ks = make_fast_step(env).ks
convert.lowered_spec(ks)
engine_kernel.sphere_robot_states(env.spec, 4, 0)
from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec
from mujoco_maze_tpu_torch.tasks.library import GoalRewardSmallBilliard
balls = BatchedMazeEnv(MazeEnvSpec(custom_robot.RollerRobot(),
                                   GoalRewardSmallBilliard, 2.0,
                                   device="cpu"), 4)
state, ball_obs = balls.reset(0)
balls.step(state, balls.random_policy()(ball_obs, gen))
engine_kernel.ball_states(balls.spec, 4, 0)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "gymnasium",
                                         "mujoco_maze_tpu"))
print("LOADED", loaded, type(ks).__name__, tuple(obs.shape),
      tuple(ball_obs.shape))
""")
    assert proc.returncode == 0, proc.stderr
    assert "LOADED [] EngineKernelSpec (4, 7) (4, 10)" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS + """
import runpy, sys
sys.argv = ["custom_robot", "--cpu"]
runpy.run_module("mujoco_maze_tpu_torch.examples.custom_robot",
                 run_name="__main__")
"""], cwd=REPO, env=CHILD_ENV, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "RollerUMaze: 64 envs on cpu through EngineStep" in proc.stdout
    assert "rollout: (100, 64, 7)" in proc.stdout


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result without CUDA, with
    JAX blocked (so it cannot reach for it)."""
    proc = _run(_BLOCKED_IMPORTS + """
import runpy
runpy.run_path("chip_smoke.py", run_name="__main__")
""")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo,
    the script fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("entry", ["make_spec", "make_batched"])
def test_entry_points_refuse_to_fall_back_to_cpu(entry, monkeypatch):
    """device=None means CUDA: without a card the entry point raises
    instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for env_id in ("PointUMaze-v0", "AntUMaze-v0", "SwimmerUMaze-v0"):
        args = (env_id,) if entry == "make_spec" else (env_id, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(mmt, entry)(*args)
        with pytest.raises(RuntimeError):
            getattr(mmt, entry)(*args, device="cuda")
        assert getattr(mmt, entry)(*args, device="cpu") is not None


def _sources():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
             + sorted(PORT.rglob("*.cuh")))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_sources_keep_the_port_rules(path):
    text = path.read_text()
    for banned in ("import jax", "from jax", "import gymnasium",
                   "from mujoco_maze_tpu ", "from mujoco_maze_tpu.",
                   "import mujoco_maze_tpu\n", "import mujoco_maze_tpu.",
                   "cpp_extension", "use_fast_math", "torch/extension.h"):
        assert banned not in text, f"{path.name} contains {banned!r}"
