"""The port's float64 Point fidelity path against the MuJoCo goldens.

``MazeEnvSpec(..., dtype=torch.float64)`` steps the Point robot through
the exact mj_step replica (``physics/point_world.py``): held here, case for
case, to the bounds ``tests/test_point_golden.py`` holds the JAX package's
float64 path to, on the committed ``tests/goldens/*.npz``.  Teacher-forced
checks run every step of a golden as one batch (each env starts from the
golden's state before its step); free runs step one env.

Also: the path's sine and cosine (``physics/exact_trig.py``) against
numpy's (libm's) on 10^6 seeded arguments, and the floor-contact switch
they decide; the float64 routing (``BatchedMazeEnv`` steps through
``spec.step``, the float32 kernels refuse a float64 env); every Point ID
builds a float64 spec.  No JAX here.
"""

import os

import _torch_threads  # noqa: F401  (one PyTorch intra-op thread)
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mujoco_maze_tpu_torch import registry  # noqa: E402
from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv  # noqa: E402
from mujoco_maze_tpu_torch.envs.env import EnvState  # noqa: E402
from mujoco_maze_tpu_torch.ops import make_fast_rollout, make_fast_step  # noqa: E402
from mujoco_maze_tpu_torch.physics.exact_trig import sincos  # noqa: E402

from _torch_threads import one_intraop_thread  # noqa: E402,F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# tests/test_point_golden.py EXACT_CASES: (env_id, seed, teacher-forced
# mean bound, free-run steps, free-run atol)
EXACT_CASES = [
    ("PointUMaze-v0", 0, 2e-3, 10, 1e-2),
    ("PointUMaze-v0", 7, 2e-3, 10, 1e-2),
    ("Point4Rooms-v1", 3, 2e-3, 10, 0.3),
    ("PointCorridor-v0", 5, 1e-4, 200, 5e-2),
]
TRIG_ARGS = 10 ** 6
TRIG_MAX_OFF = 10


def _load(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def _spec(env_id):
    return registry.make_spec(env_id, dtype=torch.float64, device="cpu")


def _teacher_forced(spec, g):
    """qpos after each golden step, every step from the golden's state."""
    qp = np.concatenate([g["reset_qpos"][None], g["qpos"][:-1]])
    qv = np.concatenate([g["reset_qvel"][None], g["qvel"][:-1]])
    n = len(g["actions"])
    st = EnvState(qpos=torch.tensor(qp), qvel=torch.tensor(qv),
                  t=torch.zeros(n, dtype=torch.int32))
    res = spec.step(st, torch.tensor(g["actions"]))
    assert res.state.qpos.dtype == torch.float64
    return res.state.qpos.numpy()


def _free_run(spec, g, steps):
    st = EnvState(qpos=torch.tensor(g["reset_qpos"][None]),
                  qvel=torch.tensor(g["reset_qvel"][None]),
                  t=torch.zeros(1, dtype=torch.int32))
    out = []
    for t in range(steps):
        st = spec.step(st, torch.tensor(g["actions"][t][None])).state
        out.append(st.qpos[0].numpy())
    return out


@pytest.mark.parametrize("env_id, seed, tf_mean, fr_steps, fr_atol",
                         EXACT_CASES)
def test_exact_point_world_fidelity(env_id, seed, tf_mean, fr_steps, fr_atol):
    g = _load(f"{env_id}_s{seed}")
    spec = _spec(env_id)
    assert spec.point_world is not None
    errs = np.abs(_teacher_forced(spec, g)[:, :3] - g["qpos"][:, :3]).max(1)
    assert errs.mean() < tf_mean, f"teacher-forced mean {errs.mean():.2e}"
    assert np.median(errs) < 1e-9, f"teacher-forced median {np.median(errs):.2e}"
    for t, q in enumerate(_free_run(spec, g, fr_steps)):
        err = np.abs(q[:2] - g["qpos"][t][:2]).max()
        assert err < fr_atol, f"free-run err {err:.2e} at t={t}"


@pytest.mark.parametrize("seed", [2, 9])
def test_exact_push_block_momentum_golden(seed):
    g = _load(f"PointPush-v0_s{seed}")
    spec = _spec("PointPush-v0")
    assert spec.point_block_world is not None
    q = _teacher_forced(spec, g)
    rob = np.abs(q[:, :3] - g["qpos"][:, :3]).max(1)
    blk = np.abs(q[:, 3:5] - g["qpos"][:, 3:5]).max(1)
    assert np.median(rob) < 1e-9
    assert np.mean(blk) < 1e-3, f"block mean err {np.mean(blk):.2e}"
    assert np.mean(rob) < 2e-3, f"robot mean err {np.mean(rob):.2e}"


def test_exact_billiard_strike_golden():
    g = _load("PointBilliard-v0_strike")
    spec = _spec("PointBilliard-v0")
    assert spec.point_ball_world is not None
    errs = np.abs(_teacher_forced(spec, g) - g["qpos"]).max(1)
    assert errs.mean() < 1e-3, f"strike teacher-forced mean {errs.mean():.2e}"
    assert np.median(errs) < 1e-9
    final = _free_run(spec, g, len(g["actions"]))[-1]
    ball = np.asarray(spec.ball_runtimes[0].body_pos) + final[3:5]
    assert np.linalg.norm(ball - g["ball_xy"][-1]) < 0.5


def test_exact_billiard_rolling_golden():
    g = _load("PointBilliard-v0_s11")
    q = _teacher_forced(_spec("PointBilliard-v0"), g)
    ball = np.abs(q[:, 3:6] - g["qpos"][:, 3:6]).max(1)
    rob = np.abs(q[:, :3] - g["qpos"][:, :3]).max(1)
    assert ball.max() < 1e-9, f"ball err {ball.max():.2e}"
    assert np.mean(rob) < 1e-3


def test_sincos_equals_numpy():
    """libm's sine and cosine to the bit over the half-angles the path
    meets (|x| <= 50), and the floor switch they decide: at most
    TRIG_MAX_OFF arguments off, printed."""
    x = np.random.RandomState(2026).uniform(-50.0, 50.0, TRIG_ARGS)
    s, c = (y.numpy() for y in sincos(torch.from_numpy(x)))
    s_off = np.nonzero(s != np.sin(x))[0]
    c_off = np.nonzero(c != np.cos(x))[0]
    switch = (0.5 * (c * c + s * s) - 0.5 < 0) != (
        0.5 * (np.cos(x) ** 2 + np.sin(x) ** 2) - 0.5 < 0)
    print(f"sin off at {x[s_off].tolist()}, cos off at {x[c_off].tolist()}, "
          f"floor switch off at {x[switch].tolist()}")
    assert len(s_off) <= TRIG_MAX_OFF and len(c_off) <= TRIG_MAX_OFF
    assert int(switch.sum()) <= TRIG_MAX_OFF
    # the special values and the ends of glibc's ranges
    edge = np.array([0.0, -0.0, 1e-300, 2.0 ** -27, 2.0 ** -26, 0.126, -0.126,
                     0.85546875, -0.85546875, 2.4262638092041016, 3.0, 1e5])
    s, c = (y.numpy() for y in sincos(torch.from_numpy(edge)))
    np.testing.assert_array_equal(s, np.sin(edge))
    np.testing.assert_array_equal(c, np.cos(edge))
    assert np.signbit(s[1]) and not np.signbit(s[0])


def test_float32_sincos_is_torch():
    x = torch.linspace(-4, 4, 101)
    s, c = sincos(x)
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))


def test_float64_routing():
    """A float64 env steps through ``spec.step`` (no kernel), as the JAX
    package takes its fast step for float32 only; the kernels refuse it."""
    env = BatchedMazeEnv(_spec("PointUMaze-v0"), 4)
    with pytest.raises(NotImplementedError, match="float32"):
        make_fast_step(env)
    with pytest.raises(NotImplementedError, match="float32"):
        make_fast_rollout(env, 8)
    st, obs = env.reset(0)
    assert st.qpos.dtype == obs.dtype == torch.float64
    policy = env.random_policy()
    g = torch.Generator().manual_seed(0)
    res = env.step(st, policy(obs, g))
    ref = env.spec.step(st, policy(obs, torch.Generator().manual_seed(0)))
    assert torch.equal(res.state.qpos, ref.state.qpos)
    assert res.reward.dtype == torch.float64


def test_float64_other_robots_raise():
    with pytest.raises(NotImplementedError, match="item 16"):
        registry.make_spec("AntUMaze-v0", dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("env_id", [i for i in registry.env_ids()
                                    if i.startswith("Point")])
def test_every_point_id_builds_float64(env_id):
    spec = _spec(env_id)
    assert spec.dtype == torch.float64 and spec.point_world is not None
    assert spec.object_spec is None
    st, obs = spec.reset(torch.Generator().manual_seed(0), 2)
    assert st.qpos.dtype == obs.dtype == torch.float64
    assert spec.walls.p1.dtype == torch.float64


def test_f64_and_quasi_paths_run_without_jax():
    """The float64 path (``physics/point_world.py``,
    ``physics/exact_trig.py``) and the quasi-static rows step and lower
    with JAX, gymnasium and the JAX package blocked."""
    import subprocess
    import sys

    code = """
import sys
sys.modules["jax"] = None
sys.modules["gymnasium"] = None
sys.modules["mujoco_maze_tpu"] = None
import torch
import mujoco_maze_tpu_torch as mmt
from mujoco_maze_tpu_torch import registry
from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec
from mujoco_maze_tpu_torch.models.point import PointRobot
from mujoco_maze_tpu_torch.ops import make_fast_step
gen = torch.Generator().manual_seed(0)
env = BatchedMazeEnv(registry.make_spec("PointBilliard-v0",
                                        dtype=torch.float64, device="cpu"), 2)
st, obs = env.reset(0)
st = env.step(st, env.random_policy()(obs, gen)).state
class Q(PointRobot):
    USES_POINT_WORLD = False
e = registry.entry("PointPush-v0")
q = BatchedMazeEnv(MazeEnvSpec(Q(), e.task_cls, e.maze_size_scaling,
                               device="cpu"), 2)
qs, qo = q.reset(0)
qs = q.step(qs, q.random_policy()(qo, gen)).state
ks = make_fast_step(q).ks
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "jaxlib", "gymnasium",
                                         "mujoco_maze_tpu"))
print("LOADED", loaded, st.qpos.dtype, tuple(qs.qpos.shape),
      ks.quasi_table is not None)
"""
    # the child with one PyTorch intra-op thread, as this process
    # (tests/_torch_threads.py)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED [] torch.float64 (2, 5) True" in proc.stdout
