"""Static world, tasks and registry of the PyTorch port vs the JAX package.

For every one of the 145 registered env IDs: the registry entry, the maze
structure, the wall soups and the lowered goal arrays are equal on both
sides, and the port's ``make_spec`` builds the spec of every one.  The
override of the inner reward's scale reaches the reward as in the JAX
package.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_threads import one_intraop_thread  # noqa: E402,F401

from mujoco_maze_tpu.maze.structure import analyze_maze as jax_analyze  # noqa: E402
from mujoco_maze_tpu.registry import ENV_REGISTRY as JAX_REGISTRY  # noqa: E402
from mujoco_maze_tpu.tasks.core import lower_goals as jax_lower_goals  # noqa: E402

import mujoco_maze_tpu_torch as mmt  # noqa: E402
from mujoco_maze_tpu_torch.maze.structure import analyze_maze  # noqa: E402
from mujoco_maze_tpu_torch.tasks.core import lower_goals  # noqa: E402

IDS = list(JAX_REGISTRY)


def test_registry_ids_match():
    assert len(IDS) == 145
    assert mmt.env_ids() == IDS


def _structures(env_id):
    je, pe = JAX_REGISTRY[env_id], mmt.ENV_REGISTRY[env_id]
    jt, pt = je.task_cls(je.maze_size_scaling), pe.task_cls(pe.maze_size_scaling)
    js = jax_analyze(jt.create_maze(), je.maze_size_scaling, 0.5,
                     put_spin_near_agent=jt.PUT_SPIN_NEAR_AGENT)
    ps = analyze_maze(pt.create_maze(), pe.maze_size_scaling, 0.5,
                      put_spin_near_agent=pt.PUT_SPIN_NEAR_AGENT)
    return je, pe, jt, pt, js, ps


@pytest.mark.parametrize("env_id", IDS)
def test_static_world_matches(env_id):
    je, pe, jt, pt, js, ps = _structures(env_id)
    for field in ("robot_name", "maze_id", "version", "maze_size_scaling",
                  "inner_reward_scaling", "reward_threshold", "max_episode_steps"):
        assert getattr(je, field) == getattr(pe, field), field
    assert je.task_cls.__name__ == pe.task_cls.__name__
    for attr in ("REWARD_TYPE", "OBS_OFFSET", "PENALTY", "OBSERVE_BLOCKS",
                 "OBSERVE_BALLS", "OBJECT_BALL_SIZE", "TOP_DOWN_VIEW"):
        assert getattr(jt, attr) == getattr(pt, attr), attr
    # maze structure and wall soups (robot radius 0.4 and the ball radius)
    np.testing.assert_array_equal(js.grid, ps.grid)
    assert (js.torso_x, js.torso_y, js.init_positions) == (
        ps.torso_x, ps.torso_y, ps.init_positions)
    for name in ("block_pos", "block_size", "platform_pos", "platform_size"):
        np.testing.assert_array_equal(getattr(js, name), getattr(ps, name))
    for name in ("movable_blocks", "object_balls"):
        assert ([dataclasses.asdict(o) for o in getattr(js, name)]
                == [dataclasses.asdict(o) for o in getattr(ps, name)]), name
    for radius in (0.4, jt.OBJECT_BALL_SIZE):
        np.testing.assert_array_equal(js.wall_segments(radius),
                                      ps.wall_segments(radius))
    assert js.xy_limits() == ps.xy_limits()
    # lowered goal arrays (float32 on both sides)
    jg, pg = jax_lower_goals(jt.goals), lower_goals(pt.goals)
    for name in ("pos", "dim_mask", "threshold", "reward_scale", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(pg, name).numpy(), err_msg=name)


@pytest.mark.parametrize("env_id", IDS)
def test_make_spec_covers_the_object_free_point_mazes(env_id):
    """Every ID builds: the Point mazes (the object worlds too), the Ant
    mazes (with blocks, or with a free object ball), and the Swimmer and
    Reacher mazes (no stock one has an object ball); nothing else is
    registered."""
    je, _, _, _, js, _ = _structures(env_id)
    if je.robot_name == "Point":
        spec = mmt.make_spec(env_id, device="cpu")
        segs = js.wall_segments(0.4)
        np.testing.assert_array_equal(spec.walls.p1.numpy(),
                                      segs[:, 0].astype(np.float32))
        np.testing.assert_array_equal(spec.walls.p2.numpy(),
                                      segs[:, 1].astype(np.float32))
        n_obs = ((len(js.object_balls) if je.task_cls.OBSERVE_BALLS else 0)
                 + (len(js.movable_blocks) if je.task_cls.OBSERVE_BLOCKS else 0))
        n_world = (3 * len(js.object_balls)
                   + sum(b.move_x + b.move_y + b.move_z
                         for b in js.movable_blocks))
        assert (spec.nq, spec.nv) == (3 + n_world,) * 2
        assert spec.obs_dim == 7 + 3 * n_obs
    elif je.robot_name == "Ant":
        spec = mmt.make_spec(env_id, device="cpu")
        np.testing.assert_array_equal(
            spec.contact_set.box_center,
            np.concatenate([js.block_pos, js.platform_pos]).reshape(-1, 3))
        n_obs = ((len(js.object_balls) if je.task_cls.OBSERVE_BALLS else 0)
                 + (len(js.movable_blocks) if je.task_cls.OBSERVE_BLOCKS else 0))
        assert spec.obs_dim == 30 + 3 * n_obs
        assert spec.nq == 15 + 7 * len(js.object_balls) + sum(
            b.move_x + b.move_y + b.move_z for b in js.movable_blocks)
    elif je.robot_name in ("Swimmer", "Reacher") and not js.object_balls:
        spec = mmt.make_spec(env_id, device="cpu")
        n_robot = 5 if je.robot_name == "Swimmer" else 4
        n_obs = len(js.movable_blocks) if je.task_cls.OBSERVE_BLOCKS else 0
        n_world = sum(b.move_x + b.move_y + b.move_z for b in js.movable_blocks)
        assert (spec.nq, spec.nv) == (n_robot + n_world,) * 2
        assert spec.obs_dim == 2 * n_robot + 1 + 3 * n_obs
    else:
        pytest.fail(f"{env_id}: no stock Swimmer or Reacher maze has an "
                    "object ball")


def test_inner_reward_scaling_override():
    """``make_spec(..., inner_reward_scaling=...)`` takes the override and
    the reward carries it, as JAX registry.py:112-131 does: AntUMaze-v0
    at 1.0 (the task's own is 0.01), the port's ``spec.step`` against the
    JAX ``spec.step`` on one state and one set of actions, at the Ant
    step's bounds (tests/test_torch_ant_step.py: reward 1e-4)."""
    import jax
    import jax.numpy as jnp
    import torch

    import mujoco_maze_tpu as jmmt
    from mujoco_maze_tpu_torch import convert

    B = 4
    jspec = jmmt.make_spec("AntUMaze-v0", inner_reward_scaling=1.0)
    tspec = mmt.make_spec("AntUMaze-v0", inner_reward_scaling=1.0,
                          device="cpu")
    plain = mmt.make_spec("AntUMaze-v0", device="cpu")
    assert (tspec.inner_reward_scaling, plain.inner_reward_scaling) == (1.0, 0.01)
    jst, _ = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(1), B))
    act = np.random.RandomState(1).uniform(-30, 30, (B, 8)).astype(np.float32)
    jres = jax.jit(jax.vmap(jspec.step))(jst, jnp.asarray(act))
    tst = convert.from_jax_state(jst.qpos, jst.qvel, jst.t, device="cpu")
    tres = tspec.step(tst, torch.as_tensor(act))
    np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward),
                               rtol=0, atol=1e-4)
    # the override scales the inner reward alone
    base = plain.step(tst, torch.as_tensor(act))
    inner = (tres.info["reward_forward"] + tres.info["reward_ctrl"]).numpy()
    np.testing.assert_allclose(tres.reward.numpy() - base.reward.numpy(),
                               0.99 * inner, rtol=0, atol=1e-4)
    assert np.abs(inner).max() > 1e-2
    batched = mmt.make_batched("AntUMaze-v0", 2, device="cpu",
                               inner_reward_scaling=1.0)
    assert batched.spec.inner_reward_scaling == 1.0
