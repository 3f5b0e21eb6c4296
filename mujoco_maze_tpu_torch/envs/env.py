"""Lockstep maze environment: spec construction + batched reset/step.

Port of ``mujoco_maze_tpu.envs.env`` for the object-free mazes in float32,
with the Point robot (manual collision) and the Ant robot (the rigid-body
engine with contacts).  Construction lowers the grid maze to wall, box and
goal tables on one device; the step is a function

    step(state, action) -> StepResult(state', obs, reward, terminated, ...)

over an explicit :class:`EnvState` of batched tensors (``qpos (B, nq)``,
``qvel (B, nv)``, ``t (B,)`` int32).  Randomness comes from an explicit
``torch.Generator``.

Point step order (maze_env.py:448-481): manual robot kinematics → smooth
residual → wall-contact ejection → arrow-tip contacts → robot wall
resolution → observation (t already incremented) → task heads.  The Ant
step is frame_skip RK4 steps of the world model with contacts, then the
observation and the heads, with the inner reward (forward speed minus
control cost) scaled by the task's ``INNER_REWARD_SCALING``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from ..maze.structure import MazeStructure, analyze_maze
from ..models.base import Robot
from ..ops import segments
from ..tasks.core import MazeTask, TaskHeads

EPISODE_LIMIT = 1000  # reference max_episode_steps (__init__.py:31)


class EnvState(NamedTuple):
    """Batched dynamic state."""

    qpos: torch.Tensor  # (B, nq) float32, robot dofs then world dofs
    qvel: torch.Tensor  # (B, nv) float32
    t: torch.Tensor     # (B,) int32 — env steps since reset
    goal_pos: Optional[torch.Tensor] = None  # (B, G, 3) when the task
                                             # resamples goals; else None


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, torch.Tensor]


class MazeEnvSpec:
    """Static description of one env ID on one device; batched reset/step.

    This slice of the port covers the Point and Ant robots in object-free
    mazes in float32.  Everything else raises ``NotImplementedError``
    naming the ROADMAP queue item that ports it.
    """

    def __init__(
        self,
        robot: Robot,
        maze_task: Type[MazeTask],
        maze_size_scaling: float,
        inner_reward_scaling: float = 1.0,
        maze_height: float = 0.5,
        restitution_coef: float = 0.8,
        task_kwargs: Optional[Dict[str, Any]] = None,
        dtype: torch.dtype = torch.float32,
        device: torch.device = torch.device("cpu"),
    ) -> None:
        if dtype != torch.float32:
            raise NotImplementedError(
                "the float64 Point fidelity path is not ported yet "
                "(ROADMAP queue 1 item 9)")
        if robot.NAME not in ("Point", "Ant"):
            raise NotImplementedError(
                f"the {robot.NAME} robot is not ported yet "
                "(ROADMAP queue 1 item 10)")
        self.robot = robot
        self.device = torch.device(device)
        self.dtype = dtype
        self.task: MazeTask = maze_task(maze_size_scaling, **(task_kwargs or {}))
        self.inner_reward_scaling = float(inner_reward_scaling)
        self.restitution_coef = float(restitution_coef)

        ms = analyze_maze(
            self.task.create_maze(),
            maze_size_scaling,
            maze_height,
            put_spin_near_agent=self.task.PUT_SPIN_NEAR_AGENT,
        )
        self.structure: MazeStructure = ms
        if ms.movable_blocks or ms.object_balls or ms.elevated:
            item = "8" if robot.NAME == "Point" else "11"
            raise NotImplementedError(
                f"{robot.NAME} object worlds (movable blocks, object balls, "
                f"elevated platforms) are not ported yet (ROADMAP queue 1 "
                f"item {item})")
        if self.task.TOP_DOWN_VIEW or self.task.sample_goals():
            raise NotImplementedError(
                "top-down views and per-episode goal sampling are not ported "
                "yet (ROADMAP queue 1 item 8)")
        if len(ms.init_positions) != 1:
            raise NotImplementedError(
                "mazes with several start cells are not ported yet "
                "(ROADMAP queue 1 item 8)")
        self.heads: TaskHeads = self.task.lower(self.device)

        self.walls = None
        self.dynamic_model = None
        self.contact_set = None
        if getattr(robot, "USES_WORLD_ENGINE", False):
            self._build_engine_world()
            self.init_qpos = self.dynamic_model.qpos0.copy()
        else:
            segs = ms.wall_segments(robot.RADIUS)
            self.walls = segments.pad_walls(segs, max(len(segs), 1), self.device)
            self.nq = robot.nq
            self.nv = robot.nv
            self.init_qpos = robot.init_qpos(ms.height_offset)
        self.init_qvel = np.zeros(self.nv, dtype=np.float64)
        self.obs_dim = robot.obs_dim + 1

    def _build_engine_world(self) -> None:
        """Compose robot + static maze geoms into ONE RigidModel stepped by
        the engine with contacts (the Ant path; JAX env.py:283-541 for the
        object-free mazes): each BLOCK cell becomes a static AABB and the
        floor a plane, with the robot XML's default geom class."""
        from ..physics import contact as contact_mod
        from ..physics import engine as engine_mod
        from ..physics.model import Geom, build_model

        ms = self.structure
        robot = self.robot
        bodies, actuators = robot.build_bodies(torso_z=0.75 + ms.height_offset)
        geom_default = dict(robot.WORLD_GEOM_DEFAULTS)
        statics = [
            Geom(gtype=3, size=(), pos=(0, 0, 0), contype=1, conaffinity=1,
                 friction=geom_default.get("friction", (1.0, 0.5, 0.5)),
                 solref=geom_default.get("solref", (0.02, 1.0)),
                 solimp=geom_default.get("solimp", (0.8, 0.8, 0.01)),
                 margin=geom_default.get("margin", 0.0))
        ]
        for pos, size in zip(ms.block_pos, ms.block_size):
            statics.append(Geom(gtype=2, size=tuple(size), pos=tuple(pos),
                                contype=1, conaffinity=1, **geom_default))
        model = build_model(bodies, actuators, timestep=robot.timestep,
                            static_geoms=statics)
        self.dynamic_model = engine_mod.prepare(model)
        self.contact_set = contact_mod.build_contact_set(model)
        self.nq = model.nq
        self.nv = model.nv

    # ------------------------------------------------------------------
    # observation assembly (maze_env.py:351-369)
    # ------------------------------------------------------------------
    def _observe(self, state: EnvState) -> torch.Tensor:
        robot_obs = self.robot.observe(state.qpos, state.qvel)
        time = state.t.to(self.dtype) * 0.001
        return torch.cat([robot_obs, time[:, None]], dim=1)

    # ------------------------------------------------------------------
    # batched reset / step
    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator,
              num_envs: int) -> Tuple[EnvState, torch.Tensor]:
        """``num_envs`` fresh episodes drawn from ``generator``."""
        qpos_noise, qvel_noise = self.robot.reset_noise(
            generator, num_envs, self.nq, self.nv)
        qpos0 = torch.as_tensor(self.init_qpos, dtype=self.dtype,
                                device=self.device)
        qpos = qpos0 + qpos_noise
        qvel = torch.as_tensor(self.init_qvel, dtype=self.dtype,
                               device=self.device) + qvel_noise
        if self.robot.ZERO_WORLD_DOFS_ON_RESET and self.nq > self.robot.nq:
            qpos[:, self.robot.nq:] = qpos0[self.robot.nq:]
            qvel[:, self.robot.nv:] = 0.0
        state = EnvState(
            qpos=qpos, qvel=qvel,
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device))
        return state, self._observe(state)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        if self.robot.MANUAL_COLLISION:
            new_state = self._step_manual(state, action)
            obs = self._observe(new_state)
            # the Point robot's inner reward is identically 0 (point.py:61)
            reward = self.heads.reward(obs, new_state.goal_pos)
            info = {}
        else:
            new_state, inner, info = self._step_dynamic(state, action)
            obs = self._observe(new_state)
            reward = (self.inner_reward_scaling * inner
                      + self.heads.reward(obs, new_state.goal_pos))
        terminated = self.heads.termination(obs, new_state.goal_pos)
        truncated = new_state.t >= EPISODE_LIMIT
        info = {**info, "position": new_state.qpos[:, :2]}
        return StepResult(new_state, obs, reward, terminated, truncated, info)

    def _step_dynamic(self, state: EnvState, action: torch.Tensor):
        """Ant path (JAX env.py:1139-1157): the robot's engine dynamics,
        then the inner reward terms (ant.py:71-73 info parity)."""
        robot = self.robot
        action = action.to(self.dtype)
        qpos, qvel = robot.dynamics_step(self, state.qpos, state.qvel, action)
        forward, ctrl_cost = robot.inner_reward_terms(
            state.qpos[:, :2], qpos[:, :2], action)
        new_state = EnvState(qpos=qpos, qvel=qvel, t=state.t + 1,
                             goal_pos=state.goal_pos)
        info = {"reward_forward": forward, "reward_ctrl": -ctrl_cost}
        inner = robot.FORWARD_REWARD_WEIGHT * forward - ctrl_cost
        return new_state, inner, info

    def _step_manual(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Point path (maze_env.py:450-473), the float32 branch of the JAX
        package's ``_step_manual``."""
        robot = self.robot
        qpos, qvel = state.qpos, state.qvel
        old_xy = qpos[:, :2]
        # robot kinematics + full-state velocity clip (point.py:44-57)
        qpos, qvel = robot.kinematic_step(qpos, qvel, action.to(self.dtype))
        # closed-form smooth residual of mj_step
        qpos, qvel = robot.residual_step(qpos, qvel)
        # wall-contact ejection at the position mj_step saw (pre manual
        # resolution): the body sphere (0.5) exceeds the manual detector's
        # inflation (0.4), so pressing into a wall overlaps the geoms
        dv = segments.impedance_eject(
            self.walls, qpos[:, :2], qvel[:, :2], robot.WALL_CONTACT_MARGIN,
            robot.CONTACT_LAM, robot.timestep, robot.CONTACT_MU, old=old_xy)
        qvel = torch.cat([qvel[:, :2] + dv, qvel[:, 2:]], dim=1)
        # arrow-box tip contacts, one tip after the other (each tip sees the
        # previous tip's qvel update)
        th = qpos[:, 2]
        ct, st = torch.cos(th), torch.sin(th)
        for tbx, tby in robot.ARROW_TIPS:
            tip = qpos[:, :2] + torch.stack(
                [tbx * ct - tby * st, tbx * st + tby * ct], dim=1)
            dv3 = segments.tip_impedance_eject(
                self.walls, qpos[:, :2], tip, qvel[:, :3], th, robot.RADIUS,
                robot.CONTACT_LAM, robot.timestep, robot.BODY_MASS,
                robot.COUPLE_ARM, robot.SPIN_INERTIA_PRIME, old=old_xy)
            qvel = torch.cat([qvel[:, :3] + dv3, qvel[:, 3:]], dim=1)
        # robot wall resolution (maze_env.py:457-464)
        resolved = segments.resolve(self.walls, old_xy, qpos[:, :2],
                                    self.restitution_coef)
        qpos = torch.cat([resolved, qpos[:, 2:]], dim=1)
        return EnvState(qpos=qpos, qvel=qvel, t=state.t + 1,
                        goal_pos=state.goal_pos)

    # ------------------------------------------------------------------
    # spaces / metadata (host side)
    # ------------------------------------------------------------------
    def observation_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Parity with MazeEnv._get_obs_space (maze_env.py:235-246)."""
        high = np.full(self.obs_dim, np.inf, dtype=np.float64)
        low = -high
        r_low, r_high = self.robot.obs_bounds()
        n = len(r_high)
        high[:n] = r_high
        low[:n] = r_low
        xmin, xmax, ymin, ymax = self.structure.xy_limits()
        low[0], high[0], low[1], high[1] = xmin, xmax, ymin, ymax
        return low, high

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.robot.action_bounds()
