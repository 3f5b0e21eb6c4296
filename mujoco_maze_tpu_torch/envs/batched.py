"""Batched lockstep environment with auto-reset (port of
``mujoco_maze_tpu.envs.batched``).

On a CUDA device every step is one launch of the hand-written step kernel
(``ops.make_fast_step``: the Point or the Ant kernel), followed by the
observation and a branch-free auto-reset fold in PyTorch — the
counterpart of the JAX package's ``_build_fast_step``.  On the CPU the
same wrapper runs the kernel's plain PyTorch version.  ``rollout`` and
``rollout_metrics`` are Python loops over ``step``; the fused
random-policy rollout kernel is ``ops.make_fast_rollout``.  In the block
worlds the observation holds the blocks' centers (``spec.obs_dim`` wide)
and a reset puts the blocks back at their start, at rest
(``MazeEnvSpec.reset``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .env import EPISODE_LIMIT, EnvState, MazeEnvSpec, StepResult

Policy = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


class BatchedMazeEnv:
    """A fixed-size batch of identical envs stepped in lockstep.

    ``generator`` is the env's own reset stream: ``reset(seed)`` seeds it,
    and every auto-reset draws from it.
    """

    def __init__(self, spec: MazeEnvSpec, num_envs: int,
                 auto_reset: bool = True) -> None:
        from ..ops import make_fast_step

        self.spec = spec
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.generator = torch.Generator(device=spec.device)
        self._kernel_step = make_fast_step(self)

    # -- public API --------------------------------------------------------
    def reset(self, seed: int) -> Tuple[EnvState, torch.Tensor]:
        self.generator.manual_seed(seed)
        return self.spec.reset(self.generator, self.num_envs)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """state: batched EnvState; action: (num_envs, action_dim)."""
        spec = self.spec
        qp, qv, tt, rew, term = self._kernel_step(
            state.qpos, state.qvel, state.t, action)
        trunc = tt >= EPISODE_LIMIT
        new_state = EnvState(qpos=qp, qvel=qv, t=tt, goal_pos=state.goal_pos)
        obs = spec._observe(new_state)
        info = {"position": qp[:, :2]}
        if not spec.robot.MANUAL_COLLISION:
            # the inner reward terms, re-derived from the kernel's output
            # (ant.py:71-73 info parity, as the JAX package's fast step)
            fwd, cc = spec.robot.inner_reward_terms(
                state.qpos[:, :2], qp[:, :2], action.to(spec.dtype))
            info = {"reward_forward": fwd, "reward_ctrl": -cc, **info}
        res = StepResult(state=new_state, obs=obs, reward=rew,
                         terminated=term, truncated=trunc, info=info)
        if not self.auto_reset:
            return res
        # branch-free fold: every env pays for a reset draw, done envs take it
        done = (term | trunc)[:, None]
        reset_state, reset_obs = spec.reset(self.generator, self.num_envs)
        folded = EnvState(
            qpos=torch.where(done, reset_state.qpos, qp),
            qvel=torch.where(done, reset_state.qvel, qv),
            t=torch.where(done[:, 0], reset_state.t, tt),
            goal_pos=state.goal_pos,
        )
        return res._replace(state=folded,
                            obs=torch.where(done, reset_obs, obs))

    def rollout(self, state: EnvState, policy: Policy, num_steps: int,
                generator: torch.Generator):
        """``num_steps`` lockstep steps.  ``policy(obs, generator) ->
        actions``.  Returns the final state and stacked (obs, reward,
        terminated) trajectories."""
        obs = self.spec._observe(state)
        traj_obs, traj_rew, traj_term = [], [], []
        for _ in range(num_steps):
            res = self.step(state, policy(obs, generator))
            state, obs = res.state, res.obs
            traj_obs.append(res.obs)
            traj_rew.append(res.reward)
            traj_term.append(res.terminated)
        return state, (torch.stack(traj_obs), torch.stack(traj_rew),
                       torch.stack(traj_term))

    def rollout_metrics(self, state: EnvState, policy: Policy, num_steps: int,
                        generator: torch.Generator):
        """Like :meth:`rollout` without stacking: returns the final state,
        the summed reward and the episode count, as 0-d device tensors."""
        obs = self.spec._observe(state)
        rew_sum = torch.zeros((), dtype=self.spec.dtype, device=self.spec.device)
        ep_count = torch.zeros((), dtype=torch.int64, device=self.spec.device)
        for _ in range(num_steps):
            res = self.step(state, policy(obs, generator))
            state, obs = res.state, res.obs
            rew_sum = rew_sum + res.reward.sum()
            ep_count = ep_count + (res.terminated | res.truncated).sum()
        return state, rew_sum, ep_count

    def random_policy(self) -> Policy:
        low, high = self.spec.action_bounds()
        width = torch.as_tensor(high - low, dtype=self.spec.dtype,
                                device=self.spec.device)
        low = torch.as_tensor(low, dtype=self.spec.dtype, device=self.spec.device)
        shape = (self.num_envs, self.spec.robot.action_dim)

        def policy(obs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
            u = torch.rand(shape, generator=generator, device=generator.device)
            return low + u * width

        return policy
