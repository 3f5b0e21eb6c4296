"""Launch wrappers of the CUDA kernels (port of the launch side of
``mujoco_maze_tpu.ops.lane_env.LaneEnvKernel``): the Point and Ant step
and rollout kernels.

Each wrapper checks device, dtype, shape and the unit inner stride of its
inputs, allocates outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` through the ``ctypes`` library of
``_build``, checks the launch's return code (``cudaGetLastError``) and
adds one to its entry in :data:`LAUNCHES`.  Inputs on the CPU go to the
kernel's plain PyTorch version (``point_kernel``, ``ant_kernel``); on a
CUDA tensor the wrapper launches or raises, it never falls back.

The kernels read the public ``(B, nq)`` row-major tensors in place, with
the row strides passed in: unlike the JAX wrapper (``lane_env.py:245``),
which transposed to put the batch on the TPU's lanes, there is no
transpose here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from . import _build
from .ant_kernel import NV as NV_ANT
from .ant_kernel import (AntKernelSpec, ant_rollout_plain,
                          ant_step_plain)
from .point_kernel import (REWARD_TYPES, PointKernelSpec, Tensors5,
                           point_rollout_plain, point_step_plain)

# Launches of each kernel in this process, counted where the wrapper
# launches it; a run sets them to 0 and reads them back to show that a
# path went through the kernels.  The Ant kernels have two builds: the
# object-free mazes' ("ant_step", "ant_rollout") and the block worlds'
# ("ant_blocks_step", "ant_blocks_rollout"; csrc/ant_blocks.cu).
LAUNCHES: Dict[str, int] = {"point_step": 0, "point_rollout": 0,
                            "ant_step": 0, "ant_rollout": 0,
                            "ant_blocks_step": 0, "ant_blocks_rollout": 0}
# Threads per block of the Ant kernels: one thread per env, and 4096 envs
# in blocks of 32 spread over 128 of the H100's 132 SMs (PERF.md; a
# wrapper's ``block`` attribute is what chip_smoke.py varies to measure it).
ANT_BLOCK = 32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class PointParams(ctypes.Structure):
    """The scalars of one plain Point maze, passed by value (mirrors
    ``struct PointParams`` in ``csrc/point_lane.cu``, field for field)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "com_offset", "vel_limit",
        "margin", "lam", "mu", "edecay",
        "restitution", "radius",
        "inv_m", "arm_over_m", "inv_ip", "coef",
        "tip0x", "tip0y", "tip1x", "tip1y",
        "penalty", "inv_scale",
    )] + [("reward_type", ctypes.c_int), ("episode_limit", ctypes.c_int)]


def point_params(ks: PointKernelSpec) -> PointParams:
    """The struct of ``ks``; derived constants are computed as the plain
    versions compute them (Python double, rounded once to float32)."""
    m, a, ip = ks.body_mass, ks.couple_arm, ks.spin_inertia
    (t0x, t0y), (t1x, t1y) = ks.arrow_tips
    return PointParams(
        dt=ks.dt, com_offset=ks.com_offset, vel_limit=ks.vel_limit,
        margin=ks.eject_margin, lam=ks.eject_lam, mu=ks.eject_mu,
        edecay=float(np.exp(-ks.eject_lam * ks.dt)),
        restitution=ks.restitution, radius=ks.radius,
        inv_m=1.0 / m, arm_over_m=a / m, inv_ip=1.0 / ip, coef=a / (m * ip),
        tip0x=t0x, tip0y=t0y, tip1x=t1x, tip1y=t1y,
        penalty=ks.penalty,
        inv_scale=float(np.float32(1.0) / np.float32(ks.scale)),
        reward_type=REWARD_TYPES[ks.reward_type],
        episode_limit=ks.episode_limit,
    )


class AntParams(ctypes.Structure):
    """The scalars of one Ant maze, passed by value (mirrors ``struct
    AntParams`` in ``csrc/ant_lane.cuh``, field for field)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "off_body", "off_dof", "off_act", "off_sph", "off_box", "off_goal",
        "off_qpos0", "off_wdof", "off_blk", "off_plat", "off_qpair",
        "n_floats", "n_sph", "n_box", "n_goal", "n_w", "n_blk",
        "frame_skip", "solver_iters", "reward_type", "episode_limit",
        "obs_offset",
    )] + [(name, ctypes.c_float) for name in (
        "h", "h_half", "dt_outer", "gravity",
        "ctrl_weight", "inner_scale", "penalty", "inv_scale",
        "lim_b", "lim_d0", "lim_dd", "lim_width", "lim_kden", "omega",
        "reach2", "sup_kc", "sup_bc", "sup_kl_den", "sup_bl",
    )]


def ant_params(ks: AntKernelSpec) -> AntParams:
    """The struct of ``ks``: constants computed as the engine computes them
    (Python double, rounded once to float32)."""
    o = ks.offsets
    # joint-limit impedance (engine.limit_force): solref (0.02, 1) with the
    # 2 dt clamp, solimp (0.9, 0.95, 0.001); the falling support
    # (contact.falling_support_force) at the same time constant
    tc = max(0.02, 2.0 * ks.timestep)
    d0, dmax, width = 0.9, 0.95, 0.001
    return AntParams(
        off_body=o["body"][0], off_dof=o["dof"][0], off_act=o["act"][0],
        off_sph=o["sph"][0], off_box=o["box"][0], off_goal=o["goals"][0],
        off_qpos0=o["qpos0"][0], off_wdof=o["wdof"][0], off_blk=o["blk"][0],
        off_plat=o["plat"][0], off_qpair=o["qpair"][0],
        n_floats=ks.packed.numel(),
        n_sph=o["sph"][1], n_box=o["box"][1], n_goal=o["goals"][1],
        n_w=ks.n_w, n_blk=ks.n_blk, frame_skip=ks.frame_skip,
        solver_iters=ks.solver_iters,
        reward_type=REWARD_TYPES[ks.reward_type],
        episode_limit=ks.episode_limit, obs_offset=ks.obs_offset,
        h=ks.timestep, h_half=float(np.float32(ks.timestep / 2)),
        dt_outer=ks.dt_outer, gravity=ks.gravity,
        ctrl_weight=ks.ctrl_weight, inner_scale=ks.inner_scale,
        penalty=ks.penalty,
        inv_scale=float(np.float32(1.0) / np.float32(ks.scale)),
        lim_b=2.0 / (dmax * tc), lim_d0=d0, lim_dd=dmax - d0,
        lim_width=width, lim_kden=dmax * dmax * tc * tc, omega=0.6,
        reach2=ks.reach * ks.reach,
        sup_kc=0.995 / (0.995 * 0.995 * tc * tc), sup_bc=2.0 / (0.995 * tc),
        sup_kl_den=0.95 * 0.95 * tc * tc, sup_bl=2.0 / (0.95 * tc),
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    lib.mmt_point_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward, terminated
        _P, _I, _P, _I,                  # walls, W, goals, G
        PointParams, _I, _P]             # params, B, stream
    lib.mmt_point_step.restype = _I
    lib.mmt_point_rollout.argtypes = [
        _P, _P, _P, _I, _I,              # qpos, qvel, t + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward sum, episodes
        _P, _I, _P, _I,                  # walls, W, goals, G
        PointParams, _I, _I, ctypes.c_uint, _P]  # params, B, steps, seed, stream
    lib.mmt_point_rollout.restype = _I
    lib.mmt_ant_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P, _P, _P,      # qpos', qvel', t', reward, terminated,
                                         # active contacts, trace (nullable)
        _P, AntParams, _I, _I, _P]       # tables, params, B, block, stream
    lib.mmt_ant_step.restype = _I
    lib.mmt_ant_rollout.argtypes = [
        _P, _P, _P, _I, _I,              # qpos, qvel, t + row strides
        _P, _P, _P, _P, _P, _P,          # qpos', qvel', t', reward sum,
                                         # episodes, active contacts (nullable)
        _P, AntParams, _I, _I, ctypes.c_uint, _I, _P]
        # tables, params, B, steps, seed, block, stream
    lib.mmt_ant_rollout.restype = _I
    lib.mmt_ant_max_world_dofs.restype = _I
    lib.mmt_ant_max_blocks.restype = _I
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the spec on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if x.dim() == 2 and x.stride(1) != 1 or x.dim() == 1 and x.stride(0) != 1:
        raise ValueError(f"{name} needs a unit inner stride, got {x.stride()}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")


def _tables(ks: PointKernelSpec):
    return (ks.walls.data_ptr(), ks.walls.shape[0], ks.goals.data_ptr(),
            ks.goals.shape[0])


class PointStep:
    """``step(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one Point step with explicit actions and no reset (the
    counterpart of ``LaneEnvKernel.build_step``)."""

    def __init__(self, ks: PointKernelSpec, num_envs: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.params = point_params(ks)

    def __call__(self, qpos, qvel, t, actions) -> Tensors5:
        B, dev = self.num_envs, self.ks.walls.device
        _check("qpos", qpos, torch.float32, (B, 3), dev)
        _check("qvel", qvel, torch.float32, (B, 3), dev)
        _check("t", t, torch.int32, (B,), dev)
        _check("actions", actions, torch.float32, (B, 2), dev)
        if dev.type == "cpu":
            return point_step_plain(self.ks, qpos, qvel, t, actions)
        if dev.type != "cuda":
            raise RuntimeError(f"no Point step kernel for device {dev}")
        q_out = torch.empty((B, 3), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, 3), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        reward = torch.empty((B,), dtype=torch.float32, device=dev)
        term = torch.empty((B,), dtype=torch.bool, device=dev)
        rc = _lib().mmt_point_step(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(), actions.data_ptr(),
            qpos.stride(0), qvel.stride(0), actions.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            reward.data_ptr(), term.data_ptr(), *_tables(self.ks),
            self.params, B, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "point_step")
        LAUNCHES["point_step"] += 1
        return q_out, v_out, t_out, reward, term


class PointRollout:
    """``rollout(qpos, qvel, t, seed) -> (qpos', qvel', t', reward_sum,
    episodes)``: the fused random-policy rollout with auto-reset (the
    counterpart of ``LaneEnvKernel.build_rollout``).  The two sums are
    0-d tensors, summed outside the kernel as the JAX wrapper sums them."""

    def __init__(self, ks: PointKernelSpec, num_envs: int,
                 num_steps: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.num_steps = num_steps
        self.params = point_params(ks)

    def per_env(self, qpos, qvel, t, seed: int) -> Tensors5:
        """The rollout with per-env reward sums ``(B,)`` float32 and
        episode counts ``(B,)`` int32."""
        B, dev = self.num_envs, self.ks.walls.device
        _check("qpos", qpos, torch.float32, (B, 3), dev)
        _check("qvel", qvel, torch.float32, (B, 3), dev)
        _check("t", t, torch.int32, (B,), dev)
        seed = int(seed)
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must fit in 32 bits, got {seed}")
        if dev.type == "cpu":
            return point_rollout_plain(self.ks, qpos, qvel, t, seed,
                                       self.num_steps)
        if dev.type != "cuda":
            raise RuntimeError(f"no Point rollout kernel for device {dev}")
        q_out = torch.empty((B, 3), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, 3), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        rew = torch.empty((B,), dtype=torch.float32, device=dev)
        eps = torch.empty((B,), dtype=torch.int32, device=dev)
        rc = _lib().mmt_point_rollout(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(),
            qpos.stride(0), qvel.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            rew.data_ptr(), eps.data_ptr(), *_tables(self.ks),
            self.params, B, self.num_steps, seed,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "point_rollout")
        LAUNCHES["point_rollout"] += 1
        return q_out, v_out, t_out, rew, eps

    def __call__(self, qpos, qvel, t, seed: int) -> Tensors5:
        q, v, tt, rew, eps = self.per_env(qpos, qvel, t, seed)
        return q, v, tt, torch.sum(rew), torch.sum(eps)


# Words per forward evaluation of the step kernel's trace (kTraceWords in
# csrc/ant_lane.cuh; ``ant_kernel.active_trace`` lays out the plain
# version's alike).
ANT_TRACE_WORDS = 25


def _ant_dims(ks: AntKernelSpec):
    """(nq, nv) of ``ks``: the ant's 15 / 14 and the world dofs."""
    nv = NV_ANT + ks.n_w
    return nv + 1, nv


def _check_ant_bounds(ks: AntKernelSpec) -> None:
    """Refuse a world beyond the library's compile-time bounds."""
    lib = _lib()
    if (ks.n_w > lib.mmt_ant_max_world_dofs()
            or ks.n_blk > lib.mmt_ant_max_blocks()):
        raise NotImplementedError(
            f"{ks.n_blk} blocks with {ks.n_w} world dofs exceed the Ant "
            "kernels' bounds")


class AntStep:
    """``step(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one Ant step with explicit actions and no reset.

    ``count_active=True`` (CUDA only) adds a sixth output: each env's
    active contacts summed over the step's forward evaluations, the
    data-dependent part of the kernel's work.  ``trace=True`` (CUDA only)
    adds, last, each env's active contacts and limits per forward
    evaluation, ``(B, 4 * frame_skip, ANT_TRACE_WORDS)`` int32 bit sets
    (``ant_kernel.active_trace`` lays the plain version's out alike)."""

    def __init__(self, ks: AntKernelSpec, num_envs: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.block = ANT_BLOCK
        self.params = ant_params(ks)

    def __call__(self, qpos, qvel, t, actions, count_active: bool = False,
                 trace: bool = False):
        B, dev = self.num_envs, self.ks.packed.device
        nq, nv = _ant_dims(self.ks)
        _check("qpos", qpos, torch.float32, (B, nq), dev)
        _check("qvel", qvel, torch.float32, (B, nv), dev)
        _check("t", t, torch.int32, (B,), dev)
        _check("actions", actions, torch.float32, (B, 8), dev)
        if dev.type == "cpu":
            if count_active or trace:
                raise ValueError("active-contact counts and traces come from "
                                 "the kernel")
            return ant_step_plain(self.ks, qpos, qvel, t, actions)
        if dev.type != "cuda":
            raise RuntimeError(f"no Ant step kernel for device {dev}")
        _check_ant_bounds(self.ks)
        q_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, nv), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        reward = torch.empty((B,), dtype=torch.float32, device=dev)
        term = torch.empty((B,), dtype=torch.bool, device=dev)
        active = (torch.empty((B,), dtype=torch.int32, device=dev)
                  if count_active else None)
        tr = (torch.empty((B, 4 * self.ks.frame_skip, ANT_TRACE_WORDS),
                          dtype=torch.int32, device=dev) if trace else None)
        rc = _lib().mmt_ant_step(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(), actions.data_ptr(),
            qpos.stride(0), qvel.stride(0), actions.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            reward.data_ptr(), term.data_ptr(),
            None if active is None else active.data_ptr(),
            None if tr is None else tr.data_ptr(),
            self.ks.packed.data_ptr(), self.params, B, self.block,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "ant_step")
        LAUNCHES["ant_blocks_step" if self.ks.n_w else "ant_step"] += 1
        out = (q_out, v_out, t_out, reward, term)
        if count_active:
            out = out + (active,)
        return out + (tr,) if trace else out


class AntRollout:
    """``rollout(qpos, qvel, t, seed) -> (qpos', qvel', t', reward_sum,
    episodes)``: the fused random-policy rollout of the Ant with
    auto-reset (ctrl U(±30); reset: the ant's qpos0 + U(±0.1), quaternion
    renormalised, its qvel 0.1 N(0, 1); the world dofs back to qpos0 at
    rest)."""

    def __init__(self, ks: AntKernelSpec, num_envs: int,
                 num_steps: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.num_steps = num_steps
        self.block = ANT_BLOCK
        self.params = ant_params(ks)

    def per_env(self, qpos, qvel, t, seed: int, count_active: bool = False):
        """The rollout with per-env reward sums ``(B,)`` float32 and
        episode counts ``(B,)`` int32 (and, with ``count_active`` on CUDA,
        the active contacts summed over every forward evaluation)."""
        B, dev = self.num_envs, self.ks.packed.device
        nq, nv = _ant_dims(self.ks)
        _check("qpos", qpos, torch.float32, (B, nq), dev)
        _check("qvel", qvel, torch.float32, (B, nv), dev)
        _check("t", t, torch.int32, (B,), dev)
        seed = int(seed)
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must fit in 32 bits, got {seed}")
        if dev.type == "cpu":
            if count_active:
                raise ValueError("active-contact counts come from the kernel")
            return ant_rollout_plain(self.ks, qpos, qvel, t, seed,
                                     self.num_steps)
        if dev.type != "cuda":
            raise RuntimeError(f"no Ant rollout kernel for device {dev}")
        _check_ant_bounds(self.ks)
        q_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, nv), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        rew = torch.empty((B,), dtype=torch.float32, device=dev)
        eps = torch.empty((B,), dtype=torch.int32, device=dev)
        active = (torch.empty((B,), dtype=torch.int32, device=dev)
                  if count_active else None)
        rc = _lib().mmt_ant_rollout(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(),
            qpos.stride(0), qvel.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            rew.data_ptr(), eps.data_ptr(),
            None if active is None else active.data_ptr(),
            self.ks.packed.data_ptr(), self.params, B, self.num_steps, seed,
            self.block, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "ant_rollout")
        LAUNCHES["ant_blocks_rollout" if self.ks.n_w else "ant_rollout"] += 1
        out = (q_out, v_out, t_out, rew, eps)
        return out + (active,) if count_active else out

    def __call__(self, qpos, qvel, t, seed: int) -> Tensors5:
        q, v, tt, rew, eps = self.per_env(qpos, qvel, t, seed)
        return q, v, tt, torch.sum(rew), torch.sum(eps)
