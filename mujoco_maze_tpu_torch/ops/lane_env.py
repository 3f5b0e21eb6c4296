"""Launch wrappers of the CUDA kernels (port of the launch side of
``mujoco_maze_tpu.ops.lane_env.LaneEnvKernel``): the Point (plain mazes,
object worlds with the object solve, and with the quasi-static rows), Ant and swimmer (Swimmer and Reacher) step and
rollout kernels, and the generic engine step kernel of custom robots.

Each wrapper checks device, dtype, shape and the unit inner stride of its
inputs, allocates outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` through the ``ctypes`` library of
``_build``, checks the launch's return code (``cudaGetLastError``) and
adds one to its entry in :data:`LAUNCHES`.  Inputs on the CPU go to the
kernel's plain PyTorch version (``point_kernel``, ``ant_kernel``,
``swimmer_kernel``, ``engine_kernel``); on a CUDA tensor the wrapper launches or raises, it
never falls back.

The kernels read the public ``(B, nq)`` row-major tensors in place, with
the row strides passed in: unlike the JAX wrapper (``lane_env.py:245``),
which transposed to put the batch on the TPU's lanes, there is no
transpose here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .ant_kernel import MAX_BLOCKS, MAX_WORLD_DOFS
from .ant_kernel import NV as NV_ANT
from .ant_kernel import (AntKernelSpec, ant_rollout_plain,
                          ant_step_plain)
from .engine_kernel import EngineKernelSpec, engine_step_plain, row_floats
from . import object_lanes
from .point_kernel import (REWARD_TYPES, PointKernelSpec, Tensors5,
                           point_rollout_plain, point_step_plain)
from .swimmer_kernel import (SwimmerKernelSpec, swimmer_rollout_plain,
                             swimmer_step_plain)
from .swimmer_math import LIMIT_D0, LIMIT_DMAX, LIMIT_WIDTH

# Launches of each kernel in this process, counted where the wrapper
# launches it; a run sets them to 0 and reads them back to show that a
# path went through the kernels.  The Point kernels have two
# instantiations: the plain mazes' ("point_step", "point_rollout") and the
# object worlds' ("point_objects_step", "point_objects_rollout", with the
# reduced object solve of csrc/point_objects.cuh) and the object worlds of
# a Point robot without the object solve ("point_quasi_step",
# "point_quasi_rollout": the quasi-static push and kick/roll/bounce ball of
# csrc/point_lane.cu).  The Ant kernels have
# three builds: the object-free mazes' ("ant_step", "ant_rollout"), the
# block worlds' ("ant_blocks_step", "ant_blocks_rollout"; csrc/
# ant_blocks.cu) and the ball worlds' ("ant_balls_step",
# "ant_balls_rollout"; csrc/ant_balls.cu).  The
# swimmer kernels serve the Swimmer and the Reacher, with or without world
# dofs (csrc/swimmer_lane.cu).  "engine_step" counts the generic engine
# step of custom robots (csrc/engine_lane.cu), which has no rollout kernel,
# as in the JAX package.  "fma_peak" counts the fp32 peak kernel
# (csrc/roofline.cu), which no env path runs; its wrapper is
# utils/roofline.py fma_chain.
LAUNCHES: Dict[str, int] = {"point_step": 0, "point_rollout": 0,
                            "point_objects_step": 0,
                            "point_objects_rollout": 0,
                            "point_quasi_step": 0, "point_quasi_rollout": 0,
                            "ant_step": 0, "ant_rollout": 0,
                            "ant_blocks_step": 0, "ant_blocks_rollout": 0,
                            "ant_balls_step": 0, "ant_balls_rollout": 0,
                            "swimmer_step": 0, "swimmer_rollout": 0,
                            "engine_step": 0, "fma_peak": 0}
# Lanes of the cooperative group that steps one Ant env (kLanes in
# csrc/ant_lane.cuh): a full warp.
ANT_LANES = 32
# The Ant kernels' shared memory (csrc/ant_lane.cuh): the staged tables,
# then per group its state (struct Group, ant_group_floats) and its
# contact region: one slot of ANT_CON_STRIDE floats for each candidate
# contact, the list of the active ones and a row of nv + 1 floats for each
# lane (its contact's J^T f), or the scratch the region lends the mass
# matrix and the RNE recursions where that is larger.
ANT_CON_STRIDE = 29
ANT_SCRATCH_FLOATS = 13 * 8 * 9 + 13 * 18
ANT_MAX_GROUPS = 8          # kMaxThreads / ANT_LANES
# The H100's shared memory: a block may use 227 KB; an SM holds 228 KB, of
# which each resident block takes 1 KB for the system.
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_BLOCK_RESERVED = 1024
# Threads per block of the generic engine kernel: one thread per env, and
# 4096 envs in blocks of 32 spread over 128 of the H100's 132 SMs (32, 64
# and 128 timed alike once, PERF.md).
ENGINE_BLOCK = 32


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


class ObjParams(ctypes.Structure):
    """The scalars of one Point object world, passed by value (mirrors
    ``struct ObjParams`` in ``csrc/point_objects.cuh``, field for field)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "nd", "n_walls", "n_balls", "n_blocks", "newton_iters", "ls_iters",
        "max_rows", "off_walls", "off_ball", "off_blocks", "block_stride",
        "n_table", "trace_words", "head_obj",
    )] + [(name, ctypes.c_float) for name in (
        "h", "ah_half", "bw16", "bw13",
        "mu", "sphere_r", "sphere_z", "arrow_off", "hl", "hw", "hz_arrow",
        "az_c", "floor_pen", "inv101",
    )]


def obj_params(ks: PointKernelSpec) -> ObjParams:
    """The struct of an object world: each constant the float32 value the
    plain version (``object_lanes``) uses."""
    from .point_kernel import object_table

    o = ks.object_spec
    F = object_lanes.F
    _, off_walls, off_ball, off_blocks, stride = object_table(
        o, ks.object_dof_idx, ks.head_base, ks.head_dof)
    h = F(o.dt)
    return ObjParams(
        nd=o.nd, n_walls=o.wb_c.shape[0], n_balls=len(o.balls),
        n_blocks=len(o.blocks), newton_iters=o.newton_iters,
        ls_iters=o.ls_iters, max_rows=ks.max_rows, off_walls=off_walls,
        off_ball=off_ball, off_blocks=off_blocks, block_stride=stride,
        n_table=ks.obj_table.numel(), trace_words=trace_words(ks),
        head_obj=int(ks.obs_offset == 3),
        h=h, ah_half=F(np.float32(0.5) * np.float32(h)), bw16=F(1.0 / 6.0),
        bw13=F(1.0 / 3.0), mu=F(o.mu), sphere_r=F(o.sphere_r),
        sphere_z=F(o.sphere_z), arrow_off=F(o.arrow_off),
        hl=F(o.arrow_half_l), hw=F(o.arrow_half_w),
        hz_arrow=F(0.5 * (o.arrow_z_hi - o.arrow_z_lo)),
        az_c=F(0.5 * (o.arrow_z_lo + o.arrow_z_hi)),
        floor_pen=F(object_lanes.FLOOR_PEN), inv101=object_lanes.R(1.01),
    )


class QuasiParams(ctypes.Structure):
    """The counts of one object world without the object solve, passed by
    value (mirrors ``struct QuasiParams`` in ``csrc/point_lane.cu``)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_blocks", "n_balls", "n_walls", "n_world", "n_table", "head_obj")]


def quasi_params(ks: PointKernelSpec) -> QuasiParams:
    n_blocks, n_balls, n_walls = ks.quasi_counts
    return QuasiParams(
        n_blocks=n_blocks, n_balls=n_balls, n_walls=n_walls,
        n_world=ks.n_world, n_table=ks.quasi_table.numel(),
        head_obj=int(ks.obs_offset == 3))


def trace_words(ks: PointKernelSpec) -> int:
    """32-bit words of one forward evaluation's active-row bit set."""
    return (ks.max_rows + 31) // 32


# Floats a row keeps in the object kernels' scratch: J (6), aref, rinv,
# J x - aref and J p of the current Newton step (kRowFields in
# csrc/point_objects.cuh).
OBJ_ROW_FIELDS = 10


class AntParams(ctypes.Structure):
    """The scalars of one Ant maze, passed by value (mirrors ``struct
    AntParams`` in ``csrc/ant_lane.cuh``, field for field)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "off_body", "off_dof", "off_act", "off_sph", "off_box", "off_goal",
        "off_qpos0", "off_wdof", "off_blk", "off_plat", "off_qpair",
        "off_ball", "off_bpair",
        "n_floats", "n_sph", "n_box", "n_goal", "n_w", "n_blk", "n_ball",
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
        off_ball=o["ball"][0], off_bpair=o["bpair"][0],
        n_floats=ks.packed.numel(),
        n_sph=o["sph"][1], n_box=o["box"][1], n_goal=o["goals"][1],
        n_w=ks.n_w, n_blk=ks.n_blk, n_ball=ks.n_ball,
        frame_skip=ks.frame_skip,
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


class SwimmerParams(ctypes.Structure):
    """The constants of one swimmer-family maze, passed by value (mirrors
    ``struct SwimmerParams`` in ``csrc/swimmer_lane.cu``, field for
    field)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "mass", "iz", "armature", "gear",
        "kv_f", "kv_t", "kq_fx", "kq_fy", "kq_t",
        "lim_lo", "lim_hi", "lim_b", "lim_d0", "lim_dd",
        "lim_inv_width", "lim_inv_kden",
        "h", "h_half", "inv6",
        "inv_dt", "ctrl_weight", "inner_scale",
        "penalty", "inv_scale",
    )] + [(name, ctypes.c_int) for name in (
        "frame_skip", "reward_type", "episode_limit")]


def swimmer_params(ks: SwimmerKernelSpec) -> SwimmerParams:
    """The struct of ``ks``: each constant the Python double that the plain
    version (``swimmer_math``, ``models/swimmer.py``) hands to PyTorch,
    which rounds it once to float32, as ``ctypes`` does here."""
    d = ks.dyn
    robot = ks.env_spec.robot
    return SwimmerParams(
        mass=d.mass, iz=d.inertia_z, armature=d.armature, gear=d.gear,
        kv_f=d.kv_f, kv_t=d.kv_t, kq_fx=d.kq_fx, kq_fy=d.kq_fy, kq_t=d.kq_t,
        lim_lo=d.limit_lo, lim_hi=d.limit_hi, lim_b=d.lim_b,
        lim_d0=LIMIT_D0, lim_dd=LIMIT_DMAX - LIMIT_D0,
        lim_inv_width=1.0 / LIMIT_WIDTH, lim_inv_kden=d.lim_inv_kden,
        h=d.timestep, h_half=d.timestep / 2, inv6=1.0 / 6.0,
        inv_dt=1.0 / robot.dt, ctrl_weight=robot.CTRL_COST_WEIGHT,
        inner_scale=ks.inner_scale, penalty=ks.penalty,
        inv_scale=float(np.float32(1.0) / np.float32(ks.scale)),
        frame_skip=ks.frame_skip, reward_type=REWARD_TYPES[ks.reward_type],
        episode_limit=ks.episode_limit,
    )


class EngineParams(ctypes.Structure):
    """The scalars of one engine world, passed by value (mirrors ``struct
    EngineParams`` in ``csrc/engine_lane.cuh``, field for field)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "off_body", "off_jnt", "off_dof", "off_act", "off_sph", "off_box",
        "off_dbox", "off_spair", "off_pair", "off_fall", "off_plat",
        "off_goal", "n_floats", "nb", "nj", "nq", "nv", "nu", "n_sph",
        "n_box", "n_spair", "n_pair", "n_fall", "n_goal", "has_floor",
        "n_static", "n_pick", "n_cand", "row_floats", "trace_words", "frame_skip", "solver_iters",
        "reward_type", "head_q0", "head_q1", "head_q2",
        "visc_on", "rho_on",
    )] + [(name, ctypes.c_float) for name in (
        "h", "h_half", "dt_outer", "gx", "gy", "gz", "floor_z",
        "fwd_weight", "ctrl_weight", "inner_scale", "penalty", "inv_scale",
        "head_b0", "head_b1", "head_b2",
        "lim_b", "lim_d0", "lim_dd", "lim_width", "lim_kden", "omega",
        "sup_kc", "sup_bc", "sup_kl_den", "sup_bl",
    )]


def engine_params(ks: EngineKernelSpec) -> EngineParams:
    """The struct of ``ks``: constants computed as the engine computes them
    (Python double, rounded once to float32)."""
    o = ks.offsets
    model = ks.env_spec.dynamic_model
    cs = ks.env_spec.contact_set
    tc = max(0.02, 2.0 * ks.timestep)
    d0, dmax, width = 0.9, 0.95, 0.001
    gx, gy, gz = (float(g) for g in model.gravity)
    return EngineParams(
        **{f"off_{name}": o[name][0] for name in o},
        n_floats=ks.packed.numel(),
        nb=o["body"][1], nj=o["jnt"][1], nq=ks.nq, nv=ks.nv, nu=ks.nu,
        n_sph=o["sph"][1], n_box=o["box"][1], n_spair=o["spair"][1],
        n_pair=o["pair"][1],
        n_fall=o["fall"][1], n_goal=o["goal"][1],
        has_floor=int(cs.has_floor), n_static=ks.n_static,
        n_pick=min(o["box"][1], 2), n_cand=ks.n_cand,
        row_floats=row_floats(ks.nv), trace_words=ks.trace_words,
        frame_skip=ks.frame_skip, solver_iters=ks.solver_iters,
        reward_type=REWARD_TYPES[ks.reward_type],
        head_q0=ks.head_qadr[0], head_q1=ks.head_qadr[1],
        head_q2=ks.head_qadr[2],
        visc_on=int(model.viscosity > 0), rho_on=int(model.fluid_density > 0),
        h=ks.timestep, h_half=float(np.float32(np.float32(ks.timestep) / 2)),
        dt_outer=ks.dt_outer, gx=gx, gy=gy, gz=gz, floor_z=float(cs.floor_z),
        fwd_weight=ks.fwd_weight, ctrl_weight=ks.ctrl_cost,
        inner_scale=ks.inner_scale, penalty=ks.penalty,
        inv_scale=float(np.float32(1.0) / np.float32(ks.scale)),
        head_b0=ks.head_base[0], head_b1=ks.head_base[1],
        head_b2=ks.head_base[2],
        lim_b=2.0 / (dmax * tc), lim_d0=d0, lim_dd=dmax - d0,
        lim_width=width, lim_kden=dmax * dmax * tc * tc, omega=0.6,
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
    lib.mmt_point_obj_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward, terminated
        _P, _I, _P, _I,                  # walls, W, goals, G
        PointParams, _P, ObjParams,      # params, object table, its params
        _P, _P, _I, _P]                  # row scratch, trace (nullable), B,
                                         # stream
    lib.mmt_point_obj_step.restype = _I
    lib.mmt_point_obj_rollout.argtypes = [
        _P, _P, _P, _I, _I,              # qpos, qvel, t + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward sum, episodes
        _P, _I, _P, _I,                  # walls, W, goals, G
        PointParams, _P, ObjParams, _P,  # params, object table, its params,
                                         # row scratch
        _I, _I, ctypes.c_uint, _P]       # B, steps, seed, stream
    lib.mmt_point_obj_rollout.restype = _I
    lib.mmt_point_quasi_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward, terminated
        _P, _I, _P, _I,                  # walls, W, goals, G
        PointParams, _P, QuasiParams,    # params, quasi table, its counts
        _I, _P]                          # B, stream
    lib.mmt_point_quasi_step.restype = _I
    lib.mmt_point_quasi_rollout.argtypes = [
        _P, _P, _P, _I, _I,              # qpos, qvel, t + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward sum, episodes
        _P, _I, _P, _I,                  # walls, W, goals, G
        PointParams, _P, QuasiParams,    # params, quasi table, its counts
        _I, _I, ctypes.c_uint, _P]       # B, steps, seed, stream
    lib.mmt_point_quasi_rollout.restype = _I
    lib.mmt_ant_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P, _P, _P,      # qpos', qvel', t', reward, terminated,
                                         # active contacts, trace (nullable)
        _P, AntParams, _I, _I, _I, _P]   # tables, params, B, groups a block,
                                         # shared bytes, stream
    lib.mmt_ant_step.restype = _I
    lib.mmt_ant_rollout.argtypes = [
        _P, _P, _P, _I, _I,              # qpos, qvel, t + row strides
        _P, _P, _P, _P, _P, _P,          # qpos', qvel', t', reward sum,
                                         # episodes, active contacts (nullable)
        _P, AntParams, _I, _I, ctypes.c_uint, _I, _I, _P]
        # tables, params, B, steps, seed, groups a block, shared bytes, stream
    lib.mmt_ant_rollout.restype = _I
    lib.mmt_swimmer_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward, terminated
        _P, _I, SwimmerParams,           # goals, G, params
        _I, _I, _I, _P]                  # links, world dofs, B, stream
    lib.mmt_swimmer_step.restype = _I
    lib.mmt_swimmer_rollout.argtypes = [
        _P, _P, _P, _I, _I,              # qpos, qvel, t + row strides
        _P, _P, _P, _P, _P,              # qpos', qvel', t', reward sum, episodes
        _P, _I, SwimmerParams,           # goals, G, params
        _I, _I, _I, _I, ctypes.c_uint, _P]
        # links, world dofs, B, steps, seed, stream
    lib.mmt_swimmer_rollout.restype = _I
    lib.mmt_engine_step.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,      # qpos, qvel, t, act + row strides
        _P, _P, _P, _P, _P, _P, _P,      # qpos', qvel', t', reward, terminated,
                                         # active contacts, trace (nullable)
        _P, _P, EngineParams, _I, _I, _P]  # scratch, tables, params, B,
                                           # block, stream
    lib.mmt_engine_step.restype = _I
    lib.mmt_engine_caps.argtypes = [_P]
    lib.mmt_engine_caps.restype = None
    lib.mmt_ant_max_world_dofs.restype = _I
    lib.mmt_ant_max_blocks.restype = _I
    lib.mmt_ant_max_balls.restype = _I
    lib.mmt_ant_lanes.restype = _I
    lib.mmt_ant_blocks_per_sm.argtypes = [AntParams, _I, _I, _I]
    lib.mmt_ant_blocks_per_sm.restype = _I
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


class _ObjScratch:
    """The object kernels' row scratch: ``max_rows x OBJ_ROW_FIELDS`` floats
    per env, allocated with ``torch.empty`` at first use and kept by the
    wrapper (launches on one stream reuse it in turn)."""

    def __init__(self, ks: PointKernelSpec, num_envs: int) -> None:
        self.params = obj_params(ks)
        self.numel = max(ks.max_rows, 1) * OBJ_ROW_FIELDS * num_envs
        self.buf = None

    def get(self, dev: torch.device) -> torch.Tensor:
        if self.buf is None or self.buf.device != dev:
            self.buf = torch.empty(self.numel, dtype=torch.float32, device=dev)
        return self.buf


class PointStep:
    """``step(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one Point step with explicit actions and no reset (the
    counterpart of ``LaneEnvKernel.build_step``).  In an object world
    ``qpos``/``qvel`` are ``(B, 3 + n_world)`` and the objects' RK4 step
    runs inside the kernel (the reduced object solve, or, for a Point
    robot without ``USES_POINT_WORLD``, the quasi-static rows);
    ``trace=True`` (CUDA, object-solve worlds) adds each env's active
    candidate rows per forward evaluation, ``(B, 4, trace_words)`` int32
    bit sets in ``object_lanes`` row order."""

    def __init__(self, ks: PointKernelSpec, num_envs: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.params = point_params(ks)
        self.scratch = (_ObjScratch(ks, num_envs)
                        if ks.object_spec is not None else None)
        self.quasi = (quasi_params(ks) if ks.quasi_table is not None
                      else None)

    def __call__(self, qpos, qvel, t, actions, trace: bool = False):
        B, dev = self.num_envs, self.ks.walls.device
        nq = 3 + self.ks.n_world
        _check("qpos", qpos, torch.float32, (B, nq), dev)
        _check("qvel", qvel, torch.float32, (B, nq), dev)
        _check("t", t, torch.int32, (B,), dev)
        _check("actions", actions, torch.float32, (B, 2), dev)
        if dev.type == "cpu":
            if trace:
                raise ValueError("active-row traces come from the kernel")
            return point_step_plain(self.ks, qpos, qvel, t, actions)
        if dev.type != "cuda":
            raise RuntimeError(f"no Point step kernel for device {dev}")
        q_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        reward = torch.empty((B,), dtype=torch.float32, device=dev)
        term = torch.empty((B,), dtype=torch.bool, device=dev)
        outs = (q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
                reward.data_ptr(), term.data_ptr())
        ins = (qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(),
               actions.data_ptr(), qpos.stride(0), qvel.stride(0),
               actions.stride(0))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if self.quasi is not None:
            if trace:
                raise ValueError("the quasi-static rows have no trace")
            rc = _lib().mmt_point_quasi_step(
                *ins, *outs, *_tables(self.ks), self.params,
                self.ks.quasi_table.data_ptr(), self.quasi, B, stream)
            name = "point_quasi_step"
        elif self.scratch is None:
            if trace:
                raise ValueError("a plain maze has no object rows to trace")
            rc = _lib().mmt_point_step(*ins, *outs, *_tables(self.ks),
                                       self.params, B, stream)
            name = "point_step"
        else:
            tr = (torch.zeros((B, 4, trace_words(self.ks)), dtype=torch.int32,
                              device=dev) if trace else None)
            rc = _lib().mmt_point_obj_step(
                *ins, *outs, *_tables(self.ks), self.params,
                self.ks.obj_table.data_ptr(), self.scratch.params,
                self.scratch.get(dev).data_ptr(),
                None if tr is None else tr.data_ptr(), B, stream)
            name = "point_objects_step"
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        out = (q_out, v_out, t_out, reward, term)
        return out + (tr,) if trace else out


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
        self.scratch = (_ObjScratch(ks, num_envs)
                        if ks.object_spec is not None else None)
        self.quasi = (quasi_params(ks) if ks.quasi_table is not None
                      else None)

    def per_env(self, qpos, qvel, t, seed: int) -> Tensors5:
        """The rollout with per-env reward sums ``(B,)`` float32 and
        episode counts ``(B,)`` int32."""
        B, dev = self.num_envs, self.ks.walls.device
        nq = 3 + self.ks.n_world
        _check("qpos", qpos, torch.float32, (B, nq), dev)
        _check("qvel", qvel, torch.float32, (B, nq), dev)
        _check("t", t, torch.int32, (B,), dev)
        seed = int(seed)
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must fit in 32 bits, got {seed}")
        if dev.type == "cpu":
            return point_rollout_plain(self.ks, qpos, qvel, t, seed,
                                       self.num_steps)
        if dev.type != "cuda":
            raise RuntimeError(f"no Point rollout kernel for device {dev}")
        q_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        rew = torch.empty((B,), dtype=torch.float32, device=dev)
        eps = torch.empty((B,), dtype=torch.int32, device=dev)
        ins = (qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(),
               qpos.stride(0), qvel.stride(0),
               q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
               rew.data_ptr(), eps.data_ptr(), *_tables(self.ks), self.params)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if self.quasi is not None:
            rc = _lib().mmt_point_quasi_rollout(
                *ins, self.ks.quasi_table.data_ptr(), self.quasi, B,
                self.num_steps, seed, stream)
            name = "point_quasi_rollout"
        elif self.scratch is None:
            rc = _lib().mmt_point_rollout(*ins, B, self.num_steps, seed,
                                          stream)
            name = "point_rollout"
        else:
            rc = _lib().mmt_point_obj_rollout(
                *ins, self.ks.obj_table.data_ptr(), self.scratch.params,
                self.scratch.get(dev).data_ptr(), B, self.num_steps, seed,
                stream)
            name = "point_objects_rollout"
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        return q_out, v_out, t_out, rew, eps

    def __call__(self, qpos, qvel, t, seed: int) -> Tensors5:
        q, v, tt, rew, eps = self.per_env(qpos, qvel, t, seed)
        return q, v, tt, torch.sum(rew), torch.sum(eps)


# Words per forward evaluation of the step kernel's trace (kTraceWords in
# csrc/ant_lane.cuh; ``ant_kernel.active_trace`` lays out the plain
# version's alike).
ANT_TRACE_WORDS = 25


def _ant_dims(ks: AntKernelSpec):
    """(nq, nv) of ``ks``: the ant's 15 / 14, the slide dofs, and a free
    ball's 7 / 6."""
    nv = NV_ANT + ks.n_w + 6 * ks.n_ball
    return nv + 1 + ks.n_ball, nv


@functools.lru_cache(maxsize=None)
def _ant_caps() -> Dict[str, int]:
    """The library's compile-time bounds of the Ant kernels, and the lanes
    of a group, asked once."""
    lib = _lib()
    return {"world_dofs": lib.mmt_ant_max_world_dofs(),
            "blocks": lib.mmt_ant_max_blocks(),
            "balls": lib.mmt_ant_max_balls(), "lanes": lib.mmt_ant_lanes()}


def _check_ant_bounds(ks: AntKernelSpec) -> None:
    """Refuse a world beyond the library's compile-time bounds: the block
    worlds' slides and blocks, or one ball in a world without them."""
    caps = _ant_caps()
    if (ks.n_w > caps["world_dofs"] or ks.n_blk > caps["blocks"]
            or ks.n_ball > caps["balls"]
            or ks.n_ball and (ks.n_w or ks.n_blk)):
        raise NotImplementedError(
            f"{ks.n_blk} blocks with {ks.n_w} world dofs and {ks.n_ball} "
            "balls exceed the Ant kernels' bounds")
    if caps["lanes"] != ANT_LANES:
        raise RuntimeError(f"the Ant kernels step an env with "
                           f"{caps['lanes']} lanes, not {ANT_LANES}")


def _ant_kernel_name(ks: AntKernelSpec, kind: str) -> str:
    """The ``LAUNCHES`` key of the instantiation that runs ``ks``."""
    world = "_balls" if ks.n_ball else "_blocks" if ks.n_w else ""
    return f"ant{world}_{kind}"


def ant_group_floats(n_w: int, n_blk: int, n_ball: int) -> int:
    """Floats of one group's state (``group_floats`` in
    csrc/ant_lane.cuh) for an instantiation's maxima of world dofs, blocks
    and balls: the poses and velocities, the RK4 stages, the force
    vectors, the actuation, the body poses, M and M^-1, the world
    inertias, the blocks' boxes, the ball's tree and block (or a stand-in)
    and the rollout's reset words."""
    nv = NV_ANT + n_w + 6 * n_ball
    nq = nv + 1 + n_ball
    kin = 13 * 9 + 2 * 13 * 3 + 2 * NV_ANT * 3
    return (2 * nq + 14 * nv + 8 + kin + 2 * NV_ANT * NV_ANT + 13 * 9
            + 6 * max(n_blk, 1) + (89 + 36 if n_ball else 1) + 44)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def ant_slots(ks: AntKernelSpec) -> int:
    """Candidate contacts of ``ks``: each test sphere's floor, two static
    box picks, blocks and ball, then the ball's floor and two box picks."""
    return (ks.offsets["sph"][1] * (3 + ks.n_blk + ks.n_ball)
            + 3 * ks.n_ball)


class AntGeometry(NamedTuple):
    """The launch of the Ant kernels on ``ks``."""

    groups: int          # envs a block, one group of ANT_LANES lanes each
    threads: int         # threads a block
    smem_bytes: int      # dynamic shared memory a block
    slots: int           # contact slots of a group
    groups_per_sm: int   # groups an SM's shared memory holds at once


def ant_geometry(ks: AntKernelSpec, groups: Optional[int] = None
                 ) -> AntGeometry:
    """The block shape of the Ant kernels on ``ks`` (``ant_smem_bytes`` in
    csrc/ant_lane.cuh computes the same bytes and refuses any other):
    ``groups`` envs a block, or by default the power of two up to
    ANT_MAX_GROUPS that lets an SM's shared memory hold the most groups
    (the fewest on ties: more blocks spread over more SMs)."""
    w, nb = (MAX_WORLD_DOFS, MAX_BLOCKS) if ks.n_w else (0, 0)
    slots = ant_slots(ks)
    nv = NV_ANT + w + 6 * ks.n_ball
    region = slots * (ANT_CON_STRIDE + 1) + ANT_LANES * (nv + 1)
    per_group = (_round4(ant_group_floats(w, nb, ks.n_ball))
                 + _round4(max(region, ANT_SCRATCH_FLOATS)))
    tables = _round4(ks.packed.numel())

    def shape(g: int) -> AntGeometry:
        smem = 4 * (tables + g * per_group)
        return AntGeometry(g, g * ANT_LANES, smem, slots,
                           g * (SMEM_SM // (smem + SMEM_BLOCK_RESERVED)))

    if groups is not None:
        if not 1 <= groups <= ANT_MAX_GROUPS:
            raise ValueError(f"groups must be in [1, {ANT_MAX_GROUPS}], "
                             f"got {groups}")
        geo = shape(groups)
    else:
        fits = [shape(g) for g in (1, 2, 4, 8, 16)
                if g <= ANT_MAX_GROUPS and shape(g).smem_bytes <= SMEM_BLOCK_MAX]
        geo = max(fits, key=lambda x: (x.groups_per_sm, -x.groups))
    if geo.smem_bytes > SMEM_BLOCK_MAX:
        raise NotImplementedError(
            f"the Ant kernels need {geo.smem_bytes} bytes of shared memory "
            f"a block at {geo.groups} groups, above {SMEM_BLOCK_MAX}")
    return geo


def ant_resident_warps(ks: AntKernelSpec) -> Dict[str, int]:
    """Warps (envs) an SM holds at once for the Ant step and rollout
    kernels at ``ant_geometry(ks)``, registers and shared memory counted
    (CUDA's occupancy calculator on the built kernels; the card only)."""
    geo = ant_geometry(ks)
    lib, p = _lib(), ant_params(ks)
    out = {}
    for kind, rollout in (("step", 0), ("rollout", 1)):
        blocks = lib.mmt_ant_blocks_per_sm(p, geo.groups, geo.smem_bytes,
                                           rollout)
        if blocks < 0:
            raise RuntimeError(f"the occupancy query of the Ant {kind} "
                               "kernel failed")
        out[kind] = blocks * geo.groups
    return out


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
        self.groups = ant_geometry(ks).groups   # envs a block
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
        geo = ant_geometry(self.ks, self.groups)
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
            self.ks.packed.data_ptr(), self.params, B, geo.groups,
            geo.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
        name = _ant_kernel_name(self.ks, "step")
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        out = (q_out, v_out, t_out, reward, term)
        if count_active:
            out = out + (active,)
        return out + (tr,) if trace else out


class AntRollout:
    """``rollout(qpos, qvel, t, seed) -> (qpos', qvel', t', reward_sum,
    episodes)``: the fused random-policy rollout of the Ant with
    auto-reset (ctrl U(±30); reset: the ant's qpos0 + U(±0.1), quaternion
    renormalised, its qvel 0.1 N(0, 1); the world dofs, a ball's
    quaternion among them, back to qpos0 at rest)."""

    def __init__(self, ks: AntKernelSpec, num_envs: int,
                 num_steps: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.num_steps = num_steps
        self.groups = ant_geometry(ks).groups   # envs a block
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
        geo = ant_geometry(self.ks, self.groups)
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
            geo.groups, geo.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
        name = _ant_kernel_name(self.ks, "rollout")
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        out = (q_out, v_out, t_out, rew, eps)
        return out + (active,) if count_active else out

    def __call__(self, qpos, qvel, t, seed: int) -> Tensors5:
        q, v, tt, rew, eps = self.per_env(qpos, qvel, t, seed)
        return q, v, tt, torch.sum(rew), torch.sum(eps)


def _swimmer_dims(ks: SwimmerKernelSpec):
    """(nq, n_act) of ``ks``: the robot's coordinates and world dofs."""
    return 2 + ks.dyn.n_links + ks.n_world, ks.dyn.n_act


class SwimmerStep:
    """``step(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one Swimmer or Reacher step with explicit actions and
    no reset."""

    def __init__(self, ks: SwimmerKernelSpec, num_envs: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.params = swimmer_params(ks)

    def __call__(self, qpos, qvel, t, actions) -> Tensors5:
        B, dev = self.num_envs, self.ks.goals.device
        nq, nu = _swimmer_dims(self.ks)
        _check("qpos", qpos, torch.float32, (B, nq), dev)
        _check("qvel", qvel, torch.float32, (B, nq), dev)
        _check("t", t, torch.int32, (B,), dev)
        _check("actions", actions, torch.float32, (B, nu), dev)
        if dev.type == "cpu":
            return swimmer_step_plain(self.ks, qpos, qvel, t, actions)
        if dev.type != "cuda":
            raise RuntimeError(f"no swimmer step kernel for device {dev}")
        q_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        reward = torch.empty((B,), dtype=torch.float32, device=dev)
        term = torch.empty((B,), dtype=torch.bool, device=dev)
        rc = _lib().mmt_swimmer_step(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(), actions.data_ptr(),
            qpos.stride(0), qvel.stride(0), actions.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            reward.data_ptr(), term.data_ptr(), self.ks.goals.data_ptr(),
            self.ks.goals.shape[0], self.params, self.ks.dyn.n_links,
            self.ks.n_world, B, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "swimmer_step")
        LAUNCHES["swimmer_step"] += 1
        return q_out, v_out, t_out, reward, term


class SwimmerRollout:
    """``rollout(qpos, qvel, t, seed) -> (qpos', qvel', t', reward_sum,
    episodes)``: the fused random-policy rollout of the Swimmer or the
    Reacher with auto-reset (ctrl U(±1); reset: U(±0.1) on every qpos and
    qvel, world dofs included)."""

    def __init__(self, ks: SwimmerKernelSpec, num_envs: int,
                 num_steps: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.num_steps = num_steps
        self.params = swimmer_params(ks)

    def per_env(self, qpos, qvel, t, seed: int) -> Tensors5:
        """The rollout with per-env reward sums ``(B,)`` float32 and
        episode counts ``(B,)`` int32."""
        B, dev = self.num_envs, self.ks.goals.device
        nq, _ = _swimmer_dims(self.ks)
        _check("qpos", qpos, torch.float32, (B, nq), dev)
        _check("qvel", qvel, torch.float32, (B, nq), dev)
        _check("t", t, torch.int32, (B,), dev)
        seed = int(seed)
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must fit in 32 bits, got {seed}")
        if dev.type == "cpu":
            return swimmer_rollout_plain(self.ks, qpos, qvel, t, seed,
                                         self.num_steps)
        if dev.type != "cuda":
            raise RuntimeError(f"no swimmer rollout kernel for device {dev}")
        q_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, nq), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        rew = torch.empty((B,), dtype=torch.float32, device=dev)
        eps = torch.empty((B,), dtype=torch.int32, device=dev)
        rc = _lib().mmt_swimmer_rollout(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(),
            qpos.stride(0), qvel.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            rew.data_ptr(), eps.data_ptr(), self.ks.goals.data_ptr(),
            self.ks.goals.shape[0], self.params, self.ks.dyn.n_links,
            self.ks.n_world, B, self.num_steps, seed,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "swimmer_rollout")
        LAUNCHES["swimmer_rollout"] += 1
        return q_out, v_out, t_out, rew, eps

    def __call__(self, qpos, qvel, t, seed: int) -> Tensors5:
        q, v, tt, rew, eps = self.per_env(qpos, qvel, t, seed)
        return q, v, tt, torch.sum(rew), torch.sum(eps)


def engine_caps() -> Dict[str, int]:
    """The generic engine kernel's compile-time caps (``mmt_engine_caps``)."""
    out = (ctypes.c_int * 5)()
    _lib().mmt_engine_caps(out)
    return dict(zip(("bodies", "nv", "nq", "nu", "table_floats"), out))


def _check_engine_caps(ks: EngineKernelSpec) -> None:
    """Refuse a world beyond the engine kernel's compile-time caps."""
    caps = engine_caps()
    have = {"bodies": ks.offsets["body"][1], "nv": ks.nv, "nq": ks.nq,
            "nu": ks.nu, "table_floats": ks.packed.numel()}
    over = {k: (n, caps[k]) for k, n in have.items() if n > caps[k]}
    if over:
        raise NotImplementedError(
            "the model exceeds the generic engine kernel's caps "
            + ", ".join(f"{k} {n} > {c}" for k, (n, c) in over.items()))


class EngineStep:
    """``step(qpos, qvel, t, actions) -> (qpos', qvel', t', reward,
    terminated)``: one step of an engine-world robot with explicit actions
    and no reset (the generic kernel is step-only, as in the JAX package).

    The wrapper owns the contact scratch: ``max(n_cand, 1) x row_floats``
    floats per env, allocated with ``torch.empty`` at first use (launches
    on one stream reuse it in turn).  ``count_active=True`` (CUDA only)
    adds a sixth output, each env's active contacts summed over the
    step's forward evaluations; ``trace=True`` (CUDA only) adds, last, the
    active sets per forward evaluation, ``(B, 4 * frame_skip,
    trace_words)`` int32 (``engine_kernel.active_trace`` lays the plain
    version's out alike)."""

    def __init__(self, ks: EngineKernelSpec, num_envs: int) -> None:
        self.ks = ks
        self.num_envs = num_envs
        self.params = engine_params(ks)
        self.scratch = None

    def _scratch(self, dev: torch.device) -> torch.Tensor:
        n = max(self.ks.n_cand, 1) * row_floats(self.ks.nv) * self.num_envs
        if self.scratch is None or self.scratch.device != dev:
            self.scratch = torch.empty(n, dtype=torch.float32, device=dev)
        return self.scratch

    def __call__(self, qpos, qvel, t, actions, count_active: bool = False,
                 trace: bool = False):
        ks, B = self.ks, self.num_envs
        dev = ks.packed.device
        _check("qpos", qpos, torch.float32, (B, ks.nq), dev)
        _check("qvel", qvel, torch.float32, (B, ks.nv), dev)
        _check("t", t, torch.int32, (B,), dev)
        _check("actions", actions, torch.float32, (B, ks.nu), dev)
        if dev.type == "cpu":
            if count_active or trace:
                raise ValueError("active-contact counts and traces come from "
                                 "the kernel")
            return engine_step_plain(ks, qpos, qvel, t, actions)
        if dev.type != "cuda":
            raise RuntimeError(f"no engine step kernel for device {dev}")
        _check_engine_caps(ks)
        q_out = torch.empty((B, ks.nq), dtype=torch.float32, device=dev)
        v_out = torch.empty((B, ks.nv), dtype=torch.float32, device=dev)
        t_out = torch.empty((B,), dtype=torch.int32, device=dev)
        reward = torch.empty((B,), dtype=torch.float32, device=dev)
        term = torch.empty((B,), dtype=torch.bool, device=dev)
        active = (torch.empty((B,), dtype=torch.int32, device=dev)
                  if count_active else None)
        tr = (torch.empty((B, 4 * ks.frame_skip, ks.trace_words),
                          dtype=torch.int32, device=dev) if trace else None)
        rc = _lib().mmt_engine_step(
            qpos.data_ptr(), qvel.data_ptr(), t.data_ptr(), actions.data_ptr(),
            qpos.stride(0), qvel.stride(0), actions.stride(0),
            q_out.data_ptr(), v_out.data_ptr(), t_out.data_ptr(),
            reward.data_ptr(), term.data_ptr(),
            None if active is None else active.data_ptr(),
            None if tr is None else tr.data_ptr(),
            self._scratch(dev).data_ptr(), ks.packed.data_ptr(), self.params,
            B, ENGINE_BLOCK, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(rc, "engine_step")
        LAUNCHES["engine_step"] += 1
        out = (q_out, v_out, t_out, reward, term)
        if count_active:
            out = out + (active,)
        return out + (tr,) if trace else out
