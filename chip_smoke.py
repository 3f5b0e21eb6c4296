"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mujoco_maze_tpu_torch/csrc`` (one ``nvcc``
per source, all started together, then one link), holds each kernel
against its plain PyTorch version, drives the port's main paths —
``make_batched(id, 4096)`` for PointUMaze-v0, AntUMaze-v0, AntPush-v0,
AntFall-v0, SwimmerUMaze-v0, PointPush-v0 and AntSmallBilliard-v0, the
custom robot of ``make_roller_umaze(4096)``, the same robot in the
SmallBilliard task with its free object ball, and a Point robot without
the object solve in PointPush-v0 and PointBilliard-v0, each stepped
through the public API,
``rollout_metrics``, and the fused random-policy rollout — counts the
kernel launches of each path, and times them with CUDA events; and
measures the card's fp32 peak with its own kernel.

Phases (each fails the run on its own; nothing is caught):

1. build, the card's name and power limit, and full-precision float32
   products (TF32 off) for the engine;
2. the step kernel against its plain version on PointUMaze-v0,
   PointUMaze-v1 and Point4Rooms-v2, at 4096 envs over 1000 steps with
   auto-reset, teacher-forced (both start every step from the same state);
3. the rollout kernel against its plain version (the same Philox stream),
   4096 envs, 64 steps, one seed, from step counts spread over the last 64
   steps of an episode so that every env resets inside the window;
4. the main path at 4096 envs, 1000 steps per path, with the launch
   counts set to 0 just before it and read just after, and checks of what
   comes out; then each kernel's time per launch, its plain version's,
   and the least time the card could take for the same work; the timed
   1000-step plain rollout is held against the kernel's on the same state
   and seed;
5. the Ant step kernel against its plain version (the batched engine) on
   AntUMaze-v0, AntUMaze-v1 and Ant4Rooms-v0 at 4096 envs, teacher-forced
   for at least 32 steps from states that put feet on the floor and legs
   against walls, with t spread over the episode; for the envs whose qpos
   error passes 1e-4, both versions' active contact and limit sets at the
   first step where it does;
6. the Ant rollout kernel against its plain version (the same Philox
   stream), 8 steps from t spread over [992, 1000): every env resets;
7. the Ant main path at 4096 envs, 1000 steps per path, counted and timed
   as in phase 4, with checks of what comes out;
8. each Ant kernel's time per launch by envs a block (one warp each),
   device time, bound and plain time;
9. the block-world step kernel against its plain version on AntPush-v0,
   AntFall-v0, AntPushMaze-v0 (three blocks, six world dofs) and
   AntBlockCarry-v0 (the heads on the block) at 4096 envs, teacher-forced
   for 16 steps from states with legs on block faces, blocks at and
   beyond their travel limits, the Fall block perched or over the chasm,
   and t spread over the episode; the active sets of the worst envs as in
   phase 5;
10. the block-world rollout kernel against its plain version on AntPush-v0
    and AntFall-v0, as phase 6, from reset states, with the world dofs of
    the envs reset on the last step back at qpos0, at rest;
11. the Fall mechanic through the kernel: the block perches, and drops
    flush over the chasm;
12. the block-world main paths, AntPush-v0 and AntFall-v0, as phases 7-8;
13. the swimmer step kernel against its plain version (the closed form) on
    SwimmerUMaze-v0, SwimmerUMaze-v1, ReacherUMaze-v0 and SwimmerFall-v0
    (a world dof, the heads' z against θ) at 4096 envs, teacher-forced
    over a 1000-step trajectory of the public step API with auto-reset,
    from t spread over the episode and some envs started on the goal;
    at four of those steps also through the env's own 4096-env wrapper on
    the step API's live states and on copies with wider rows;
14. the swimmer rollout kernel against its plain version (the same Philox
    stream) on SwimmerUMaze-v0 and SwimmerPush-v0, 64 steps from t spread
    over [936, 1000): equal episode counts, every reset draw exact, world
    dofs included;
15. the swimmer main path, SwimmerUMaze-v0 at 4096 envs, counted, timed
    and checked as in phase 4, with each swimmer kernel's numbers;
16. the card's fp32 peak measured by the FMA-chain kernel
    (``utils/roofline.py``), checked against its plain version on a small
    array and at the timed launch's chain count, printed beside the data
    sheet's 67e12;
17. the Point object-world step kernel against its plain version on
    PointPush-v0, PointBilliard-v0, PointBlockCarry-v0 (the heads on the
    block), PointFall-v0, PointMultiPushSmall-v0 (three blocks, six object
    dofs) and PointPushMaze-v0 (676 candidate rows) at 4096 envs,
    teacher-forced for 8 steps from states with the robot against the
    blocks and balls, blocks at their travel limits, the Fall block
    perched, at the floor or in between, and t spread over the episode:
    the robot's dofs, t and the robot-anchored heads exact, the objects
    within 1e-4 (qpos) and 2e-3 (qvel) but at a named knife edge (a row
    active in one version only), the count of bit-exact env-steps printed;
18. the object-world rollout kernel against its plain version on
    PointPush-v0 and PointBilliard-v0, as phase 3: episode counts, the
    robot's dofs and each reset draw exact, the world dofs of the envs
    that reset on the last step at 0, at rest;
19. the object-world main path, PointPush-v0 at 4096 envs, counted, timed
    and checked as in phase 4; the object kernels' times per launch and
    on the device, their bounds (fp32 operations counted from
    ``ops/object_lanes.py`` at the run's active rows) and plain times, on
    PointPush-v0 and on PointPushMaze-v0.  Phases 17-19 run in a process
    of their own (``python3 chip_smoke.py --point-objects``), with a
    fresh CUDA context and profiler;
20. the generic engine step kernel of custom robots (``engine_step``)
    against its plain version at 4096 envs, teacher-forced: the Roller of
    ``examples/custom_robot.py`` in the UMaze, Push, Fall and BlockCarry
    tasks for 16 steps from states with the roller on the floor, against
    wall and block faces, the blocks at and beyond their travel limits,
    the Fall block perched, over the chasm and between, and t spread over
    the episode (qpos 1e-5, qvel 1e-4, reward 1e-5, t and terminated
    exact; an env-step beyond them recomputed by the plain version on the
    CPU, or else a knife edge named by both versions' traces, or else held
    coordinate by coordinate to its own float32 rounding spread); the Ant
    model's AntUMaze-v0 and AntPush-v0 worlds through the generic kernel
    for 8 steps, as phase 5; a Roller with a ball-jointed arm in a fluid;
    the count of bit-exact env-steps;
21. the custom-robot main path, ``make_roller_umaze(4096)`` through the
    step API and ``rollout_metrics``, 1000 steps each with auto-reset,
    counted and checked (the rollers on the floor, equal episode counts
    on the same seeds); the step API's device idle share; engine_step's
    time per launch, on the device, its bound and its plain version's
    time on RollerUMaze and on the AntUMaze-v0 world, beside the Ant
    kernel's;
22. engine_step against its plain version with free object balls, at
    4096 envs, teacher-forced as in phase 20: the Roller in the
    SmallBilliard task (maze scaling 2.0) for 16 steps from states with
    the ball against the roller, against walls and in corners, spinning,
    or on the goal, and t spread over the episode, at phase 20's bounds
    and rule; the Ant model's AntSmallBilliard-v0 world for 8 steps with
    legs on the ball, as phase 20 holds the Ant worlds; each with the
    count of bit-exact env-steps and the mean active sphere-sphere pair
    rows per forward evaluation;
23. the ball-world main path: the Roller in the SmallBilliard task
    (``MazeEnvSpec`` then ``BatchedMazeEnv(spec, 4096)``) through the step
    API and ``rollout_metrics``, 1000 steps each with auto-reset, counted;
    checked over a third pass (no NaN; at every step at least 99 % of the
    balls' bottoms within (-0.05, 0.5) of the floor and none through it;
    some ball struck; equal episode counts on the same seeds) and against
    the CPU path on a small input; the step API's
    device idle share; engine_step's time per launch, on the device, its
    bound and its plain version's time on that world and on the
    AntSmallBilliard-v0 world.  Phases 20-23 run in a process of their
    own (``python3 chip_smoke.py --engine``, which also runs alone;
    ``python3 chip_smoke.py --engine-faults`` instead plants faults into a
    copy of the kernel's source and checks that phase 20 or 22 fails on
    each);
24. the Ant kernel's ball instantiation (``ant_balls_step``) against its
    plain version (the batched engine) on AntSmallBilliard-v0, -v1 and
    -v2 (three reward heads) at 4096 envs, teacher-forced for 16 steps
    from ``ant_kernel.ball_states`` (legs pressed into the ball, several
    spheres of one capsule at once; the ball against walls and in
    corners, spinning fast, on the goal or at its threshold; the ant
    50-80 m from the ball; t spread over the episode), at phase 9's
    bounds and rule, with the count of bit-exact env-steps and the mean
    active sphere-ball pairs per forward evaluation;
25. the ball rollout kernel (``ant_balls_rollout``) against its plain
    version on AntSmallBilliard-v0 and -v1, as phase 10: the ball of every
    env reset on the last step back at qpos0, at rest;
26. the ball-world main path, AntSmallBilliard-v0 at 4096 envs through the
    step API and ``rollout_metrics`` (1000 steps each from the same seeds)
    and the fused 1000-step rollout, counted; checked over a third pass
    (no NaN; at every step at least 99 % of the balls' bottoms within
    (-0.05, 0.5) of the floor and none through it; some ball struck;
    equal episode counts on the same seeds) and against the CPU path on a
    small input; the step API's device idle share; ``ant_balls_step``'s
    time per launch by envs a block, on the device, its bound (the
    generic kernel's need-based count) and its plain version's time,
    beside the generic engine kernel's on the same states;
    ``ant_balls_rollout``'s.  Phases 24-26 run in a process of their own
    (``python3 chip_smoke.py --ant-balls``, which also runs alone);
27. the Point kernels' quasi-static rows (``point_quasi_step``: a Point
    robot without the object solve, ``USES_POINT_WORLD = False``) against
    their plain version at 4096 envs, teacher-forced for 16 steps from
    ``point_kernel.quasi_states`` (the robot disc on block faces and inside
    blocks, equal exit depths among them, blocks at and past their limits
    and overlapping, the ball on the robot and headed into walls and
    corners) on PointPush-v0, PointMultiPushSmall-v0, PointFall-v0,
    PointBlockCarry-v0 and PointBilliard-v0, every output bit-equal (the
    ``max_abs_err`` of the kernels line is measured on them), with
    the count of env-steps where a block was pushed, a pair separated, a
    ball kicked or bounced; one launch on each of the 27 Point object
    tasks at 256 envs, bit-equal;
28. the quasi rollout kernel against its plain version on PointPush-v0 and
    PointBilliard-v0, as phase 18, every output bit-equal;
29. the quasi main path, ``MazeEnvSpec(QuasiPoint(), task, scaling)`` and
    ``BatchedMazeEnv(spec, 4096)`` on PointPush-v0 and PointBilliard-v0,
    through the step API, ``rollout_metrics`` and the fused rollout,
    counted, timed and checked as phase 19, with the kernels' times, device
    times, bounds (fp32 operations counted from ``csrc/point_lane.cu``) and
    plain times;
30. the float64 Point fidelity path on the card: PointUMaze-v0 and
    PointBilliard-v0 at 4096 envs through ``BatchedMazeEnv.step`` for 20
    steps (env-steps/s, no NaN, no kernel launched); the card's float64
    sine and cosine against numpy's on the host over 10^6 arguments; the
    MuJoCo goldens of ``tests/goldens`` teacher-forced at
    ``tests/test_point_golden.py``'s bounds (its free runs are the CPU
    test's), and on them how often the card's Newton solves move a
    line-search branch against the host's LAPACK solves.  Phases
    27-30 run in a process of their own (``python3 chip_smoke.py
    --point-quasi``, which also runs alone);
31. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
    ``{"ok": true, "device": {...}}`` line.

Outside the default run: ``python3 chip_smoke.py --sweep [--out PATH]``
builds every one of the 145 registered IDs at 256 envs on the card,
launches its step kernel once from its family's contact-rich states and
holds it against its plain version at its family's phase rule, one JSON
line an ID, and writes ``artifacts/PORT_REGISTRY_SWEEP.json`` (or PATH);
``python3 chip_smoke.py --ant-parent-probe DIR`` runs the Ant kernels'
three instantiations of the checkout at DIR and of this one on the same
inputs, holds each tree's against the plain version and the two against
each other at phases 5/9/24's rule (and counts the outputs equal to the
bit), times both in turns (DIR, this, this, DIR) and prints both trees'
ptxas lines for them; ``python3 chip_smoke.py --point-parent-probe DIR``
runs the Point kernels' plain-maze and object-solve modes of both and
requires every output equal to the bit; ``python3 chip_smoke.py
--ant-phases`` builds the Ant kernels with their phase counters and
prints where a forward evaluation's SM cycles go on four Ant worlds.

It needs one CUDA device and exits non-zero without one.  It imports
torch, numpy and the port only: no JAX, no gymnasium, nothing of the JAX
package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

T0 = time.perf_counter()
B = 4096
IDS = ("PointUMaze-v0", "PointUMaze-v1", "Point4Rooms-v2")
MAIN_ID = "PointUMaze-v0"
MAIN_STEPS = 1000
# Kernel and plain version do the same float32 operations in the same order
# (csrc/point_lane.cu, "Arithmetic"), so on the card they agree to the bit;
# the bound is the one the JAX package holds its Pallas kernel to against
# its XLA path (tests/test_pallas.py).
STEP_TOL = 1e-4
ROLLOUT_STEPS = 64
ANT_IDS = ("AntUMaze-v0", "AntUMaze-v1", "Ant4Rooms-v0")
ANT_MAIN_ID = "AntUMaze-v0"
ANT_MIN_CHECK_STEPS = 32
ANT_MAX_CHECK_STEPS = 64
ANT_CHECK_BUDGET_S = 30.0   # phase 5's plain steps, over the three IDs
ANT_SETTLE = 4              # public-API steps before the comparison starts
ANT_ROLL_STEPS = 8
# the block worlds: teacher-forced step checks (one, two and three blocks,
# the falling block, the BlockCarry heads), then two main paths
BLOCK_IDS = ("AntPush-v0", "AntFall-v0", "AntPushMaze-v0", "AntBlockCarry-v0")
BLOCK_MAIN_IDS = ("AntPush-v0", "AntFall-v0")
BLOCK_CHECK_STEPS = 16
# The Ant kernel and its plain version compute the same function by
# different algorithms (csrc/ant_lane.cuh, "Arithmetic"): bounds from the
# JAX package's own kernel-vs-XLA check (tests/test_ant_fast.py:266-283:
# qpos 5e-3, reward 1e-3, terminated and t exactly).  qvel, which that
# check leaves out, is held at 5e-2 (1 % of the ants' speeds) in all but
# 0.1 % of the env-steps: a contact (dist < margin) or a joint limit
# (viol > 0) that switches on in one version and not the other, when the
# two round a distance to either side of its threshold, applies a
# velocity-level impulse (aref = -b v at zero penetration) to one of them
# only.  Those env-steps are counted and their max printed.
ANT_QPOS_TOL = 5e-3
ANT_QVEL_TOL = 5e-2
ANT_QVEL_QUANTILE = 0.999
ANT_REWARD_TOL = 1e-3
ANT_RESET_TOL = 1e-6        # the reset draws: same words, same law
KNIFE_EDGE = 1e-4           # |goal distance - threshold| of a knife edge
# A state whose qvel passes BLOWN_QVEL (the ant's speeds are ~1-10), or
# with a block more than BLOWN_TRAVEL past its travel range, has blown up:
# the engine, JAX and port alike, integrates a 0.2 g block squeezed past
# its travel limit unstably; such envs are held to blowing up in both
# versions.
BLOWN_QVEL = 1e3
BLOWN_TRAVEL = 1.0
# In the block worlds a 0.2 g block squeezed between a leg and its travel
# limit turns a float32 knife edge (dist = margin, viol = 0, the support's
# case analysis, a sphere centre on a box face, |n_x| = 0.5 of the tangent
# frame) into a qpos change of up to ~1e-2 in one step; the plain version
# started one ulp away moves by as much.  An env-step beyond the qpos or
# reward bound there passes only where the two versions' traces show such
# a switch in one version only, in at most KNIFE_SHARE of the env-steps.
KNIFE_SHARE = 1e-3
# In the ball worlds an Ant leg pressed a few cm into the 1.34 kg ball (its
# segments weigh ~0.03 kg) blows up under the engine's explicit RK4 in
# some envs, the JAX package's XLA step as the port's (ant_kernel
# ball_states, ROADMAP queue 3); such envs are held to blowing up in both
# versions, as in the block worlds, in at most BALL_BLOWN_SHARE of them.
BALL_BLOWN_SHARE = 1e-2
# A ball squeezed between a leg and the floor or a wall can make the step
# ill-conditioned: the plain version's own result moves by up to ~7e-2 in
# qpos when its start moves by one float32 ulp.  In the ball worlds an
# env-step beyond the qpos or reward bound whose traces agree passes when
# the plain version's own spread covers it, as phase 20 holds the generic
# kernel (ant_rounding_ratio), counted with the knife edges in
# KNIFE_SHARE.
# the Swimmer and the Reacher: teacher-forced step checks (the dist and the
# goal heads, two links, a world dof with the z head), the rollout check
# with and without world dofs, one main path
SWIMMER_IDS = ("SwimmerUMaze-v0", "SwimmerUMaze-v1", "ReacherUMaze-v0",
               "SwimmerFall-v0")
SWIMMER_ROLL_IDS = ("SwimmerUMaze-v0", "SwimmerPush-v0")
SWIMMER_MAIN_ID = "SwimmerUMaze-v0"
SWIMMER_CHUNK = 125         # recorded steps per comparison launch
SWIMMER_LIVE_STEPS = (0, 1, 500, 999)   # also checked at B envs, live states
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores.  Bounds stay on the data sheet's figure; the
# measured fp32 peak (phase 16) is printed beside it.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
PEAK_CHECK_ITERS = 64
PEAK_CHAINS, PEAK_ITERS = 132 * 2048 * 8, 4096   # fp32_peak_flops' defaults
PEAK_REL_TOL = 1e-5         # the plain chain rounds twice, the FMA once


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_events(fn, reps: int) -> float:
    """Mean device time of ``fn``'s launch in ms over ``reps`` single
    launches by CUDA events, each queued with its events behind a
    device-side sleep so that the host's enqueue time falls outside them."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(10 ** 7)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def ori_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| with the heading column compared modulo 2*pi."""
    d = (a - b).abs()
    w = torch.remainder(a[:, 2] - b[:, 2] + math.pi, 2 * math.pi) - math.pi
    return torch.cat([d[:, :2], w.abs()[:, None]], dim=1)


# fp32 operations of one env step, counted from csrc/point_lane.cu (a sine,
# cosine, square root or division counts as one): kinematics 15, residual
# 33, two arrow-tip set-ups 8 each, resolve blend 6, dist head 3; per wall:
# ejection 70, each arrow tip 77, each of the two detect passes 60; per
# goal 12.
def rollout_diff(kern, plain):
    """Per-env max |err| over the state and reward sum of two rollout
    outputs, and the number of envs whose episode counts differ."""
    qk, vk, tk, rk, ek = kern
    qp, vp, tp, rp, ep = plain
    per_env = torch.cat([ori_diff(qk, qp), (vk - vp).abs(),
                         (rk - rp).abs()[:, None],
                         (tk - tp).abs().float()[:, None]], dim=1).max(1).values
    return per_env, int((ek != ep).sum())


def step_flops(n_walls: int, n_goals: int) -> int:
    return (15 + 33 + 2 * 8 + 6 + 3 + n_walls * (70 + 2 * 77 + 2 * 60)
            + 12 * n_goals)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_abs_diff(xs, ys) -> float:
    """max |x - y| over every element of each pair of ``xs`` and ``ys``
    (tensors or numbers), in float64: NaN where either side is NaN, so
    that a NaN on both sides never reads as agreement."""
    d = [(torch.as_tensor(x, dtype=torch.float64)
          - torch.as_tensor(y, dtype=torch.float64)).abs().max().cpu()
         for x, y in zip(xs, ys) if torch.as_tensor(x).numel()]
    return float(torch.stack(d).max())


def device_ms(prof, name: str):
    """Device time per launch (ms) of the kernels whose name holds
    ``name`` in a profile, and their launch count."""
    hits = [e for e in prof.key_averages()
            if name in e.key and e.self_device_time_total > 0]
    n = sum(e.count for e in hits)
    return (sum(e.self_device_time_total for e in hits) / n / 1e3 if n else
            float("nan")), n


def knife_edges(ks, state) -> torch.Tensor:
    """Envs whose goal distance at ``state`` (from the torso, or from the
    first observed block where the heads read it) lies within KNIFE_EDGE
    of a valid goal's threshold: there `terminated` may rightly differ."""
    g = ks.env_spec.heads.goals
    o = ks.obs_offset
    head = ks.env_spec._observe(state)[:, o:o + 3]
    d = ((head[:, None, :] - g.pos) * g.dim_mask).norm(dim=-1)
    return (((d - g.threshold).abs() < KNIFE_EDGE) & g.valid).any(dim=1)


def block_coverage(spec, qpos: torch.Tensor):
    """Per env at ``qpos``: a block slide within 0.01 of its travel limit
    or beyond it;
    a falling block perched on a platform (within 0.15 of its perch
    height); a falling block over the chasm (no platform under its
    center)."""
    model = spec.dynamic_model
    B_ = qpos.shape[0]
    at_limit = torch.zeros(B_, dtype=torch.bool, device=qpos.device)
    perched, chasm = at_limit.clone(), at_limit.clone()
    for j in range(model.njnt):
        if int(model.jnt_body[j]) >= 13 and model.jnt_limited[j]:
            q = qpos[:, int(model.jnt_qposadr[j])]
            lo, hi = (float(x) for x in model.jnt_range[j])
            at_limit |= (q <= lo + 0.01) | (q >= hi - 0.01)
    support = {zdof: plats for _, zdof, _, plats in spec._falling_support}
    for b in spec.block_runtimes:
        if not b.falling:
            continue
        plats = support[b.qpos_idx[2] - 1]
        c = spec.block_center(qpos, b)
        over = torch.zeros_like(at_limit)
        for px, py, ox, oy, _ in plats:
            over |= ((c[:, 0] - px).abs() < ox) & ((c[:, 1] - py).abs() < oy)
        z_perch = max(p[4] for p in plats) - b.body_pos[2] + b.half[2]
        perched |= over & (qpos[:, b.qpos_idx[2]] > z_perch - 0.15)
        chasm |= ~over
    return at_limit, perched, chasm


def blown(spec, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Envs whose state has blown up: non-finite, |qvel| > BLOWN_QVEL, or
    a block slide more than BLOWN_TRAVEL beyond its travel range (the
    block has left the maze).  A free ball has no travel range: a struck
    ball that flies out of the maze has not blown up."""
    out = (~torch.isfinite(q).all(dim=1) | ~torch.isfinite(v).all(dim=1)
           | (v.abs().max(dim=1).values > BLOWN_QVEL))
    model = spec.dynamic_model
    for j in range(model.njnt):
        if int(model.jnt_body[j]) >= 13 and model.jnt_limited[j]:
            x = q[:, int(model.jnt_qposadr[j])]
            lo, hi = (float(r) for r in model.jnt_range[j])
            out |= (x < lo - BLOWN_TRAVEL) | (x > hi + BLOWN_TRAVEL)
    return out


def dump_divergence(env_id: str, phase: str, ks, kstep, saved,
                    qerr: torch.Tensor) -> None:
    """The qpos tail: for the (up to) two envs whose kernel-vs-plain qpos
    error passes 1e-4, at the first step where it does, the coordinate
    that differs most, the plain version's own change there when its start
    state moves by one float32 ulp, and the active contact and limit sets
    (and the falling support's rows) of both versions at each forward
    evaluation of that step (the kernel's trace, ``ant_kernel.active_trace``
    for the plain version): the first evaluation where they differ, and
    each contact or limit that only one version has, with its distance to
    the threshold in the plain version (dist - margin < 0, or the limit's
    violation > 0, is active); and each contact both versions have whose
    sphere centre is inside its box, or whose tangent frame is built off
    the x axis (|n_x| < 0.5), in one version only."""
    from mujoco_maze_tpu_torch.ops.ant_kernel import active_trace, ant_step_plain

    worst = qerr.max(dim=0).values
    S = ks.offsets["sph"][1]
    kinds = ["floor", "box pick 1", "box pick 2"] + [
        f"block {b}" for b in range(ks.n_blk)]
    rows = {0: "none", 1: "platform", 2: "limit", 3: "both"}
    ball_bit = (3 + ks.n_blk) * S

    def named(bit):
        if bit < ball_bit:
            return f"sphere {bit % S} vs {kinds[bit // S]}"
        j = bit - ball_bit
        return (f"the ball vs {kinds[j]}" if j < 3
                else f"sphere {j - 3} vs the ball")
    for e in [int(x) for x in torch.argsort(worst, descending=True)[:2]]:
        if float(worst[e]) <= 1e-4:
            continue
        k = int(torch.nonzero(qerr[:, e] > 1e-4)[0])
        qpos, qvel, t, act = saved[k]
        out = kstep(qpos, qvel, t, act, trace=True)
        tr_k = out[-1][e].cpu()
        sl = slice(e, e + 1)
        qp = ant_step_plain(ks, qpos[sl], qvel[sl], t[sl], act[sl])[0][0]
        up = torch.nextafter(qpos[sl], torch.full_like(qpos[sl], float("inf")))
        qu = ant_step_plain(ks, up, qvel[sl], t[sl], act[sl])[0][0]
        col = int((out[0][e] - qp).abs().argmax())
        sens = float((qu - qp).abs().max())
        tr_p, info = active_trace(ks, qpos[sl], qvel[sl], act[sl], detail=True)
        tr_p = tr_p[0].cpu()
        bits = info["bits"].cpu().tolist()
        lim_dof = info["lim_dof"].cpu().tolist()
        differ = torch.nonzero((tr_k != tr_p).any(dim=1)).flatten().tolist()

        def bitset(words, w0):
            out = set()
            for w in range(8):
                x = int(words[w0 + w]) & 0xFFFFFFFF
                out |= {32 * w + i for i in range(32) if x >> i & 1}
            return out

        def members(words):
            lim = int(words[24]) & 0xFFFFFFFF
            sup = {b: rows[lim >> (24 + 2 * b) & 3] for b in range(ks.n_blk)
                   if lim >> (24 + 2 * b) & 3}
            return (bitset(words, 0), {d for d in range(24) if lim >> d & 1},
                    sup, bitset(words, 8), bitset(words, 16))

        head = (f"{env_id} env {e}: qpos error {float(worst[e]):.3g}, first "
                f"beyond 1e-4 at teacher-forced step {k}, most in qpos[{col}] "
                f"(kernel {float(out[0][e, col]):.6g}, plain {float(qp[col]):.6g}); "
                f"the plain step from a start one ulp up moves by {sens:.3g}")
        if not differ:
            c0, l0, s0, _, _ = members(tr_k[0])
            log(f"phase {phase} tail: {head}; the traces agree at all "
                f"{len(tr_k)} forward evaluations ({len(c0)} contacts, "
                f"limits on dofs {sorted(l0)}, support rows {s0} at the "
                "first): no contact, limit, support row, inside-the-box or "
                "tangent-frame switch in one version only")
            continue
        ev = differ[0]
        ck, lk, sk, ik, xk = members(tr_k[ev])
        cp, lp, sp, ip, xp = members(tr_p[ev])
        parts = []
        both = ck & cp
        for name, flag_k, flag_p in (("centre inside the box", ik, ip),
                                     ("tangent frame off x", xk, xp)):
            for bit in sorted((flag_k ^ flag_p) & both):
                who = "kernel" if bit in flag_k else "plain"
                parts.append(f"{name} in the {who} only: {named(bit)}")
        for name, only in (("kernel only", ck - cp), ("plain only", cp - ck)):
            for bit in sorted(only):
                c = bits.index(bit) if bit in bits else None
                gap = (f"{float(info['gap'][0, ev, c]):.3g}" if c is not None
                       else "n/a")
                parts.append(f"{name}: {named(bit)} (plain dist - margin {gap})")
        for name, only in (("kernel only", lk - lp), ("plain only", lp - lk)):
            for d in sorted(only):
                g = float(info["lim_gap"][0, ev, lim_dof.index(d)])
                parts.append(f"{name}: limit of dof {d} (plain violation {g:.3g})")
        if sk != sp:
            parts.append(f"support rows: kernel {sk}, plain {sp}")
        log(f"phase {phase} tail: {head}; active sets first differ at forward "
            f"evaluation {ev} of {len(tr_k)} (RK4 step {ev // 4}, stage "
            f"{ev % 4}): kernel {len(ck)} contacts, limits {sorted(lk)}; "
            f"plain {len(cp)} contacts, limits {sorted(lp)}; " + "; ".join(parts))


def ant_step_check(env_id: str, seed: int, phase: str, budget_s: float,
                   min_steps: int, max_steps: int, sweep: bool = False):
    """Phases 5, 9 and 24 for one ID: the step kernel vs its plain version,
    teacher-forced from the public step API's trajectory, from states
    that touch the world (``contact_states``; in the block worlds
    ``block_states``: legs on block faces, blocks at and beyond their
    travel limits, the Fall block perched or over the chasm; in the ball
    worlds ``ball_states``: legs pressed into the ball, the ball against
    walls and in corners, spinning, at the goal threshold, the ant 50-80 m
    from it).  With ``sweep`` (the registry sweep) the states are compared
    as drawn and the envs need not cover anything.  Returns the worst
    qpos, qvel and reward errors (a knife edge's left out), the knife
    edges and the largest of the three."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import lane_env, make_fast_step
    from mujoco_maze_tpu_torch.ops.ant_kernel import (active_trace,
                                                      ant_step_plain,
                                                      ball_census,
                                                      ball_states,
                                                      block_census,
                                                      block_states,
                                                      contact_census,
                                                      contact_states)

    env = mmt.make_batched(env_id, B)
    spec = env.spec
    blocks = bool(spec.block_runtimes)
    balls = bool(spec.ball_runtimes)
    objects = blocks or balls
    kstep = make_fast_step(env)
    ks = kstep.ks
    make_states = (ball_states if balls else block_states if blocks
                   else contact_states)
    q, v, t = (torch.as_tensor(x, device="cuda")
               for x in make_states(spec, B, seed))
    st = EnvState(qpos=q, qvel=v, t=t)
    obs = spec._observe(st)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = env.random_policy()
    # the object-free states settle through the public API first; the
    # block and ball worlds' start as drawn (blocks at and beyond their
    # travel limits, legs pressed into the ball)
    for _ in range(0 if objects or sweep else ANT_SETTLE):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ant_step_plain(ks, st.qpos, st.qvel, st.t, policy(obs, gen))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    steps = int(min(max_steps, max(min_steps, budget_s / plain_s)))
    errs = {"qpos": [], "qvel": [], "reward": []}
    t_diff = term_mis = knife_mis = knife_envs = resets = blow_mis = 0
    knife_steps, knife_max, knife_rew = 0, 0.0, 0.0
    cond_steps, cond_max, cond_ratio = 0, 0.0, 0.0
    most_active = exact = 0
    pair_rows = 0.0
    blown_envs = torch.zeros(B, dtype=torch.bool, device="cuda")
    seen = {name: torch.zeros(B, dtype=torch.bool, device="cuda")
            for name in ("floor", "wall", "block", "limit", "perched", "chasm")
            + (("ball on the floor", "ball on a wall", "legs on the ball",
                "several spheres on the ball", "ant >= 50 m from the ball")
               if balls else ())}
    S = ks.offsets["sph"][1]
    pair0 = (3 + ks.n_blk) * S + 3      # the first sphere-ball pair's bit
    candidates = S * (3 + ks.n_blk) + ks.n_ball * (3 + S)
    # the kernel's contact slots: one for each candidate
    room = lane_env.ant_slots(ks)
    active = 0
    saved, raw_q = [], []
    for _ in range(steps):
        act = policy(obs, gen)
        saved.append((st.qpos, st.qvel, st.t, act))
        out = kstep(st.qpos, st.qvel, st.t, act, count_active=True,
                    trace=True)
        qk, vk, tk, rk, mk, ak = out[:6]
        words = out[6][..., :8].to(torch.int64) & 0xFFFFFFFF
        per_eval = sum((words >> i) & 1 for i in range(32)).sum(dim=-1)
        most_active = max(most_active, int(per_eval.max()))
        if balls:
            bits = ((words[..., None] >> torch.arange(32, device="cuda")) & 1
                    ).flatten(-2)
            pair_rows += float(bits[..., pair0:pair0 + S].sum()) / (
                bits.shape[1] * B)
        qp, vp, tp, rp, mp = ant_step_plain(ks, st.qpos, st.qvel, st.t, act)
        exact += int(((qk == qp).all(dim=1) & (vk == vp).all(dim=1)
                      & (rk == rp) & (mk == mp)).sum())
        # an env whose state blows up (the engine's explicit RK4 with a
        # 0.2 g block driven past its travel limit) is compared by that
        # alone: both versions must blow up in the same env-steps
        bk, bp = blown(spec, qk, vk), blown(spec, qp, vp)
        blow_mis += int((bk != bp).sum())
        blown_envs |= bp
        ok = ~(bk | bp)
        zero = torch.zeros_like(rk)
        eq = torch.where(ok, (qk - qp).abs().max(dim=1).values, zero)
        er = torch.where(ok, (rk - rp).abs(), zero)
        raw_q.append(eq.clone())
        if objects:
            # in the block and ball worlds an env-step beyond the qpos or
            # reward bound is held to be a knife edge: one version alone
            # switches a contact, a limit, the support's rows, a sphere's
            # side of a box face or a tangent frame at some forward
            # evaluation, as the two versions' traces name it
            over = torch.nonzero((eq > ANT_QPOS_TOL) | (er > ANT_REWARD_TOL))[:, 0]
            if len(over):
                tr_p = active_trace(ks, st.qpos[over], st.qvel[over], act[over])
                switch = (out[6][over] != tr_p).flatten(1).any(dim=1)
                knife = over[switch]
                knife_steps += len(knife)
                knife_max = max(knife_max, float(eq[knife].max())
                                if len(knife) else 0.0)
                knife_rew = max(knife_rew, float(er[knife].max())
                                if len(knife) else 0.0)
                eq[knife] = 0.0
                er[knife] = 0.0
                rest = over[~switch]
                if balls and len(rest):
                    ratio = ant_rounding_ratio(ks, (qk, rk), (qp, rp), st.qpos,
                                               st.qvel, st.t, act, rest)
                    cond = rest[ratio <= ROUNDING_FACTOR]
                    cond_steps += len(cond)
                    cond_max = max([cond_max] + [float(x) for x in eq[cond]])
                    cond_ratio = max([cond_ratio]
                                     + [float(x) for x in ratio])
                    eq[cond] = 0.0
                    er[cond] = 0.0
        errs["qpos"].append(eq)
        errs["qvel"].append(torch.where(ok, (vk - vp).abs().max(dim=1).values, zero))
        errs["reward"].append(er)
        t_diff += int((tk != tp).sum())
        edge = knife_edges(ks, EnvState(qpos=qp, qvel=vp, t=tp))
        knife_envs += int(edge.sum())
        term_mis += int(((mk != mp) & ~edge & ok).sum())
        knife_mis += int(((mk != mp) & edge & ok).sum())
        floor, walls = contact_census(ks, st.qpos)
        seen["floor"] |= floor > 0
        seen["wall"] |= walls > 0
        if blocks:
            seen["block"] |= block_census(ks, st.qpos) > 0
            lim, perched, chasm = block_coverage(spec, st.qpos)
            seen["limit"] |= lim
            seen["perched"] |= perched
            seen["chasm"] |= chasm
        if balls:
            b_floor, b_walls, b_pairs = ball_census(ks, st.qpos)
            seen["ball on the floor"] |= b_floor > 0
            seen["ball on a wall"] |= b_walls > 0
            seen["legs on the ball"] |= b_pairs > 0
            seen["several spheres on the ball"] |= b_pairs > 1
            seen["ant >= 50 m from the ball"] |= (
                st.qpos[:, :2] - st.qpos[:, 15:17]).norm(dim=1) >= 50.0
        active += int(ak.sum())
        res = env.step(st, act)
        resets += int((res.terminated | res.truncated).sum())
        st, obs = res.state, res.obs
    stats = {}
    for name, per_step in errs.items():
        e = torch.stack(per_step)               # (steps, B)
        stats[name] = (float(e.median()), float(e.max()),
                       int((e.max(dim=0).values > 1e-4).sum()))
    qv = torch.stack(errs["qvel"]).flatten()
    qv_quant = float(torch.quantile(qv, ANT_QVEL_QUANTILE))
    qv_beyond = int((qv > ANT_QVEL_TOL).sum())
    cover = {k: int(x.sum()) for k, x in seen.items()}
    log(f"phase {phase}: {env_id} ant step kernel vs plain, {steps} "
        f"teacher-forced steps x {B} envs (one plain step {plain_s:.3f} s): "
        + "; ".join(f"{k} median {m:.3g} max {x:.3g} envs>1e-4 {n}"
                    for k, (m, x, n) in stats.items())
        + f"; qvel {100 * ANT_QVEL_QUANTILE:g}th percentile {qv_quant:.3g} "
        f"(tol {ANT_QVEL_TOL}), env-steps beyond it {qv_beyond} of {qv.numel()}"
        + f"; t mismatches {t_diff} (tol 0); terminated mismatches {term_mis} "
        f"(tol 0) and {knife_mis} at the {knife_envs} knife-edge env-steps; "
        f"envs seen {cover}; episodes ended {resets}; active contacts per "
        f"env-step {active / (steps * B):.4g}, at most {most_active} in one "
        f"forward evaluation (of {candidates} candidates; the kernel holds "
        f"{room} slots); envs whose plain state blew up "
        f"(non-finite, |qvel| > {BLOWN_QVEL:g} or a block {BLOWN_TRAVEL:g} past "
        f"its travel) {int(blown_envs.sum())}"
        + (f" (tol {int(BALL_BLOWN_SHARE * B)})" if balls else "")
        + f", env-steps where only one version did {blow_mis} (tol 0)"
        + (f"; env-steps beyond the qpos or reward bound at a knife edge (a "
           f"switch in one version only) {knife_steps} (tol "
           f"{int(KNIFE_SHARE * steps * B)}), their max qpos {knife_max:.3g}, "
           f"reward {knife_rew:.3g}" if objects else "")
        + (f"; env-steps beyond it where the traces agree but the plain "
           f"version's own float32 spread covers the difference "
           f"{cond_steps} (with the knife edges, tol "
           f"{int(KNIFE_SHARE * steps * B)}), their max qpos {cond_max:.3g}, "
           f"the largest (|kernel - plain| - bound) / spread of those "
           f"checked {cond_ratio:.3g} (tol {ROUNDING_FACTOR:g}); env-steps "
           f"bit-exact (qpos, qvel, reward, terminated) {exact} of "
           f"{steps * B}; active sphere-ball pairs per forward evaluation "
           f"{pair_rows / steps:.4g}" if balls else ""))
    dump_divergence(env_id, phase, ks, kstep, saved, torch.stack(raw_q))
    tols = {"qpos": ANT_QPOS_TOL, "reward": ANT_REWARD_TOL}
    if (any(not stats[k][1] <= tol for k, tol in tols.items())  # NaN fails
            or not qv_quant <= ANT_QVEL_TOL or not stats["qvel"][1] < 1e3
            or t_diff or term_mis or blow_mis
            or knife_steps + cond_steps > KNIFE_SHARE * steps * B
            or (not objects and int(blown_envs.sum()))
            or (balls and int(blown_envs.sum()) > BALL_BLOWN_SHARE * B)):
        raise SystemExit(f"ant step kernel disagrees with its plain version on {env_id}")
    if not sweep and (resets == 0 or (not objects and (
            cover["wall"] == 0 or cover["floor"] < B // 2))):
        raise SystemExit(f"{env_id}: expected feet on the floor, walls and resets")
    if not sweep and blocks and (
            cover["block"] < B // 10 or cover["limit"] < B // 10 or (
                spec._falling_support
                and (cover["perched"] < B // 4 or cover["chasm"] < B // 10))):
        raise SystemExit(f"{env_id}: expected legs on blocks, blocks at their "
                         "limits, and perched and fallen Fall blocks")
    if not sweep and balls and (
            cover["ball on the floor"] < B // 2
            or cover["ball on a wall"] < B // 10
            or cover["legs on the ball"] < B // 10
            or cover["several spheres on the ball"] < B // 20
            or cover["ant >= 50 m from the ball"] < B // 10):
        raise SystemExit(f"{env_id}: expected the ball on the floor and on "
                         "walls, legs pressed into it, and ants far from it")
    return {"qpos": stats["qpos"][1], "qvel": stats["qvel"][1],
            "qvel_quantile": qv_quant, "reward": stats["reward"][1],
            "knife_edges": knife_steps, "conditioned": cond_steps,
            "bit_exact": exact,
            "env_steps": steps * B,
            "max": max(stats[k][1] for k in stats)}


def ant_rounding_ratio(ks, kern, plain, q, v, t, a, envs) -> torch.Tensor:
    """Per env-step of ``envs``: the largest (|kernel - plain| - bound) /
    spread over its qpos and reward coordinates, each coordinate's spread
    its largest move in the plain version over ROUNDING_SAMPLES starts with
    every coordinate of qpos and qvel moved by a relative 2^-23 (phase 20's
    rule, about the float32 plain version).  ``kern`` and ``plain``: the
    two versions' (qpos, reward) of the step."""
    from mujoco_maze_tpu_torch.ops.ant_kernel import ant_step_plain

    n, m = len(envs), ROUNDING_SAMPLES
    q, v, t, a = q[envs], v[envs], t[envs], a[envs]
    gen = torch.Generator(device="cuda").manual_seed(0)
    nudge = lambda x: x * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, x.shape, generator=gen, device="cuda"))
    out = ant_step_plain(ks, torch.cat([nudge(q) for _ in range(m)]),
                         torch.cat([nudge(v) for _ in range(m)]),
                         t.repeat(m), a.repeat(m, 1))
    ratio = torch.zeros(n, device="cuda")
    for k, i, tol in ((0, 0, ANT_QPOS_TOL), (1, 3, ANT_REWARD_TOL)):
        x = plain[k][envs].reshape(n, -1)
        spread = (out[i].reshape(m, n, -1) - x).abs().max(dim=0).values
        over = (kern[k][envs].reshape(n, -1) - x).abs() - tol
        ratio = torch.maximum(ratio, (over / spread.clamp_min(1e-30)).max(dim=1)
                              .values)
    return ratio


def ant_rollout_check(env_id: str, seed: int, phase: str):
    """Phases 6, 10 and 25 for one ID: the rollout kernel vs its plain
    version over ANT_ROLL_STEPS steps from t spread over the window's end,
    from the env's own reset states: every env resets; the reset draws of
    the envs reset on the last step are the plain version's to the bit,
    and their world dofs (a ball's position and quaternion among them)
    are back at qpos0, at rest."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      contact_states,
                                                      rollout_reset)

    env = mmt.make_batched(env_id, B)
    roll = make_fast_rollout(env, ANT_ROLL_STEPS)
    if env.spec.block_runtimes or env.spec.ball_runtimes:
        st, _ = env.reset(seed)
        q, v = st.qpos, st.qvel
    else:
        q, v, _ = (torch.as_tensor(x, device="cuda")
                   for x in contact_states(env.spec, B, seed))
    idx = torch.arange(B, device="cuda")
    t0 = (EPISODE_LIMIT - ANT_ROLL_STEPS + idx % ANT_ROLL_STEPS).to(torch.int32)
    kern = roll.per_env(q, v, t0, seed)
    plain = ant_rollout_plain(roll.ks, q, v, t0, seed, ANT_ROLL_STEPS)
    eps_diff = int((kern[4] != plain[4]).sum())
    # envs that truncate on the last step end on that step's reset draw
    last = (t0 == EPISODE_LIMIT - ANT_ROLL_STEPS) & (plain[2] == 0) & (kern[2] == 0)
    q_r, v_r = rollout_reset(idx.to(torch.int64), ANT_ROLL_STEPS - 1, seed,
                             env.spec.init_qpos, env.spec.nv)
    draw_err = max(float((kern[0][last] - q_r[last]).abs().max()),
                   float((kern[1][last] - v_r[last]).abs().max()),
                   float((plain[0][last] - q_r[last]).abs().max()),
                   float((plain[1][last] - v_r[last]).abs().max()))
    qpos0 = torch.as_tensor(env.spec.init_qpos, dtype=torch.float32,
                            device="cuda")
    world_back = bool((kern[0][last][:, 15:] == qpos0[15:]).all()
                      and (kern[1][last][:, 14:] == 0).all())
    q_err = float((kern[0] - plain[0]).abs().max())
    eps_k = int(kern[4].sum())
    log(f"phase {phase}: {env_id} ant rollout kernel vs plain, {ANT_ROLL_STEPS} "
        f"steps x {B} envs from t in [{EPISODE_LIMIT - ANT_ROLL_STEPS}, "
        f"{EPISODE_LIMIT}): episodes {eps_k} vs {int(plain[4].sum())}, envs "
        f"whose counts differ {eps_diff} (tol 0); reset draws of the "
        f"{int(last.sum())} envs reset on the last step: max |err| "
        f"{draw_err:.3g} (tol {ANT_RESET_TOL}), their world dofs at qpos0 and "
        f"at rest: {world_back}; qpos max |err| {q_err:.3g} (tol {ANT_QPOS_TOL})")
    if (eps_diff or not draw_err <= ANT_RESET_TOL or not q_err <= ANT_QPOS_TOL
            or not world_back or int(kern[4].min()) < 1
            or int(last.sum()) < B // ANT_ROLL_STEPS // 2):
        raise SystemExit(f"ant rollout kernel disagrees with its plain version on {env_id}")
    return max(q_err, draw_err)


def fall_mechanic_check():
    """Phase 11: the Fall block through the step kernel at B envs
    (tests/test_ant_world.py:114-153 bounds): after 25 zero-action steps
    from reset it perches on its platform (MuJoCo probe: z = 3.9217);
    pushed one cell +y, over the chasm, it drops flush within 30 steps."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import lane_env

    env = mmt.make_batched("AntFall-v0", B, auto_reset=False)
    st, _ = env.reset(11)
    zero = torch.zeros(B, 8, device="cuda")
    lane_env.reset_launch_counts()
    for _ in range(25):
        st = env.step(st, zero).state
    (blk,) = env.spec.block_runtimes
    _, yq, zq = blk.qpos_idx
    z = st.qpos[:, zq]
    q = st.qpos.clone()
    q[:, yq] = env.spec.structure.size_scaling      # one cell +y
    st2 = st._replace(qpos=q)
    for _ in range(30):
        st2 = env.step(st2, zero).state
    z2 = st2.qpos[:, zq]
    n = dict(lane_env.LAUNCHES)["ant_blocks_step"]
    log(f"phase 11: AntFall-v0 x {B} envs through the kernel ({n} launches): "
        f"perch z after 25 zero-action steps in [{float(z.min()):.6g}, "
        f"{float(z.max()):.6g}] (bound (3.80, 4.0); MuJoCo probe 3.9217); "
        f"pushed one cell +y, z after 30 steps max {float(z2.max()):.3g} "
        f"(bound < 0.05)")
    if not (bool(((z > 3.80) & (z < 4.0)).all()) and bool((z2 < 0.05).all())
            and n == 55):
        raise SystemExit("the Fall block does not perch and drop through the kernel")


# fp32 operations of one Ant env step, counted from the one-thread-per-env
# Ant kernel that preceded the warp-per-env csrc/ant_lane.cuh and kept as
# the bound: what an env-step needs, not the work the lanes do (a sine,
# cosine, square root, division, min or max counts as one; integer and
# Philox work not counted).  Per forward evaluation, fixed: kinematics
# 1,641; mass matrix 7,839; RNE bias 4,306; actuation 60; Cholesky and
# inverse 6,531; qacc0 406; hinge limits 320; the spheres' centres and
# floor tests 814; qacc 420; the reach test 22 per static box.  The tests
# of a sphere against the static boxes within reach (~51 each) depend on
# the data and are left out, as are the sweeps' Minv products of a
# forward with contacts (1,568): the bound stays a lower bound.  Per
# block: its 37 sphere tests, 1,887; per world dof: 5, and 40 more when
# limited; per falling block: the support, 60, and 6 per platform.  Per
# active contact (rows, A = J Minv J^T, 4 Jacobi sweeps, J^T f): 1,379.
# Per step: 20 forward evaluations, 5 RK4 integrations of 790 + 38 per
# world dof, the heads 30 + 12 per goal.
ANT_FORWARD_FIXED = 1641 + 7839 + 4306 + 60 + 6531 + 406 + 320 + 814 + 420


def ant_step_flops(ks) -> int:
    """Fixed fp32 operations of one env step of ``ks``'s world (without
    contacts)."""
    wdof = ks.table("wdof")
    n_lim = int((wdof[:, 3] != 0).sum())
    n_fall = int((ks.table("blk")[:, 8] >= 0).sum())
    fwd = (ANT_FORWARD_FIXED + 22 * ks.offsets["box"][1] + 1887 * ks.n_blk
           + 5 * ks.n_w + 40 * n_lim + 60 * n_fall
           + 6 * ks.offsets["plat"][1])
    return (20 * fwd + 5 * (790 + 38 * ks.n_w) + 30
            + 12 * ks.offsets["goals"][1])


ANT_FLOPS_PER_CONTACT = 1379


def ant_bytes(ks, per_launch: str) -> int:
    """Bytes per env of one launch: the step reads qpos, qvel, t and the
    actions and writes qpos, qvel, t, reward and terminated; a rollout
    reads qpos, qvel, t and writes them with reward sums and counts."""
    nq, nv = 15 + ks.n_w + 7 * ks.n_ball, 14 + ks.n_w + 6 * ks.n_ball
    io = 4 * (nq + nv + 1)
    return 2 * io + 32 + 4 + 1 if per_launch == "step" else 2 * io + 8


def ant_group_counts(ks) -> list:
    """The envs a block at which the Ant step is timed: 1, 2 and 4 where
    their shared memory fits a block, and the launch's own."""
    from mujoco_maze_tpu_torch.ops import lane_env

    counts = {lane_env.ant_geometry(ks).groups}
    for g in (1, 2, 4):
        with contextlib.suppress(NotImplementedError):
            counts.add(lane_env.ant_geometry(ks, g).groups)
    return sorted(counts)


def ant_main_path(env_id: str, phase: str, numbers_phase: str):
    """Phases 7-8 (AntUMaze-v0) and 12 (the block worlds): an Ant main
    path through the public API, counted and timed, its outputs checked;
    then each Ant kernel's numbers at its shapes."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,
                                           make_fast_step)
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      ant_step_plain,
                                                      block_states,
                                                      contact_states)
    from torch.profiler import ProfilerActivity, profile

    env = mmt.make_batched(env_id, B)
    spec = env.spec
    blocks = bool(spec.block_runtimes)
    step_name, roll_name = (("ant_blocks_step", "ant_blocks_rollout") if blocks
                            else ("ant_step", "ant_rollout"))
    policy = env.random_policy()
    gen = torch.Generator(device="cuda").manual_seed(5)
    st, obs = env.reset(5)
    fused = make_fast_rollout(env, MAIN_STEPS)
    for _ in range(3):  # warm-up
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    make_fast_rollout(env, 1)(st.qpos, st.qvel, st.t, 1)
    torch.cuda.synchronize()

    lane_env.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(MAIN_STEPS):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    ev[1].record()
    st_m, rew_m, eps_m = env.rollout_metrics(st, policy, MAIN_STEPS, gen)
    ev[2].record()
    qf, vf, tf, rew_f, eps_f = fused(st.qpos, st.qvel, st.t, 17)
    ev[3].record()
    torch.cuda.synchronize()
    launches = dict(lane_env.LAUNCHES)
    ms_api, ms_metrics, ms_fused = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    log(f"phase {phase}: ant main path {env_id} x {B} envs, {MAIN_STEPS} steps "
        f"per path; launches {launches}")
    expected = {k: 0 for k in launches}
    expected.update({step_name: 2 * MAIN_STEPS, roll_name: 1})
    if launches != expected:
        raise SystemExit(f"ant main path launches {launches}, expected {expected}")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase {phase}: {env_id} env-steps/s (CUDA events): step API "
        f"{rate(ms_api):.6g}, rollout_metrics {rate(ms_metrics):.6g}, fused "
        f"rollout {rate(ms_fused):.6g} ({ms_fused:.6g} ms per 1000-step launch)")
    n_blk = len(spec.block_runtimes)
    ob = 3 + 3 * n_blk
    centers = [spec.block_center(st.qpos, b) for b in spec.block_runtimes]
    quat_norm = qf[:, 3:7].norm(dim=1)
    height = spec.structure.height_offset
    checks = {
        f"obs shape (B, {spec.obs_dim})": tuple(obs.shape) == (B, spec.obs_dim),
        "obs finite": bool(torch.isfinite(obs).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, -1] == st.t.float() * 0.001).all()),
        "obs = (qpos[:3], block centers, qpos[3:15], qvel[:14], t)": bool(
            (obs[:, :3] == st.qpos[:, :3]).all()
            and all((obs[:, 3 + 3 * i:6 + 3 * i] == c).all()
                    for i, c in enumerate(centers))
            and (obs[:, ob:ob + 12] == st.qpos[:, 3:15]).all()
            and (obs[:, ob + 12:ob + 26] == st.qvel[:, :14]).all()),
        "rollout_metrics reward finite and < 0 (dist reward)": bool(
            torch.isfinite(rew_m)) and float(rew_m) < 0,
        "rollout_metrics ended >= B episodes": int(eps_m) >= B,
        "fused state finite": bool(torch.isfinite(qf).all() and torch.isfinite(vf).all()),
        f"fused torso height in (0, {2 + height:g})": bool(
            ((qf[:, 2] > 0) & (qf[:, 2] < 2 + height)).all()),
        "fused quaternions unit (1e-5)": float((quat_norm - 1).abs().max()) < 1e-5,
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward < 0 (dist reward)": float(rew_f) < 0,
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
    }
    model = spec.dynamic_model
    for j in range(model.njnt):
        if int(model.jnt_body[j]) >= 13:
            lo, hi = (float(x) for x in model.jnt_range[j])
            a = int(model.jnt_qposadr[j])
            if not model.jnt_limited[j]:   # the falling z: floor to perch
                lo, hi = 0.0, -lo
            checks[f"fused world dof {a} in [{lo - 0.1:g}, {hi + 0.1:g}]"] = bool(
                ((qf[:, a] > lo - 0.1) & (qf[:, a] < hi + 0.1)).all())
    log(f"phase {phase}: output checks {checks}")
    if not all(checks.values()):
        raise SystemExit(f"the ant main path's output failed a check on {env_id}")

    # the port's CUDA path against its CPU path on a small input
    n_small = 16
    make_states = block_states if blocks else contact_states
    cpu_env = mmt.make_batched(env_id, n_small, auto_reset=False, device="cpu")
    gpu_env = mmt.make_batched(env_id, n_small, auto_reset=False)
    q, v, t = (torch.as_tensor(x) for x in make_states(cpu_env.spec, n_small, 9))
    s_cpu = EnvState(qpos=q, qvel=v, t=t)
    rng = np.random.RandomState(9)
    small_err = 0.0
    for _ in range(3):
        act = torch.as_tensor(rng.uniform(-30, 30, (n_small, 8)), dtype=torch.float32)
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        small_err = max(small_err,
                        float((r_gpu.state.qpos.cpu() - r_cpu.state.qpos).abs().max()),
                        float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        if not torch.equal(r_gpu.terminated.cpu(), r_cpu.terminated):
            raise SystemExit("the ant CUDA path and CPU path disagree on terminated")
        s_cpu = r_cpu.state
    log(f"phase {phase}: {env_id} CUDA path vs CPU path, {n_small} envs x 3 steps "
        f"teacher-forced: max |err| qpos and reward {small_err:.3g} "
        f"(tol {ANT_QPOS_TOL})")
    if not small_err <= ANT_QPOS_TOL:
        raise SystemExit("the ant CUDA path disagrees with the CPU path")

    # -- per-kernel numbers at the main path's shapes ------------------------
    kstep = make_fast_step(env)
    ks = kstep.ks
    act = policy(obs, gen)
    geo = lane_env.ant_geometry(ks)
    group_ms = {}
    for g in ant_group_counts(ks):
        kstep.groups = g
        group_ms[g] = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 20)
    kstep.groups = geo.groups
    resident = lane_env.ant_resident_warps(ks)
    log(f"phase {numbers_phase}: {env_id} ant step ms per launch by envs (warps) "
        f"per block: {group_ms}; the launch: {geo._asdict()}; warps an SM "
        f"holds (registers and shared memory): {resident}")
    ms_step = group_ms[geo.groups]
    ms_step_plain = cuda_ms(lambda: ant_step_plain(ks, st.qpos, st.qvel, st.t, act), 2)
    active_step = int(kstep(st.qpos, st.qvel, st.t, act, count_active=True)[5].sum())
    roll8 = make_fast_rollout(env, ANT_ROLL_STEPS)
    ms_roll = cuda_ms(lambda: roll8(st.qpos, st.qvel, st.t, 19), 5)
    ms_roll_plain = cuda_ms(lambda: ant_rollout_plain(
        ks, st.qpos, st.qvel, st.t, 19, ANT_ROLL_STEPS), 1)
    active_roll = int(roll8.per_env(st.qpos, st.qvel, st.t, 19,
                                    count_active=True)[5].sum())
    tables = 4 * ks.packed.numel()
    step_bound = bound(B * ant_bytes(ks, "step") + tables,
                       B * ant_step_flops(ks) + ANT_FLOPS_PER_CONTACT * active_step)
    roll_bound = bound(B * ant_bytes(ks, "rollout") + tables,
                       B * ANT_ROLL_STEPS * ant_step_flops(ks)
                       + ANT_FLOPS_PER_CONTACT * active_roll)

    # device times, and where a step-API step's time goes: one profiled
    # window of 20 steps, then three rollout launches after it (a profiler
    # session of their own reported no event for them after several
    # sessions in one process)
    acts = [policy(obs, gen) for _ in range(20)]
    s = st
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a in acts:
            s = env.step(s, a).state
        ev[1].record()
        torch.cuda.synchronize()
        for _ in range(3):
            roll8.per_env(st.qpos, st.qvel, st.t, 23)
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = [e for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
                 and "ant_rollout_kernel" not in e.key]
    busy_us = sum(e.self_device_time_total for e in on_device)
    dev_step, n_step = device_ms(prof, "ant_step_kernel")
    dev_roll, _ = device_ms(prof, "ant_rollout_kernel")
    log(f"phase {numbers_phase}: profiled {env_id} step API, 20 steps in "
        f"{window_us:.6g} us: device busy {busy_us:.6g} us (idle share "
        f"{1 - busy_us / window_us:.4g}), {sum(e.count for e in on_device) // 20} "
        f"kernels/step; ant_step_kernel {dev_step:.6g} ms per launch on the "
        f"device ({n_step} launches)")
    log(f"phase {numbers_phase}: {env_id} {step_name} {ms_step:.6g} ms/launch "
        f"({active_step} active contacts summed over its forward evaluations; "
        f"plain {ms_step_plain:.6g} ms, bound {step_bound[0]:.3g} ms by "
        f"{step_bound[1]}); {roll_name} {ms_roll:.6g} ms per {ANT_ROLL_STEPS}-step "
        f"launch, {dev_roll:.6g} ms on the device (plain {ms_roll_plain:.6g} ms, "
        f"bound {roll_bound[0]:.3g} ms by {roll_bound[1]}); "
        f"{ks.offsets['box'][1]} boxes, {ks.n_blk} blocks, {ks.n_w} world dofs")
    return {
        "step": {"name": step_name, "launches": launches[step_name],
                 "ms": ms_step, "device_ms": dev_step,
                 "ms_by_groups": group_ms, "launch": geo._asdict(),
                 "warps_per_sm": resident, "plain_ms": ms_step_plain,
                 "bound_ms": step_bound[0], "bound_by": step_bound[1],
                 "env_steps_per_s": {
                     "step_api": rate(ms_api),
                     "rollout_metrics": rate(ms_metrics),
                     "fused_rollout": rate(ms_fused)},
                 "idle_share": 1 - busy_us / window_us},
        "rollout": {"name": roll_name, "launches": launches[roll_name],
                    "ms": ms_roll, "device_ms": dev_roll,
                    "fused_ms_per_1000": ms_fused,
                    "plain_ms": ms_roll_plain,
                    "bound_ms": roll_bound[0], "bound_by": roll_bound[1]},
    }


# fp32 operations that one swimmer env step needs (a sine, cosine, square
# root, division, min or max counts as one; selects, sign flips and the
# Philox integer work count none).  Counted from the closed form
# (csrc/swimmer_lane.cu, mujoco_maze_tpu/ops/swimmer_math.py), not from
# the kernel's instructions: only the lower triangle of the symmetric mass
# matrix and its factor, only the Jacobian entries that are not
# structurally zero (link k's column of hinge i is zero for i > k, the
# slide columns are constant unit vectors), no product with a constant 0
# or +-1, and every constant folded (the slide block of M, its factor and
# the reciprocals).  The kernel does more (it keeps the zero and unit
# entries in its products, for bit-exact agreement with its plain
# version), so the bound stays a lower bound.
def swimmer_forward_flops(nl: int) -> int:
    """One forward evaluation of an ``nl``-link chain: n = nl + 2
    coordinates (slides x, y, then the nl hinges), nl - 1 actuators on
    the hinges after the first."""
    n, nu = nl + 2, nl - 1
    hinges = range(nl)            # hinge i turns links i .. nl - 1
    f = nl - 1                    # link angles, a running sum
    f += 2 * nl                   # cos, sin of each link angle
    # CoM vectors (link 0's is (c, s)) and link 0's attachment (the
    # others' are -(c, s))
    f += 2 * (nl - 1) + 2
    f += nl * (nl - 1)            # levers from hinge i to link k's CoM, suffix sums
    # mass matrix, lower triangle: slide-slide entries are constants;
    # slide x hinge i: sum over links k >= i, times m
    f += sum(2 * (nl - i) for i in hinges)
    # hinge i x hinge j (i <= j): links k >= j, a 2-term dot each, the sum,
    # times m, plus the constant Iz (nl - j) (+ armature on the diagonal)
    f += sum(4 * (nl - j) + 1 for j in hinges for _ in range(j + 1))
    f += (nl - 1) + nl            # angular velocities w_k, -w_k^2
    # velocity-product CoM accelerations: the -w_m^2 att_m terms (m < nl-1),
    # the -w_k^2 com_k terms, their prefix sums
    f += 2 * (nl - 1) + 2 * nl + 2 * max(nl - 2, 0) + 2 * (nl - 1)
    # bias: slide rows sum the links' accelerations times m; hinge i
    # dots link k's lever with its acceleration for k >= i
    f += 2 * nl + sum(4 * (nl - i) for i in hinges)
    # fluid drag of link k: CoM velocity (slides plus k + 1 levers), into
    # the link frame (6), viscous (3) and quadratic (9) terms, back (6)
    f += sum(4 * (k + 1) + 24 for k in range(nl))
    # generalized forces: slide rows sum the links' forces; hinge i dots
    # its levers with links k >= i, plus the suffix sum of the torques
    f += 2 * (nl - 1) + sum(4 * (nl - i) for i in hinges) + (nl - 1)
    f += 4 * nu                   # clip, gear, add
    f += n                        # rhs = tau - bias
    # Cholesky factor: the slide columns are constant reciprocals times
    # the hinge rows; each later column j: its dots, clamp and root, and
    # a division per entry below the diagonal
    f += 2 * nl + sum(2 * j * (n - j) + 2 + (n - j - 1) for j in range(2, n))
    # one solve: forward (the slide rows against constants), backward (the
    # zero L[1][0] skipped)
    solve = 2 + sum(2 * k + 1 for k in range(2, n))
    solve += sum(2 * (n - 1 - k) + 1 for k in range(2, n)) + 2 * (2 * (n - 2) + 1)
    f += 2 * solve                # unconstrained, then with the limit forces
    # diag(M^-1) of each limited hinge d (coordinates 3 ..): L^-1 e_d from
    # row d down, its squared norm, clamp and reciprocal
    f += sum(1 + sum(2 * (i - d) for i in range(d + 1, n))
             + 2 * (n - d) - 1 + 2 for d in range(3, n))
    f += nu * 2 * 15              # the impedance, both sides of each limit
    f += nu                       # the limit forces into the rhs
    return f


def swimmer_step_flops(nl: int, goal_dims, dist_reward: bool,
                       frame_skip: int = 4) -> int:
    """One env step: frame_skip RK4 steps of the n = nl + 2 robot
    coordinates (four forward evaluations and 24 a coordinate: 4 per
    stage state, 12 to average and apply), the inner reward, the heads.
    ``goal_dims``: each goal's dimensions that its mask keeps."""
    nu = nl - 1
    rk4 = 4 * swimmer_forward_flops(nl) + 24 * (nl + 2)
    inner = 8 + 2 * nu + 1        # planar speed, control cost, difference
    heads = sum(3 * d for d in goal_dims) + (2 if dist_reward else 0) + 2
    return frame_skip * rk4 + inner + heads


def swimmer_bytes(nq: int, nu: int, per_launch: str) -> int:
    """Bytes per env of one launch: the step reads qpos, qvel, t and the
    actions and writes qpos, qvel, t, reward and terminated; a rollout
    reads qpos, qvel, t and writes them with the reward sum and count."""
    io = 4 * (2 * nq + 1)
    return 2 * io + 4 * nu + 5 if per_launch == "step" else 2 * io + 8


def swimmer_step_check(env_id: str, seed: int):
    """Phase 13 for one ID: the step kernel vs its plain version,
    teacher-forced over 1000 steps of the public step API (auto-reset on),
    from t spread over the episode and every 64th env on the goal.  The
    recorded steps are compared SWIMMER_CHUNK at a time, as one batch of
    SWIMMER_CHUNK * B envs through each version.  At the steps
    SWIMMER_LIVE_STEPS the env's own wrapper (``make_fast_step(env)``, B
    envs, the main path's grid) also runs on the step API's live states,
    and on copies of them with wider rows, and must equal the plain
    version to the bit."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import lane_env, make_fast_step
    from mujoco_maze_tpu_torch.ops.swimmer_kernel import swimmer_step_plain

    env = mmt.make_batched(env_id, B)
    spec = env.spec
    kstep = make_fast_step(env)
    ks = kstep.ks
    st, _ = env.reset(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = spec.heads.goals
    on_goal = torch.arange(B, device="cuda") % 64 == 0
    q = st.qpos.clone()
    q[:, :3] = torch.where(on_goal[:, None] & (g.dim_mask[0] > 0), g.pos[0],
                           q[:, :3])
    t = torch.randint(0, 1000, (B,), generator=gen, device="cuda",
                      dtype=torch.int32)
    st = st._replace(qpos=q, t=t)
    obs = spec._observe(st)
    policy = env.random_policy()
    nq, nu = spec.nq, spec.robot.action_dim
    rec = {"qpos": torch.empty(MAIN_STEPS, B, nq, device="cuda"),
           "qvel": torch.empty(MAIN_STEPS, B, nq, device="cuda"),
           "t": torch.empty(MAIN_STEPS, B, dtype=torch.int32, device="cuda"),
           "act": torch.empty(MAIN_STEPS, B, nu, device="cuda")}
    episodes = torch.zeros((), dtype=torch.int64, device="cuda")
    terms = torch.zeros((), dtype=torch.int64, device="cuda")
    live_exact, strides = True, set()
    for k in range(MAIN_STEPS):
        act = policy(obs, gen)
        for name, x in (("qpos", st.qpos), ("qvel", st.qvel), ("t", st.t),
                        ("act", act)):
            rec[name][k] = x
        if k in SWIMMER_LIVE_STEPS:
            plain = swimmer_step_plain(ks, st.qpos, st.qvel, st.t, act)
            wide = [torch.zeros(B, x.shape[1] + 3, device="cuda")
                    for x in (st.qpos, st.qvel, act)]
            for w, x in zip(wide, (st.qpos, st.qvel, act)):
                w[:, :x.shape[1]] = x
            q_w, v_w, a_w = (w[:, :w.shape[1] - 3] for w in wide)
            for out in (kstep(st.qpos, st.qvel, st.t, act),
                        kstep(q_w, v_w, st.t, a_w)):
                live_exact &= all(bool(torch.equal(x, y))
                                  for x, y in zip(out, plain))
            strides.add((st.qpos.stride(0), st.qvel.stride(0), act.stride(0)))
        res = env.step(st, act)
        episodes += (res.terminated | res.truncated).sum()
        terms += res.terminated.sum()
        st, obs = res.state, res.obs
    big = lane_env.SwimmerStep(ks, SWIMMER_CHUNK * B)
    nr = spec.robot.nq
    worst = torch.zeros(4, device="cuda")
    differ = torch.zeros((), dtype=torch.int64, device="cuda")
    term_diff = torch.zeros((), dtype=torch.int64, device="cuda")
    at_limit = torch.zeros((), dtype=torch.int64, device="cuda")
    hi = float(ks.dyn.limit_hi)
    for c0 in range(0, MAIN_STEPS, SWIMMER_CHUNK):
        args = [rec[name][c0:c0 + SWIMMER_CHUNK].reshape(
            SWIMMER_CHUNK * B, *rec[name].shape[2:]).contiguous()
            for name in ("qpos", "qvel", "t", "act")]
        kern = big(*args)
        plain = swimmer_step_plain(ks, *args)
        worst = torch.maximum(worst, torch.stack([
            (kern[i].float() - plain[i].float()).abs().max() for i in range(4)]))
        differ += torch.stack([(kern[i] != plain[i]).reshape(len(args[0]), -1)
                               .any(dim=1) for i in range(5)]).any(dim=0).sum()
        term_diff += (kern[4] != plain[4]).sum()
        at_limit += (args[0][:, 3:nr].abs() > hi).any(dim=1).sum()
    e = worst.tolist()
    n_steps = MAIN_STEPS * B
    log(f"phase 13: {env_id} the env's own step wrapper ({B} envs) on the "
        f"step API's states at steps {SWIMMER_LIVE_STEPS} (row strides "
        f"{sorted(strides)}) and on copies with rows 3 wider: equal to the "
        f"plain version to the bit: {live_exact}")
    if not live_exact:
        raise SystemExit(f"swimmer step kernel disagrees with its plain version "
                         f"on the step API's states on {env_id}")
    log(f"phase 13: {env_id} swimmer step kernel vs plain, {MAIN_STEPS} "
        f"teacher-forced steps x {B} envs ({int(episodes)} episodes ended, "
        f"{int(terms)} on a goal; {int(at_limit)} env-steps with a hinge past "
        f"its limit): max |err| qpos {e[0]:.3g} qvel {e[1]:.3g} t {e[2]:.3g} "
        f"reward {e[3]:.3g} (tol {STEP_TOL}); terminated mismatches "
        f"{int(term_diff)} (tol 0); env-steps not bit-exact {int(differ)} of "
        f"{n_steps}")
    if not max(e) <= STEP_TOL or int(term_diff):
        raise SystemExit(f"swimmer step kernel disagrees with its plain version on {env_id}")
    if int(episodes) < B or int(terms) < B // 64 or int(at_limit) == 0:
        raise SystemExit(f"{env_id}: expected resets, goal hits and hinges at their limits")
    return max(e)


def swimmer_rollout_check(env_id: str, seed: int):
    """Phase 14 for one ID: the rollout kernel vs its plain version over
    ROLLOUT_STEPS steps from t spread over the episode's last steps, from
    the env's own reset states; every reset draw of the envs reset on the
    last step is the plain version's and the draw itself, to the bit."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout
    from mujoco_maze_tpu_torch.ops.swimmer_kernel import (rollout_draws,
                                                          swimmer_rollout_plain)

    env = mmt.make_batched(env_id, B)
    roll = make_fast_rollout(env, ROLLOUT_STEPS)
    st, _ = env.reset(seed)
    idx = torch.arange(B, device="cuda")
    t0 = (EPISODE_LIMIT - ROLLOUT_STEPS + idx % ROLLOUT_STEPS).to(torch.int32)
    kern = roll.per_env(st.qpos, st.qvel, t0, seed)
    plain = swimmer_rollout_plain(roll.ks, st.qpos, st.qvel, t0, seed,
                                  ROLLOUT_STEPS)
    eps_diff = int((kern[4] != plain[4]).sum())
    last = (t0 == EPISODE_LIMIT - ROLLOUT_STEPS) & (plain[2] == 0)
    _, q_r, v_r = rollout_draws(idx.to(torch.int64), ROLLOUT_STEPS - 1, seed,
                                env.spec.robot.action_dim, env.spec.nq)
    draws_exact = all(bool(torch.equal(x[last], y[last])) for x, y in (
        (kern[0], q_r), (kern[1], v_r), (plain[0], q_r), (plain[1], v_r)))
    err = max(float((kern[i].float() - plain[i].float()).abs().max())
              for i in range(4))
    n_exact = sum(bool(torch.equal(kern[i], plain[i])) for i in range(5))
    log(f"phase 14: {env_id} swimmer rollout kernel vs plain, {ROLLOUT_STEPS} "
        f"steps x {B} envs from t in [{EPISODE_LIMIT - ROLLOUT_STEPS}, "
        f"{EPISODE_LIMIT}): episodes {int(kern[4].sum())} vs "
        f"{int(plain[4].sum())}, envs whose counts differ {eps_diff} (tol 0); "
        f"reset draws of the {int(last.sum())} envs reset on the last step "
        f"({env.spec.nq} qpos and qvel each) exact: {draws_exact}; max |err| "
        f"{err:.3g} (tol {STEP_TOL}); outputs equal to the bit {n_exact} of 5")
    if (eps_diff or not draws_exact or not err <= STEP_TOL
            or int(kern[4].min()) < 1 or int(last.sum()) < B // ROLLOUT_STEPS):
        raise SystemExit(f"swimmer rollout kernel disagrees with its plain version on {env_id}")
    return err


def swimmer_main_path():
    """Phase 15: the swimmer main path through the public API, counted,
    timed and checked; then each swimmer kernel's numbers at its shapes."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,
                                           make_fast_step)
    from mujoco_maze_tpu_torch.ops.swimmer_kernel import (swimmer_rollout_plain,
                                                          swimmer_step_plain)
    from torch.profiler import ProfilerActivity, profile

    env = mmt.make_batched(SWIMMER_MAIN_ID, B)
    spec = env.spec
    policy = env.random_policy()
    gen = torch.Generator(device="cuda").manual_seed(7)
    st, obs = env.reset(7)
    fused = make_fast_rollout(env, MAIN_STEPS)
    for _ in range(3):  # warm-up
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    make_fast_rollout(env, 1)(st.qpos, st.qvel, st.t, 1)
    torch.cuda.synchronize()

    lane_env.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(MAIN_STEPS):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    ev[1].record()
    st_m, rew_m, eps_m = env.rollout_metrics(st, policy, MAIN_STEPS, gen)
    ev[2].record()
    qf, vf, tf, rew_f, eps_f = fused(st.qpos, st.qvel, st.t, 29)
    ev[3].record()
    torch.cuda.synchronize()
    launches = dict(lane_env.LAUNCHES)
    ms_api, ms_metrics, ms_fused = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    log(f"phase 15: swimmer main path {SWIMMER_MAIN_ID} x {B} envs, {MAIN_STEPS} "
        f"steps per path; launches {launches}")
    expected = {k: 0 for k in launches}
    expected.update({"swimmer_step": 2 * MAIN_STEPS, "swimmer_rollout": 1})
    if launches != expected:
        raise SystemExit(f"swimmer main path launches {launches}, expected {expected}")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase 15: {SWIMMER_MAIN_ID} env-steps/s (CUDA events): step API "
        f"{rate(ms_api):.6g}, rollout_metrics {rate(ms_metrics):.6g}, fused "
        f"rollout {rate(ms_fused):.6g} ({ms_fused:.6g} ms per 1000-step launch)")
    hinge = float(spec.robot.dyn.limit_hi)
    checks = {
        f"obs shape (B, {spec.obs_dim})": tuple(obs.shape) == (B, spec.obs_dim) == (B, 11),
        "obs finite": bool(torch.isfinite(obs).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, -1] == st.t.float() * 0.001).all()),
        "obs = (qpos[:5], qvel[:5], t)": bool(
            (obs[:, :5] == st.qpos).all() and (obs[:, 5:10] == st.qvel).all()),
        "rollout_metrics reward finite and < 0 (dist reward)": bool(
            torch.isfinite(rew_m)) and float(rew_m) < 0,
        "rollout_metrics ended >= B episodes": int(eps_m) >= B,
        "fused state finite": bool(torch.isfinite(qf).all() and torch.isfinite(vf).all()),
        f"fused hinges past their {hinge:.4g} rad limits by less than "
        f"{math.pi - hinge:.3g}": float(qf[:, 3:].abs().max()) < math.pi,
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward < 0 (dist reward)": float(rew_f) < 0,
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
    }
    log(f"phase 15: output checks {checks}")
    if not all(checks.values()):
        raise SystemExit("the swimmer main path's output failed a check")

    # the port's CUDA path against its CPU path on a small input
    n_small = 64
    cpu_env = mmt.make_batched(SWIMMER_MAIN_ID, n_small, auto_reset=False,
                               device="cpu")
    gpu_env = mmt.make_batched(SWIMMER_MAIN_ID, n_small, auto_reset=False)
    s_cpu, _ = cpu_env.reset(5)
    rng = np.random.RandomState(5)
    small_err = 0.0
    for _ in range(10):
        act = torch.as_tensor(rng.uniform(-1, 1, (n_small, 2)), dtype=torch.float32)
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        small_err = max(small_err, float((r_gpu.obs.cpu() - r_cpu.obs).abs().max()),
                        float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        if not torch.equal(r_gpu.terminated.cpu(), r_cpu.terminated):
            raise SystemExit("the swimmer CUDA path and CPU path disagree on terminated")
        s_cpu = r_cpu.state
    log(f"phase 15: CUDA path vs CPU path, {n_small} envs x 10 steps "
        f"teacher-forced: max |err| obs and reward {small_err:.3g} (tol {STEP_TOL})")
    if not small_err <= STEP_TOL:
        raise SystemExit("the swimmer CUDA path disagrees with the CPU path")

    # per-kernel numbers at the main path's shapes
    kstep = make_fast_step(env)
    ks = kstep.ks
    act = policy(obs, gen)
    ms_step = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 200)
    ms_step_plain = cuda_ms(lambda: swimmer_step_plain(ks, st.qpos, st.qvel,
                                                       st.t, act), 3)
    roll = make_fast_rollout(env, ROLLOUT_STEPS)
    ms_roll = cuda_ms(lambda: roll(st.qpos, st.qvel, st.t, 31), 20)
    ms_roll_plain = cuda_ms(lambda: swimmer_rollout_plain(
        ks, st.qpos, st.qvel, st.t, 31, ROLLOUT_STEPS), 1)
    nq, nu, nl = spec.nq, spec.robot.action_dim, ks.dyn.n_links
    n_goals = int(ks.goals.shape[0])
    tables = 4 * 9 * n_goals
    goal_dims = (ks.goals[:, 3:6] != 0).sum(dim=1).tolist()
    step_flops = swimmer_step_flops(nl, goal_dims, ks.reward_type == "dist")
    step_bound = bound(B * swimmer_bytes(nq, nu, "step") + tables,
                       B * step_flops)
    roll_bound = bound(B * swimmer_bytes(nq, nu, "rollout") + tables,
                       B * ROLLOUT_STEPS * step_flops)

    # device times, and where a step-API step's time goes: one profiled
    # window of 50 steps, then three rollout launches in the same session
    acts = [policy(obs, gen) for _ in range(50)]
    s = st
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a in acts:
            s = env.step(s, a).state
        ev[1].record()
        torch.cuda.synchronize()
        for _ in range(3):
            roll.per_env(st.qpos, st.qvel, st.t, 37)
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0
                        and "swimmer_rollout_kernel" not in e.key), reverse=True)
    busy_us = sum(t for t, _, _ in on_device)
    top = "; ".join(f"{k[:60]} {t / 50:.4g} us/step ({n / 50:.3g}/step)"
                    for t, n, k in on_device[:4])
    dev_step, n_dev = device_ms(prof, "swimmer_step_kernel")
    dev_roll, _ = device_ms(prof, "swimmer_rollout_kernel")
    log(f"phase 15: profiled {SWIMMER_MAIN_ID} step API, 50 steps in "
        f"{window_us:.6g} us: device busy {busy_us:.6g} us (idle share "
        f"{1 - busy_us / window_us:.4g}), {sum(n for _, n, _ in on_device) // 50} "
        f"kernels/step; top: {top}")
    log(f"phase 15: swimmer_step {ms_step:.6g} ms/launch, {dev_step:.6g} ms on "
        f"the device ({n_dev} launches profiled; plain {ms_step_plain:.6g} ms, "
        f"bound {step_bound[0]:.3g} ms by {step_bound[1]}, "
        f"{step_flops} fp32 operations per env-step); "
        f"swimmer_rollout {ms_roll:.6g} ms per {ROLLOUT_STEPS}-step launch, "
        f"{dev_roll:.6g} ms on the device (plain {ms_roll_plain:.6g} ms, bound "
        f"{roll_bound[0]:.3g} ms by {roll_bound[1]})")
    return {
        "step": {"name": "swimmer_step", "launches": launches["swimmer_step"],
                 "ms": ms_step, "device_ms": dev_step,
                 "plain_ms": ms_step_plain, "bound_ms": step_bound[0],
                 "bound_by": step_bound[1]},
        "rollout": {"name": "swimmer_rollout",
                    "launches": launches["swimmer_rollout"], "ms": ms_roll,
                    "device_ms": dev_roll, "plain_ms": ms_roll_plain,
                    "bound_ms": roll_bound[0], "bound_by": roll_bound[1]},
    }


def peak_phase():
    """Phase 16: the FMA-chain kernel against its plain version, on a small
    array and on the timed launch's chain count (short chains: the plain
    version rounds twice a step, the kernel once), then the card's fp32
    peak through ``roofline.fp32_peak_flops``, with the launch counts set
    to 0 just before and read just after.  The kernel's device time is
    taken with CUDA events around single launches (best of five): a
    profiler session this late in the script has recorded no launch."""
    from mujoco_maze_tpu_torch.ops import lane_env
    from mujoco_maze_tpu_torch.utils import roofline

    gen = torch.Generator(device="cuda").manual_seed(3)
    rel = err = 0.0
    for n_chk in (1 << 16, PEAK_CHAINS):
        x = torch.rand(n_chk, generator=gen, device="cuda")
        got = roofline.fma_chain(x, PEAK_CHECK_ITERS)
        want = roofline.fma_chain_plain(x, PEAK_CHECK_ITERS)
        rel = max(rel, float(((got - want).abs() / want.abs()).max()))
        err = max(err, float((got - want).abs().max()))
    lane_env.reset_launch_counts()
    peak = roofline.fp32_peak_flops()
    launches = dict(lane_env.LAUNCHES)
    n, iters = PEAK_CHAINS, PEAK_ITERS
    xb = torch.rand(n, device="cuda")
    ms = cuda_ms(lambda: roofline.fma_chain(xb, iters), 10)
    dev_ms = min(cuda_ms(lambda: roofline.fma_chain(xb, iters), 1)
                 for _ in range(5))
    ms_plain = cuda_ms(lambda: roofline.fma_chain_plain(xb, iters), 1)
    peak_bound = bound(8 * n, 2 * n * iters)
    log(f"phase 16: fma_peak vs plain, {PEAK_CHECK_ITERS} steps on 65536 and "
        f"{PEAK_CHAINS} chains: max relative error {rel:.3g} (tol "
        f"{PEAK_REL_TOL}); measured fp32 peak {peak:.6g} FLOP/s (launches "
        f"{launches}), data sheet {FP32_FLOP_S:.6g} ({peak / FP32_FLOP_S:.4g} "
        f"of it); one launch of {n} chains x {iters} FMAs {ms:.6g} ms back to "
        f"back, {dev_ms:.6g} ms alone (CUDA events; plain {ms_plain:.6g} ms, "
        f"bound {peak_bound[0]:.3g} ms by {peak_bound[1]})")
    others = any(k != "fma_peak" and c for k, c in launches.items())
    if (not rel <= PEAK_REL_TOL or launches["fma_peak"] < 1 or others
            or not 0 < peak <= 1.05 * FP32_FLOP_S):
        raise SystemExit("the fp32 peak kernel disagrees with its plain version, "
                         "was not launched, or measured an impossible peak")
    return {"name": "fma_peak", "launches": launches["fma_peak"],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": ms_plain, "bound_ms": peak_bound[0],
            "bound_by": peak_bound[1], "measured_fp32_flop_s": peak}


# ---------------------------------------------------------------------------
# phases 17-19: the Point object worlds, in a process of their own
# ---------------------------------------------------------------------------
# The object worlds' kernels (point_objects_step, point_objects_rollout) do
# the plain version's float32 operations in its order (csrc/
# point_objects.cuh, "Arithmetic"), so they agree to the bit; the bounds
# below are the ones the JAX package holds its lane form of the object
# solve to against its monolith (tests/test_object_lanes.py), and an
# env-step beyond them passes only at a knife edge: an active row in one
# version only, named, in at most KNIFE_SHARE of the env-steps.
OBJ_IDS = ("PointPush-v0", "PointBilliard-v0", "PointBlockCarry-v0",
           "PointFall-v0", "PointMultiPushSmall-v0", "PointPushMaze-v0")
OBJ_ROLL_IDS = ("PointPush-v0", "PointBilliard-v0")
OBJ_MAIN_ID = "PointPush-v0"
OBJ_WORST_ID = "PointPushMaze-v0"      # 676 candidate rows, the most
OBJ_CHECK_STEPS = 8
OBJ_QPOS_TOL = 1e-4
OBJ_QVEL_TOL = 2e-3
OBJ_FLAG = "--point-objects"           # runs phases 17-19 alone
OBJ_RESULT = "POINT_OBJECTS_RESULT "


def obj_geometry_flops(ks) -> int:
    """fp32 operations of one forward evaluation's candidate tests, counted
    from ops/object_lanes.py (a sine, cosine, square root, division, min,
    max or abs counts as one; selects and comparisons count none): the
    stage pose and its sine and cosine 8; per ball, the sphere-box test of
    each wall 22, the robot sphere 10, the arrow box 29; per block, the
    robot sphere 22, the arrow's SAT 45, each reachable wall 19 (29 with a
    z slide), each earlier block 19, each ball 22, a falling block's floor
    2; each slide limit 2."""
    o = ks.object_spec
    n = 8
    W = o.wb_c.shape[0]
    for _ in o.balls:
        n += 22 * W + 10 + 29
    for k, bk in enumerate(o.blocks):
        z = bk.dof_z >= 0
        n += 22 + 45 + (29 if z else 19) * len(bk.wall_idx) + 19 * k
        n += 22 * len(o.balls) + (2 if z else 0)
        if bk.lim is not None:
            n += 2 * 2 * sum(1 for lim in bk.lim if lim is not None)
    return n


def obj_row_flops(nd: int) -> int:
    """Per active row of one forward evaluation: its share of its contact's
    set-up (frame 20, impedance 9, J v 6 nd, k pen and rinv 5, the
    contact's point and Jacobian 16) and its own J and aref (2 nd + 4);
    then per Newton step J x - aref and J p (4 nd), the gradient and
    Hessian terms (2 nd + nd (nd + 1) + 2), and the line search's 11
    derivative evaluations (5 each)."""
    build = (20 + 9 + 6 * nd + 5 + 16) / 4 + 2 * nd + 4
    newton = 4 * nd + 2 * nd + nd * (nd + 1) + 2 + 11 * 5
    return int(build + 6 * newton)


def obj_solve_flops(nd: int) -> int:
    """Per forward evaluation, the Newton steps' fixed work: the gradient's
    and Hessian's mass terms (3 nd), the Cholesky factor (nd^3 / 3 + nd^2
    / 2 + 2 nd), the two solves (2 nd^2), p M x and p M p (6 nd), the
    bisection (44) and the update (2 nd); six Newton steps."""
    return 6 * (3 * nd + nd ** 3 // 3 + nd * nd // 2 + 2 * nd + 2 * nd * nd
                + 6 * nd + 44 + 2 * nd)


def obj_step_flops(ks, active_rows_per_eval: float) -> int:
    """fp32 operations of one object-world env step: the robot's step
    (``step_flops``), four forward evaluations (candidate tests, the
    active rows this run's data has, the solve) and the RK4 stages and
    sum (40 nd + 18)."""
    nd = ks.object_spec.nd
    per_eval = (obj_geometry_flops(ks) + obj_solve_flops(nd)
                + active_rows_per_eval * obj_row_flops(nd))
    return int(step_flops(int(ks.walls.shape[0]), int(ks.goals.shape[0]))
               + 4 * per_eval + 40 * nd + 18)


def obj_bytes(nq: int, per_launch: str) -> int:
    """Bytes each env moves per launch: qpos, qvel and t in and out, and
    the actions, reward and flag of a step (the rollout: reward sum and
    episode count)."""
    state = 2 * (8 * nq + 4)
    return state + (8 + 4 + 1 if per_launch == "step" else 4 + 4)


def obj_coverage(spec, qpos: torch.Tensor):
    """Per env at ``qpos``: a block slide within 0.02 of its travel limit
    or past it; a falling block perched (z slide at 0, on its platform);
    a falling block down at the floor (z slide within 0.05 of its lower
    limit)."""
    ks = spec.object_spec
    at_limit = torch.zeros(qpos.shape[0], dtype=torch.bool, device=qpos.device)
    perched, floor = at_limit.clone(), at_limit.clone()
    for bk, rt in zip(ks.blocks, spec.block_runtimes):
        for a, i in enumerate(rt.qpos_idx[:2]):
            if i < 0:
                continue
            lo = float(rt.xy_lo[a]) - float(rt.body_pos[a])
            hi = float(rt.xy_hi[a]) - float(rt.body_pos[a])
            at_limit |= (qpos[:, i] <= lo + 0.02) | (qpos[:, i] >= hi - 0.02)
        if rt.qpos_idx[2] >= 0:
            z = qpos[:, rt.qpos_idx[2]]
            perched |= z >= -1e-3
            floor |= z <= bk.lim[2][0] + 0.05
    return at_limit, perched, floor


def obj_knife_tail(env_id, ks, qpos, qvel, act, kbits, over):
    """For the env-steps ``over`` beyond a bound: which of them have a row
    active in one version only (a knife edge), named by the first such
    row."""
    from mujoco_maze_tpu_torch.ops import object_lanes
    from mujoco_maze_tpu_torch.ops.point_kernel import object_active_plain

    if not len(over):
        return over, []
    pa = object_active_plain(ks, qpos[over], qvel[over], act[over])
    kb = kbits[over]
    differ = (pa != kb).flatten(1).any(dim=1)
    names = object_lanes.row_names(ks.object_spec)
    notes = []
    for j in torch.nonzero(differ).flatten().tolist()[:3]:
        ev, row = (int(x) for x in torch.nonzero(pa[j] != kb[j])[0])
        who = "kernel" if bool(kb[j, ev, row]) else "plain"
        notes.append(f"env {int(over[j])}: forward evaluation {ev}, row {row} "
                     f"({names[row]}) active in the {who} only")
    return over[differ], notes


def obj_step_check(env_id: str, seed: int, phase: str = "17",
                   steps: int = OBJ_CHECK_STEPS, sweep: bool = False):
    """Phase 17 for one ID: the object-world step kernel vs its plain
    version at B envs, teacher-forced along the public step API's
    trajectory from ``point_kernel.object_states`` (the robot within reach
    of a ball or a block, moving at it; blocks at and inside their travel
    limits; the Fall block perched, at the floor or in between; t spread
    over the episode).  With ``sweep`` (the registry sweep) the envs need
    not cover anything.  Returns the worst object qpos and qvel errors (a
    knife edge's left out), the knife edges and the larger error."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.point_kernel import (object_states,
                                                        point_step_plain,
                                                        trace_bits)

    env = mmt.make_batched(env_id, B)
    spec = env.spec
    kstep = make_fast_step(env)
    ks = kstep.ks
    q, v, t = (torch.as_tensor(x, device="cuda")
               for x in object_states(spec, B, seed))
    st = EnvState(qpos=q, qvel=v, t=t)
    obs = spec._observe(st)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = env.random_policy()
    lim, perched, floor = obj_coverage(spec, q)
    robot_off = t_off = head_off = knife_heads = 0
    knife_steps, notes, exact = 0, [], 0
    eq_all, ev_all = [], []
    touching = torch.zeros(B, dtype=torch.bool, device="cuda")
    floor_rows = 4 * len(ks.object_spec.balls)
    resets = 0
    for _ in range(steps):
        act = policy(obs, gen)
        qk, vk, tk, rk, mk, tr = kstep(st.qpos, st.qvel, st.t, act, trace=True)
        qp, vp, tp, rp, mp = point_step_plain(ks, st.qpos, st.qvel, st.t, act)
        kbits = trace_bits(tr, ks.max_rows)
        touching |= kbits.sum(dim=-1).max(dim=-1).values > floor_rows
        robot_off += int(((qk[:, :3] != qp[:, :3]) | (vk[:, :3] != vp[:, :3]))
                         .any(dim=1).sum())
        t_off += int((tk != tp).sum())
        exact += int(((qk == qp).all(dim=1) & (vk == vp).all(dim=1)
                      & (rk == rp) & (mk == mp)).sum())
        eq = (qk[:, 3:] - qp[:, 3:]).abs().max(dim=1).values
        ev = (vk[:, 3:] - vp[:, 3:]).abs().max(dim=1).values
        over = torch.nonzero((eq > OBJ_QPOS_TOL) | (ev > OBJ_QVEL_TOL))[:, 0]
        knife, more = obj_knife_tail(env_id, ks, st.qpos, st.qvel, act, kbits,
                                     over)
        knife_steps += len(knife)
        notes += more
        eq[knife] = 0.0
        ev[knife] = 0.0
        eq_all.append(eq)
        ev_all.append(ev)
        if ks.obs_offset == 0:
            head_off += int(((rk != rp) | (mk != mp)).sum())
        else:
            edge = knife_edges(ks, EnvState(qpos=qp, qvel=vp, t=tp))
            bad = ((mk != mp) | ((rk - rp).abs() > OBJ_QPOS_TOL)) & ~edge
            head_off += int(bad.sum())
            knife_heads += int(((mk != mp) & edge).sum())
        res = env.step(st, act)
        resets += int((res.terminated | res.truncated).sum())
        st, obs = res.state, res.obs
    eq_all, ev_all = torch.stack(eq_all), torch.stack(ev_all)
    n = steps * B
    cover = {"touching an object": int(touching.sum()),
             "a block at a travel limit": int(lim.sum()),
             "Fall block perched": int(perched.sum()),
             "Fall block at the floor": int(floor.sum())}
    log(f"phase {phase}: {env_id} object step kernel vs plain, {steps} "
        f"teacher-forced steps x {B} envs (R = {ks.max_rows} candidate rows): "
        f"env-steps bit-exact (qpos, qvel, reward, terminated) {exact} of {n}; "
        f"robot dofs off {robot_off} (tol 0), t off {t_off} (tol 0); object "
        f"qpos median {float(eq_all.median()):.3g} max {float(eq_all.max()):.3g} "
        f"(tol {OBJ_QPOS_TOL}), qvel median {float(ev_all.median()):.3g} max "
        f"{float(ev_all.max()):.3g} (tol {OBJ_QVEL_TOL}); knife-edge env-steps "
        f"(a row active in one version only) {knife_steps} (tol "
        f"{int(KNIFE_SHARE * n)}) {notes}; heads off {head_off} (tol 0), "
        f"terminated off at a goal-threshold knife edge {knife_heads}; "
        f"envs {cover}; episodes ended {resets}")
    if (robot_off or t_off or head_off or knife_steps > KNIFE_SHARE * n
            or not float(eq_all.max()) <= OBJ_QPOS_TOL
            or not float(ev_all.max()) <= OBJ_QVEL_TOL):
        raise SystemExit(f"object step kernel disagrees with its plain version "
                         f"on {env_id}")
    blocky = bool(ks.object_spec.blocks)
    falling = any(b.dof_z >= 0 for b in ks.object_spec.blocks)
    if not sweep and (cover["touching an object"] < B // 4
            or (blocky and cover["a block at a travel limit"] < B // 10)
            or (falling and (cover["Fall block perched"] < B // 10
                             or cover["Fall block at the floor"] < B // 10))):
        raise SystemExit(f"{env_id}: expected the robot on the objects, blocks "
                         "at their limits, and perched and fallen Fall blocks")
    return {"qpos": float(eq_all.max()), "qvel": float(ev_all.max()),
            "knife_edges": knife_steps, "bit_exact": exact, "env_steps": n,
            "max": max(float(eq_all.max()), float(ev_all.max()))}


def obj_rollout_check(env_id: str, seed: int):
    """Phase 18 for one ID: the object-world rollout kernel vs its plain
    version (the same Philox stream), ROLLOUT_STEPS steps from t spread
    over the window's end, from the env's reset states: every env resets;
    the episode counts, the robot dofs and each reset draw exact; the
    world dofs of the envs that reset on the last step at 0, at rest."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout
    from mujoco_maze_tpu_torch.ops.point_kernel import (point_rollout_plain,
                                                        rollout_draws)

    env = mmt.make_batched(env_id, B)
    roll = make_fast_rollout(env, ROLLOUT_STEPS)
    st, _ = env.reset(seed)
    t0 = (EPISODE_LIMIT - ROLLOUT_STEPS
          + torch.arange(B, device="cuda") % ROLLOUT_STEPS).to(torch.int32)
    kern = roll.per_env(st.qpos, st.qvel, t0, seed)
    plain = point_rollout_plain(roll.ks, st.qpos, st.qvel, t0, seed,
                                ROLLOUT_STEPS)
    qk, vk, tk, rk, ek = kern
    qp, vp, tp, rp, ep = plain
    robot_off = int(((qk[:, :3] != qp[:, :3]) | (vk[:, :3] != vp[:, :3]))
                    .any(dim=1).sum())
    eq = float((qk[:, 3:] - qp[:, 3:]).abs().max())
    ev = float((vk[:, 3:] - vp[:, 3:]).abs().max())
    exact = int(((qk == qp).all(dim=1) & (vk == vp).all(dim=1) & (rk == rp)
                 & (tk == tp) & (ek == ep)).sum())
    last = tk == 0            # reset on the last step: the draw, world at 0
    _, q_r, v_r = rollout_draws(torch.arange(B, device="cuda"),
                                ROLLOUT_STEPS - 1, seed)
    draw_off = int(((qk[last, :3] != q_r[last]) | (vk[last, :3] != v_r[last]))
                   .any(dim=1).sum())
    world_off = int(((qk[last, 3:] != 0) | (vk[last, 3:] != 0)).any(dim=1).sum())
    eps_diff = int((ek != ep).sum())
    log(f"phase 18: {env_id} object rollout kernel vs plain, {ROLLOUT_STEPS} "
        f"steps x {B} envs from t in [{EPISODE_LIMIT - ROLLOUT_STEPS}, "
        f"{EPISODE_LIMIT}): envs bit-exact {exact} of {B}; robot dofs off "
        f"{robot_off} (tol 0); object qpos max {eq:.3g} (tol {OBJ_QPOS_TOL}), "
        f"qvel max {ev:.3g} (tol {OBJ_QVEL_TOL}); episodes {int(ek.sum())} vs "
        f"{int(ep.sum())}, envs whose counts differ {eps_diff} (tol 0); "
        f"{int(last.sum())} envs reset on the last step: reset draws off "
        f"{draw_off}, world dofs not at 0 at rest {world_off} (tol 0)")
    if (robot_off or eps_diff or draw_off or world_off or int((tk != tp).sum())
            or not eq <= OBJ_QPOS_TOL or not ev <= OBJ_QVEL_TOL):
        raise SystemExit(f"object rollout kernel disagrees with its plain "
                         f"version on {env_id}")
    if int(ek.sum()) < B or int(last.sum()) == 0:
        raise SystemExit(f"{env_id}: expected every env to reset in the window")
    return max(eq, ev)


def obj_kernel_numbers(env_id: str, prof_steps: bool):
    """The object kernels' times at B envs on ``env_id``: per launch by
    CUDA events (step: 50 back to back; rollout: one 1000-step and one
    ROLLOUT_STEPS-step launch), and on the device (profiler); the mean
    active rows of a step (from a traced launch) and the bounds."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import make_fast_rollout, make_fast_step
    from mujoco_maze_tpu_torch.ops.point_kernel import trace_bits
    from torch.profiler import ProfilerActivity, profile

    env = mmt.make_batched(env_id, B)
    kstep = make_fast_step(env)
    ks = kstep.ks
    gen = torch.Generator(device="cuda").manual_seed(17)
    policy = env.random_policy()
    st, obs = env.reset(17)
    for _ in range(20):      # leave the start: the robot among the objects
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    act = policy(obs, gen)
    tr = kstep(st.qpos, st.qvel, st.t, act, trace=True)[-1]
    rows = float(trace_bits(tr, ks.max_rows).sum(dim=-1).float().mean())
    roll = make_fast_rollout(env, MAIN_STEPS)
    roll64 = make_fast_rollout(env, ROLLOUT_STEPS)
    ms_step = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 50)
    ms_roll = cuda_ms(lambda: roll.per_env(st.qpos, st.qvel, st.t, 19), 1)
    ms_roll64 = cuda_ms(lambda: roll64.per_env(st.qpos, st.qvel, st.t, 19), 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kstep(st.qpos, st.qvel, st.t, act)
        roll64.per_env(st.qpos, st.qvel, st.t, 19)
        torch.cuda.synchronize()
    dev_step, n_step = device_ms(prof, "point_obj_step_kernel")
    dev_roll64, _ = device_ms(prof, "point_obj_rollout_kernel")
    flops = obj_step_flops(ks, rows)
    nq = 3 + ks.n_world
    tables = 4 * (4 * ks.walls.shape[0] + 9 * ks.goals.shape[0]
                  + ks.obj_table.numel())
    step_bound = bound(B * obj_bytes(nq, "step") + tables, B * flops)
    roll_bound = bound(B * obj_bytes(nq, "rollout") + tables,
                       B * MAIN_STEPS * flops)
    roll64_bound = bound(B * obj_bytes(nq, "rollout") + tables,
                         B * ROLLOUT_STEPS * flops)
    log(f"phase 19: {env_id} point_objects_step {ms_step:.6g} ms/launch, "
        f"{dev_step:.6g} ms on the device ({n_step} profiled), bound "
        f"{step_bound[0]:.3g} ms by {step_bound[1]} ({flops} fp32 operations "
        f"per env-step at {rows:.4g} active rows per forward evaluation, R = "
        f"{ks.max_rows}); point_objects_rollout {ms_roll:.6g} ms per "
        f"{MAIN_STEPS}-step launch (bound {roll_bound[0]:.3g} ms), {ms_roll64:.6g} "
        f"ms per {ROLLOUT_STEPS}-step launch, {dev_roll64:.6g} ms on the device "
        f"(bound {roll64_bound[0]:.3g} ms)")
    return {"ms_step": ms_step, "dev_step": dev_step, "step_bound": step_bound,
            "ms_roll": ms_roll, "roll_bound": roll_bound, "ms_roll64": ms_roll64,
            "dev_roll64": dev_roll64, "roll64_bound": roll64_bound,
            "rows": rows, "flops": flops, "st": st, "act": act, "env": env}


def obj_main_path():
    """Phase 19: the main path, PointPush-v0 at B envs through the public
    API (step, rollout_metrics, the fused rollout), counted, timed and
    checked as in phase 4; then the kernels' numbers on PointPush-v0 and on
    PointPushMaze-v0 (676 candidate rows, the most of the 27 worlds)."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import lane_env, make_fast_rollout
    from mujoco_maze_tpu_torch.ops.point_kernel import (point_rollout_plain,
                                                        point_step_plain)
    from torch.profiler import ProfilerActivity, profile

    env = mmt.make_batched(OBJ_MAIN_ID, B)
    spec = env.spec
    policy = env.random_policy()
    gen = torch.Generator(device="cuda").manual_seed(23)
    st, obs = env.reset(23)
    fused = make_fast_rollout(env, MAIN_STEPS)
    for _ in range(5):  # warm-up
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    make_fast_rollout(env, 1)(st.qpos, st.qvel, st.t, 1)
    torch.cuda.synchronize()

    lane_env.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(MAIN_STEPS):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    ev[1].record()
    st_m, rew_m, eps_m = env.rollout_metrics(st, policy, MAIN_STEPS, gen)
    ev[2].record()
    qf, vf, tf, rew_f, eps_f = fused(st.qpos, st.qvel, st.t, 41)
    ev[3].record()
    torch.cuda.synchronize()
    launches = dict(lane_env.LAUNCHES)
    ms_api, ms_metrics, ms_fused = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    log(f"phase 19: object main path {OBJ_MAIN_ID} x {B} envs, {MAIN_STEPS} "
        f"steps per path; launches {launches}")
    expected = {k: 0 for k in launches}
    expected.update({"point_objects_step": 2 * MAIN_STEPS,
                     "point_objects_rollout": 1})
    if launches != expected:
        raise SystemExit(f"object main path launches {launches}, expected {expected}")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase 19: {OBJ_MAIN_ID} env-steps/s (CUDA events): step API "
        f"{rate(ms_api):.6g}, rollout_metrics {rate(ms_metrics):.6g}, fused "
        f"rollout {rate(ms_fused):.6g} ({ms_fused:.6g} ms per 1000-step launch)")
    xmin, xmax, ymin, ymax = spec.structure.xy_limits()
    rt = spec.block_runtimes[0]
    block = spec.block_center(qf, rt)
    checks = {
        f"obs shape (B, {spec.obs_dim})": tuple(obs.shape) == (B, spec.obs_dim) == (B, 10),
        "obs finite": bool(torch.isfinite(obs).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, -1] == st.t.float() * 0.001).all()),
        "obs block center = body + slides": bool(
            (obs[:, 3:6] == spec.block_center(st.qpos, rt)).all()),
        "rollout_metrics reward finite and < 0 (dist reward)": bool(
            torch.isfinite(rew_m)) and float(rew_m) < 0,
        "rollout_metrics ended >= B episodes": int(eps_m) >= B,
        "fused state finite": bool(torch.isfinite(qf).all() and torch.isfinite(vf).all()),
        "fused robot and block inside the maze (+-0.5)": bool(
            (qf[:, 0] > xmin - 0.5).all() and (qf[:, 0] < xmax + 0.5).all()
            and (qf[:, 1] > ymin - 0.5).all() and (qf[:, 1] < ymax + 0.5).all()
            and (block[:, 0] > xmin - 0.5).all() and (block[:, 0] < xmax + 0.5).all()
            and (block[:, 1] > ymin - 0.5).all() and (block[:, 1] < ymax + 0.5).all()),
        "fused blocks moved (some env pushed its block)": bool(
            (qf[:, 3:].abs().max(dim=1).values > 0.05).any()),
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward < 0 (dist reward)": float(rew_f) < 0,
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
    }
    log(f"phase 19: output checks {checks}")
    if not all(checks.values()):
        raise SystemExit("the object main path's output failed a check")

    # the port's CUDA path against its CPU path on a small input
    n_small = 64
    cpu_env = mmt.make_batched(OBJ_MAIN_ID, n_small, auto_reset=False, device="cpu")
    gpu_env = mmt.make_batched(OBJ_MAIN_ID, n_small, auto_reset=False)
    from mujoco_maze_tpu_torch.ops.point_kernel import object_states
    q, v, t = object_states(cpu_env.spec, n_small, 5)
    s_cpu = EnvState(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                     t=torch.as_tensor(t))
    rng = np.random.RandomState(5)
    small_err = 0.0
    for _ in range(5):
        act = torch.as_tensor(rng.uniform(-1, 1, (n_small, 2)) * [1.0, 0.25],
                              dtype=torch.float32)
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        small_err = max(small_err, float((r_gpu.obs.cpu() - r_cpu.obs).abs().max()),
                        float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        if not torch.equal(r_gpu.terminated.cpu(), r_cpu.terminated):
            raise SystemExit("the object CUDA path and CPU path disagree on terminated")
        s_cpu = r_cpu.state
    log(f"phase 19: CUDA path vs CPU path, {n_small} envs x 5 steps "
        f"teacher-forced from object states: max |err| obs and reward "
        f"{small_err:.3g} (tol {STEP_TOL})")
    if not small_err <= STEP_TOL:
        raise SystemExit("the object CUDA path disagrees with the CPU path")

    # where a step-API step's time goes: one profiled window of 50 steps
    acts = [policy(obs, gen) for _ in range(50)]
    s = st
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a in acts:
            s = env.step(s, a).state
        ev[1].record()
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _, _ in on_device)
    idle = 1 - busy_us / window_us if busy_us else float("nan")
    top = "; ".join(f"{k[:60]} {t / 50:.4g} us/step ({n / 50:.3g}/step)"
                    for t, n, k in on_device[:4])
    n_kernels = sum(n for _, n, _ in on_device) / 50
    log(f"phase 19: profiled {OBJ_MAIN_ID} step API, 50 steps in "
        f"{window_us:.6g} us: device busy {busy_us:.6g} us (idle share "
        f"{idle:.4g}), {n_kernels:.3g} kernels/step; top: {top}")

    # the kernels' numbers, and the plain versions' times at the main shapes
    main = obj_kernel_numbers(OBJ_MAIN_ID, True)
    worst = obj_kernel_numbers(OBJ_WORST_ID, False)
    ks = main["env"]._kernel_step.ks
    mst, mact = main["st"], main["act"]
    ms_step_plain = cuda_ms(lambda: point_step_plain(ks, mst.qpos, mst.qvel,
                                                     mst.t, mact), 3)
    ms_roll_plain = cuda_ms(lambda: point_rollout_plain(
        ks, mst.qpos, mst.qvel, mst.t, 19, ROLLOUT_STEPS), 1)
    log(f"phase 19: plain versions on {OBJ_MAIN_ID}: step {ms_step_plain:.6g} "
        f"ms, rollout {ms_roll_plain:.6g} ms per {ROLLOUT_STEPS} steps (CUDA "
        f"events); kernel/bound: step {main['ms_step'] / main['step_bound'][0]:.4g}x, "
        f"rollout {main['ms_roll'] / main['roll_bound'][0]:.4g}x")
    return {
        "rates": {"step_api": rate(ms_api), "rollout_metrics": rate(ms_metrics),
                  "fused": rate(ms_fused), "idle_share": idle,
                  "kernels_per_step": n_kernels},
        "step": {"name": "point_objects_step",
                 "launches": launches["point_objects_step"],
                 "ms": main["ms_step"], "device_ms": main["dev_step"],
                 "plain_ms": ms_step_plain, "bound_ms": main["step_bound"][0],
                 "bound_by": main["step_bound"][1],
                 "active_rows_per_eval": main["rows"],
                 "fp32_ops_per_env_step": main["flops"],
                 "worst_world": {"id": OBJ_WORST_ID, "ms": worst["ms_step"],
                                 "device_ms": worst["dev_step"],
                                 "bound_ms": worst["step_bound"][0],
                                 "active_rows_per_eval": worst["rows"]}},
        # per ROLLOUT_STEPS-step launch (the plain rollout takes ~0.2 s a
        # step); the 1000-step launch's time beside it
        "rollout": {"name": "point_objects_rollout",
                    "launches": launches["point_objects_rollout"],
                    "steps_per_launch": ROLLOUT_STEPS,
                    "ms": main["ms_roll64"], "device_ms": main["dev_roll64"],
                    "plain_ms": ms_roll_plain,
                    "bound_ms": main["roll64_bound"][0],
                    "bound_by": main["roll64_bound"][1],
                    "ms_per_1000_steps": main["ms_roll"],
                    "bound_ms_per_1000_steps": main["roll_bound"][0],
                    "worst_world": {"id": OBJ_WORST_ID, "ms": worst["ms_roll64"],
                                    "device_ms": worst["dev_roll64"],
                                    "bound_ms": worst["roll64_bound"][0],
                                    "ms_per_1000_steps": worst["ms_roll"]}},
    }


def point_objects_phases() -> int:
    """Phases 17-19, run in a process of their own (``python3 chip_smoke.py
    --point-objects``, started by ``main``): a fresh CUDA context and
    profiler, whose sessions late in a long process have recorded no
    launch.  Prints its result as one ``POINT_OBJECTS_RESULT {json}``
    line."""
    from mujoco_maze_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    step_err = max(obj_step_check(env_id, 91 + k)["max"]
                   for k, env_id in enumerate(OBJ_IDS))
    roll_err = max(obj_rollout_check(env_id, 97 + k)
                   for k, env_id in enumerate(OBJ_ROLL_IDS))
    out = obj_main_path()
    out["step"]["max_abs_err"] = step_err
    out["rollout"]["max_abs_err"] = roll_err
    print(OBJ_RESULT + json.dumps(out), flush=True)
    return 0


def run_child(flag: str, prefix: str, phases: str):
    """Start ``phases`` in their own process (``chip_smoke.py flag``), pass
    its log through, and return its result (its ``prefix`` line); fails
    the run if that process fails."""
    proc = subprocess.Popen([sys.executable, __file__, flag],
                            stdout=subprocess.PIPE, text=True)
    result = None
    for line in proc.stdout:
        if line.startswith(prefix):
            result = json.loads(line[len(prefix):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or result is None:
        raise SystemExit(f"phases {phases} failed (exit code {proc.returncode})")
    return result


# ---------------------------------------------------------------------------
# phases 20-23: custom robots through the generic engine kernel, without
# and with free object balls, in a process of their own
# ---------------------------------------------------------------------------
# The generic engine kernel (engine_step, csrc/engine_lane.cuh) and its
# plain version (ops/engine_kernel.py engine_step_plain: the batched engine)
# compute the same function by different algorithms, so they agree to
# float32 rounding.  The Roller worlds are held to the bounds the JAX
# package holds its generic kernel to against its XLA path
# (tests/test_engine_pallas.py): qpos 1e-5, qvel 1e-4, reward 1e-5, t and
# terminated exact.  On the card the plain version's matrix products round
# with fused multiply-adds (cuBLAS) and the kernel without (-fmad=false);
# in the Fall world the block's saturated platform and limit rows press
# with ~500 times its weight against each other, so one such rounding
# moves the block's z by ~1e-5 in a step.  An env-step beyond the bounds is
# recomputed by the plain version on the CPU (no fused multiply-add) and
# must agree there; failing that, it passes only at a knife edge (an active
# contact, limit or support row, a sphere's side of a box face or a tangent
# frame switched in one version only, by both versions' traces), in at most
# KNIFE_SHARE of the env-steps.  The Ant model's worlds through the generic
# kernel are held as phase 5 holds the Ant kernel: qpos and reward at 1e-4
# under the same rule, qvel at ANT_QVEL_TOL in ANT_QVEL_QUANTILE of the
# env-steps.
ENGINE_WORLDS = ("GoalRewardUMaze", "GoalRewardPush", "GoalRewardFall",
                 "GoalRewardBlockCarry")
ENGINE_ANT_IDS = ("AntUMaze-v0", "AntPush-v0")
ENGINE_STEPS = 16
ENGINE_ANT_STEPS = 8
ENGINE_TOL = {"qpos": 1e-5, "qvel": 1e-4, "reward": 1e-5}
ENGINE_ANT_TOL = {"qpos": 1e-4, "qvel": float("inf"), "reward": 1e-4}
# Where the random policy drives the roller into the Fall block at 10-24
# m/s, the block's saturated platform and limit rows leave float32 rounding
# of 1e-5-4e-3 in its z velocity in any implementation: the plain version
# on the card, on the CPU and from starts one ulp apart each land that far
# from the float64 step, on either side.  An env-step that neither the CPU
# recompute nor a knife edge explains is held coordinate by coordinate:
# (|kernel - float64| - bound) / spread <= ROUNDING_FACTOR, the spread
# being that coordinate's largest distance from the float64 step over the
# plain version on the card, on the CPU and on ROUNDING_SAMPLES starts
# with every coordinate moved by a relative 2^-23; such env-steps may be
# at most CONDITIONED_SHARE of the run.  Readings (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md): a clean kernel's largest ratio 1.03, a kernel whose
# support force is off by a relative 1e-5 in one branch 18.9.
ROUNDING_SAMPLES = 16
ROUNDING_FACTOR = 2.0
CONDITIONED_SHARE = 1e-2
ENGINE_FLAG = "--engine"               # runs phases 20-23 alone
FAULTS_FLAG = "--engine-faults"        # phase 20's check of planted faults
CHECK_FLAG = "--engine-check"          # phase 20 on WORLD:SEED arguments
CHECK_RESULT = "ENGINE_CHECK "
ENGINE_RESULT = "ENGINE_RESULT "
ROLLER_SCALE = 4.0                     # examples/custom_robot.py
# phases 22-23: free object balls through the generic kernel.  The Roller
# in the SmallBilliard task at the task's own scaling for engine-world
# robots (MAZE_SIZE_SCALING.ant): the ball one 2 m cell from the start.
BALL_WORLD = "GoalRewardSmallBilliard"
BALL_SCALE = 2.0
BALL_ANT_ID = "AntSmallBilliard-v0"
# The ball's bottom above the floor: at every step at least BALL_Z_SHARE
# of the balls within BALL_Z (a ball on the floor, or lifted a little by a
# strike), and none more than half its radius into the floor.  A roller
# at up to ~60 m/s launches a struck ball (its bottom rose to 2.22 m and
# sank to -0.090 into the soft floor contact in a 512-env CPU run of the
# plain engine; at least 99.4 % of the balls were within BALL_Z at every
# step).
BALL_Z = (-0.05, 0.5)
BALL_Z_SHARE = 0.99
BALL_STRUCK = 0.1                      # m/s of the ball's centre: struck


def arm_roller_spec(device):
    """The Roller with a ball-jointed capsule arm hanging from its centre,
    in the UMaze, with viscosity and fluid density set on the composed
    model: the generic kernel's BALL joints and fluid drag, which no robot
    of the repository has (the CPU tests hold the same robot against the
    JAX package, tests/_torch_engine.py)."""
    from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec
    from mujoco_maze_tpu_torch.examples.custom_robot import RollerRobot
    from mujoco_maze_tpu_torch.physics.model import BALL, Body, Geom, Joint
    from mujoco_maze_tpu_torch.tasks.library import GoalRewardUMaze

    class ArmRoller(RollerRobot):
        NAME = "ArmRoller"
        nq = 7
        nv = 6

        def build_bodies(self, torso_z: float = 0.75):
            bodies, actuators = super().build_bodies(torso_z)
            bodies.append(Body(
                name="arm", parent=0, pos=(0.0, 0.0, 0.0),
                joints=[Joint(BALL, damping=0.5, armature=0.01,
                              name="arm_ball")],
                geoms=[Geom.capsule_fromto(
                    (0, 0, 0), (0.3, 0.0, -0.35), 0.06, density=300.0,
                    contype=1, conaffinity=1, friction=(1.0, 0.5, 0.5),
                    solref=(0.02, 1.0), solimp=(0.8, 0.8, 0.01),
                    margin=0.01)]))
            return bodies, actuators

    spec = MazeEnvSpec(ArmRoller(), GoalRewardUMaze, ROLLER_SCALE,
                       inner_reward_scaling=GoalRewardUMaze.INNER_REWARD_SCALING,
                       device=device)
    spec.dynamic_model.viscosity = 0.1
    spec.dynamic_model.fluid_density = 10.0
    return spec


def engine_spec(world: str, device):
    """The env spec of a phase-20 or phase-22 world: a Roller task (the
    SmallBilliard task at BALL_SCALE, the others at ROLLER_SCALE), an Ant
    ID, or "Arm"."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec
    from mujoco_maze_tpu_torch.examples.custom_robot import RollerRobot
    from mujoco_maze_tpu_torch.tasks import library

    if world == "Arm":
        return arm_roller_spec(device)
    if world.startswith("Ant"):
        return mmt.make_spec(world, device=device)
    task = getattr(library, world)
    return MazeEnvSpec(RollerRobot(), task,
                       BALL_SCALE if world == BALL_WORLD else ROLLER_SCALE,
                       inner_reward_scaling=task.INNER_REWARD_SCALING,
                       device=device)


def _matvec_ops(x) -> int:
    """fp32 operations of R x for a 3x3 R that changes with the state:
    three rows over x's non-zero entries."""
    import numpy as np

    n = int(np.count_nonzero(np.abs(np.asarray(x)) > 0))
    return 3 * (2 * n - 1) if n else 0


def _cholesky_ops(n: int) -> int:
    """A Cholesky factor of an n x n block (pivot square roots included)."""
    return sum((n - j) * (2 * j + 1) + 1 + (n - j) for j in range(n))


def engine_structure(ks):
    """What the model's structure fixes, for engine_step_flops: per dof
    its kind ("const": a slide whose world axis is a constant coordinate
    axis; "slide": any other slide; "rot": a rotational dof), each tree's
    dofs and whether its mass matrix is a constant (every joint of the tree
    a slide on a body that never turns), per body whether it turns, and
    the constant trees' M^-1 (from the constant M of slides: the composite
    mass times the axes' dot products, plus armature)."""
    import numpy as np

    body, jnt, dof = ks.table("body"), ks.table("jnt"), ks.table("dof")
    nb, nv = len(body), ks.nv
    kind = ["const"] * nv
    axis = np.zeros((nv, 3))
    turns = [False] * nb
    r_const = [None] * nb
    for b in range(nb):
        par = int(body[b][0])
        R_rel = body[b][6:15].astype(np.float64).reshape(3, 3)
        turns[b] = par >= 0 and turns[par]
        r_const[b] = None if turns[b] else (
            R_rel if par < 0 else r_const[par] @ R_rel)
        j0, nj = int(body[b][1]), int(body[b][2])
        for jr in jnt[j0:j0 + nj]:
            jt, va = int(jr[0]), int(jr[2])
            if jt == 0:                                # free
                for k in range(3):
                    axis[va + k, k] = 1.0
                    kind[va + 3 + k] = "rot"
                turns[b], r_const[b] = True, None
            elif jt == 2:                              # slide
                if turns[b]:
                    kind[va] = "slide"
                else:
                    axis[va] = r_const[b] @ jr[3:6].astype(np.float64)
                    unit = np.sort(np.abs(axis[va]))
                    kind[va] = ("const" if np.allclose(unit, (0, 0, 1))
                                else "slide")
            else:                                      # ball, hinge
                for d in range(va, va + (3 if jt == 1 else 1)):
                    kind[d] = "rot"
                turns[b], r_const[b] = True, None
    trees = sorted({(int(d[3]), int(d[4])) for d in dof})
    const_tree, minv = {}, {}
    for lo, hi in trees:
        const_tree[(lo, hi)] = all(kind[d] != "rot" and not turns[int(dof[d][0])]
                                   for d in range(lo, hi))
        if const_tree[(lo, hi)]:
            n = hi - lo
            M = np.zeros((n, n))
            for a in range(lo, hi):
                for c in range(lo, hi):
                    # the bodies below both dofs carry both axes
                    bits = (1 << a) | (1 << c)
                    mass = sum(float(body[k][15]) for k in range(nb)
                               if int(body[k][25]) & bits == bits)
                    M[a - lo, c - lo] = mass * float(axis[a] @ axis[c])
                M[a - lo, a - lo] += float(dof[a][1])
            minv[(lo, hi)] = np.linalg.inv(M)
    return dict(kind=kind, axis=axis, turns=turns, trees=trees,
                const_tree=const_tree, minv=minv)


def engine_step_flops(ks, trace: torch.Tensor) -> float:
    """fp32 operations one env step needs, at the model's structure and
    at this run's active sets (``trace``: the kernel's (B, 4 frame_skip,
    trace_words) active sets of one step launch), averaged over the envs.
    A sine, cosine, square root, division, min or max counts as one;
    index, sign and bit work, and products with a structural 0 or +-1,
    count none.  What the structure fixes is not counted: a tree of
    slides on bodies that never turn (the Roller, the movable blocks) has
    a constant M, M^-1 and gravity bias, constant dof axes and no
    velocity products.  Per forward evaluation:
    * kinematics: a slide of a body that never turns moves its body's
      origin along a constant axis (an add per non-zero axis entry, a
      product more where it is not +-1); a turning body composes its
      frame (45 unless its rest rotation is I, and R pos unless pos = 0),
      its joints (free 25; ball 106 and hinge 170, less 36 without an
      anchor offset, less 45 for a ball and 15 for a hinge on a frame
      that does not turn yet or about a coordinate axis), its com (R
      ipos), cdof (12 a rotational dof), the velocities (12 a rotational
      dof, 6 a slide, plus 30 and 9 for their derivatives) and its
      spatial inertia about O (117; 27 with a constant rotation);
    * a turning tree's composite inertias (10 a child), M (42 a dof, 11
      an entry of its root path, 1 armature), the RNE bias (96 a body, 6
      a child, 23 a dof) and its Cholesky factor; a product M^-1 x is
      two triangular solves (2 n^2) there, and in a constant tree the
      constant M^-1's non-zero entries (one product and one add each);
    * actuation (3 an actuator), damping (2 a damped dof), fluid drag (95
      a body with mass, when on), limits (4 each, 28 more when violated),
      qacc0 and qacc (their M^-1 x, and an add per dof and force term);
    * per test sphere that meets the world its centre (R local), the
      floor (4), each static box's distance (32) and the nearest two's
      point and normal (12 each); each sphere-sphere pair's normal and
      distance (15, and the centre of a sphere that meets no static geom);
      each sphere-box pair (75; 30 on a box body that never turns); each
      falling block's support (60 + 6 a platform);
    * per active contact (from ``trace``): its frame (30), per row
      (three) the moment arm's cross product when a column turns (9, and
      3 once), its Jacobian over the non-zero columns of both root paths
      (a constant axis 0, a slide 5, a rotational dof 11), the Delassus
      diagonal (3 a column with a diagonal M^-1, else w^2 + 2w over the
      contact's w columns of a tree), J v and J qacc0 (4 a column) and 20;
      per Jacobi sweep 12 a column and 40, and J^T f once (6 a column);
      an active sphere-sphere pair's point 8 more; its columns are both
      spheres' root paths, the ball's free tree a turning tree of 6
      (its 6x6 block and bias counted above as a turning tree's);
      per evaluation with contacts one M^-1 x per sweep.
    Per step: the RK4 stages' and the final integration (2 a slide or
    hinge, 40 a quaternion, 6 a free position), 21 nv of stage sums, and
    the reward and heads (30 + 12 a goal)."""
    import numpy as np

    st = engine_structure(ks)
    kind, turns, trees = st["kind"], st["turns"], st["trees"]
    const_tree, minv = st["const_tree"], st["minv"]
    body, jnt, dof = ks.table("body"), ks.table("jnt"), ks.table("dof")
    sph, pair, dbox = ks.table("sph"), ks.table("pair"), ks.table("dbox")
    spair = ks.table("spair")
    nb, nv = len(body), ks.nv
    tree_of = {d: t for t in trees for d in range(*t)}
    chain = [int(b[25]) for b in body]

    def minv_mul(t) -> int:
        lo, hi = t
        if const_tree[t]:
            nnz = int(np.count_nonzero(np.abs(minv[t]) > 1e-12))
            return 2 * nnz - (hi - lo)
        return 2 * (hi - lo) ** 2

    def diagonal(t) -> bool:
        m = minv.get(t)
        return m is not None and np.count_nonzero(m - np.diag(np.diag(m))) == 0

    fwd = 0
    for b in range(nb):
        par = int(body[b][0])
        j0, nj = int(body[b][1]), int(body[b][2])
        joints = jnt[j0:j0 + nj]
        if not turns[b]:
            fwd += 3 * (par >= 0 and np.any(body[b][3:6] != 0))
            for jr in joints:
                ax = st["axis"][int(jr[2])]
                fwd += sum(1 + (abs(x) != 1) for x in ax if x != 0)
            fwd += int(np.count_nonzero(body[b][16:19]))
            continue
        frame_turns = par >= 0 and turns[par]
        if par >= 0:
            fwd += 45 * (not np.allclose(body[b][6:15], np.eye(3).ravel()))
            fwd += (_matvec_ops(body[b][3:6]) + 3 if frame_turns
                    else 3) * bool(np.any(body[b][3:6] != 0))
        for jr in joints:
            jt, va = int(jr[0]), int(jr[2])
            anchor = bool(np.any(jr[6:9] != 0))
            coord = np.sort(np.abs(jr[3:6])).tolist() == [0, 0, 1]
            if jt == 0:
                fwd += 25
            elif jt == 1:
                fwd += 106 - 36 * (not anchor) - 45 * (not frame_turns)
            elif jt == 3:
                fwd += 170 - 36 * (not anchor) - 15 * (coord or not frame_turns)
            elif jt == 2:
                fwd += _matvec_ops(jr[3:6]) + 6
            frame_turns = frame_turns or jt in (0, 1, 3)
        fwd += (_matvec_ops(body[b][16:19]) + 3) * bool(np.any(body[b][16:19]))
    for d in range(nv):
        turning = turns[int(dof[d][0])]
        if kind[d] == "rot":
            fwd += 12 + 12 + 30
        elif turning:
            fwd += 6 + 9
    for t in trees:
        if const_tree[t]:
            continue
        lo, hi = t
        bodies = sorted({int(dof[d][0]) for d in range(lo, hi)})
        fwd += sum(117 if turns[b] else 27 for b in bodies)
        fwd += 10 * sum(int(body[b][0]) >= 0 for b in bodies)
        fwd += sum(42 + 11 * bin(chain[int(dof[a][0])] & ((2 << a) - 1)).count("1") + 1
                   for a in range(lo, hi))
        fwd += 96 * len(bodies) + 6 * len(bodies) + 23 * (hi - lo)
        fwd += _cholesky_ops(hi - lo)
    model = ks.env_spec.dynamic_model
    if model.viscosity > 0 or model.fluid_density > 0:
        fwd += 95 * int(np.sum(body[:, 15] > 0))
    fwd += 3 * ks.nu + 2 * int(np.count_nonzero(dof[:, 2]))
    terms = 2 + (ks.n_limits > 0) + (ks.offsets["fall"][1] > 0)  # tau, fc
    fwd += 2 * sum(minv_mul(t) for t in trees) + terms * nv
    fwd += 4 * ks.n_limits
    n_box, n_pair = ks.offsets["box"][1], ks.offsets["pair"][1]
    for s in sph:
        if int(s[13]) < 0:
            continue
        b = int(s[0])
        fwd += ((_matvec_ops(s[1:4]) if turns[b] else 0) + 3) * bool(
            np.any(s[1:4] != 0))
        fwd += 4 * ks.env_spec.contact_set.has_floor + 32 * n_box
        fwd += 12 * min(n_box, 2)
    for p in spair:
        fwd += 15
        for k in (int(p[0]), int(p[1])):
            if int(sph[k][13]) < 0 and np.any(sph[k][1:4] != 0):
                fwd += (_matvec_ops(sph[k][1:4]) if turns[int(sph[k][0])]
                        else 0) + 3
    for p in pair:
        fwd += 75 if turns[int(dbox[int(p[1])][0])] else 30
    fwd += sum(60 + 6 * int(f[4]) for f in ks.table("fall"))

    def contact_ops(bits_a: int, bits_b: int, point: int) -> int:
        cols = [d for d in range(nv) if (bits_a ^ bits_b) >> d & 1]
        w = len(cols)
        turning = any(kind[d] == "rot" for d in cols)
        jac = sum({"const": 0, "slide": 5, "rot": 11}[kind[d]] for d in cols)
        dl = 0
        for t in trees:
            wt = sum(1 for d in cols if tree_of[d] == t)
            dl += 3 * wt if diagonal(t) else wt * wt + 2 * wt
        row = 9 * turning + jac + dl + 4 * w + 20
        return (30 + 3 * turning + 3 * row + ks.solver_iters * (12 * w + 40)
                + 6 * w + point)

    S = ks.n_static
    groups = int(ks.env_spec.contact_set.has_floor) + min(n_box, 2)
    cand = []
    for g in range(groups):
        for s in sph:
            if int(s[13]) >= 0:
                cand.append((g * S + int(s[13]), chain[int(s[0])], 0, 0))
    for ps, p in enumerate(spair):
        cand.append((groups * S + ps, chain[int(sph[int(p[0])][0])],
                     chain[int(sph[int(p[1])][0])], 8))
    for qp, p in enumerate(pair):
        cand.append((groups * S + len(spair) + qp,
                     chain[int(sph[int(p[0])][0])],
                     chain[int(dbox[int(p[1])][0])], 0))
    words = trace.to(torch.int64) & 0xFFFFFFFF
    B, E = words.shape[0], words.shape[1]
    nw = (ks.n_cand + 31) // 32
    per_env = 0.0
    any_active = torch.zeros(B, E, dtype=torch.bool, device=words.device)
    for i, ba, bb, point in cand:
        on = (words[:, :, i // 32] >> (i % 32)) & 1
        any_active |= on.bool()
        per_env += float(on.sum()) / B * contact_ops(ba, bb, point)
    sweeps = ks.solver_iters * sum(minv_mul(t) for t in trees)
    per_env += float(any_active.sum()) / B * sweeps
    lim = words[:, :, 3 * nw] & 0xFFFFFF
    n_viol = sum(float(((lim >> k) & 1).sum()) for k in range(ks.n_limits))
    per_env += 28 * n_viol / B
    integ = sum({0: 46, 1: 40, 2: 2, 3: 2}[int(j[0])] for j in jnt)
    return (E * fwd + per_env
            + ks.frame_skip * (4 * integ + 21 * nv)
            + 30 + 12 * ks.offsets["goal"][1])


def engine_bytes(ks) -> int:
    """Bytes per env of one step launch: it reads qpos, qvel, t and the
    actions and writes qpos, qvel, t, reward and terminated."""
    return 4 * (2 * ks.nq + 2 * ks.nv + 2 + ks.nu + 1) + 1


def rounding_ratio(ks, kern, plain, cpu, q, v, t, a, envs, tol) -> float:
    """For the env-steps ``envs``: the largest (|kernel - x| - bound) /
    spread over their qpos, qvel and reward coordinates, x being the plain
    version run in float64 from the same start and the spread each
    coordinate's largest distance from x over the plain version on the
    card (``plain``), on the CPU (``cpu``) and on ROUNDING_SAMPLES starts
    with every coordinate of qpos and qvel moved by a relative 2^-23."""
    from mujoco_maze_tpu_torch.ops import engine_kernel

    q, v, t, a = q[envs], v[envs], t[envs], a[envs]
    exact = engine_kernel.engine_step_plain(ks, q.double(), v.double(), t,
                                            a.double())
    gen = torch.Generator(device="cuda").manual_seed(0)
    nudge = lambda x: x * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, x.shape, generator=gen, device="cuda"))
    starts = [(nudge(q), nudge(v)) for _ in range(ROUNDING_SAMPLES)]
    n = len(envs)
    out = engine_kernel.engine_step_plain(
        ks, torch.cat([x for x, _ in starts]), torch.cat([y for _, y in starts]),
        t.repeat(ROUNDING_SAMPLES), a.repeat(ROUNDING_SAMPLES, 1))
    samples = [[x[envs] for x in plain], [x[envs] for x in cpu]]
    samples += [[out[i][k * n:(k + 1) * n] for i in (0, 1, 3)]
                for k in range(ROUNDING_SAMPLES)]
    worst = -math.inf
    for k, (name, x) in enumerate(zip(("qpos", "qvel", "reward"),
                                      (exact[0], exact[1], exact[3]))):
        spread = torch.stack([(smp[k].double() - x).abs()
                              for smp in samples]).max(0).values
        over = (kern[k][envs].double() - x).abs() - tol[name]
        worst = max(worst, float((over / spread.clamp_min(1e-30)).max()))
    return worst


def engine_states(spec, world: str, seed: int):
    """Start states of a phase-20 or phase-22 world at B envs, on the
    card."""
    from mujoco_maze_tpu_torch.ops import ant_kernel, engine_kernel

    if spec.ball_runtimes:
        q, v, t = engine_kernel.ball_states(spec, B, seed)
    elif world == "AntUMaze-v0":
        q, v, t = ant_kernel.contact_states(spec, B, seed)
    elif world.startswith("Ant"):
        q, v, t = ant_kernel.block_states(spec, B, seed)
    else:
        q, v, t = engine_kernel.sphere_robot_states(spec, B, seed)
    return tuple(torch.as_tensor(x, device="cuda") for x in (q, v, t))


CHECK_READINGS: dict = {}   # the last engine_step_check's rounding readings


def engine_step_check(world: str, seed: int, phase: str = "20"):
    """Phase 20 (or 22, the ball worlds) for one world: engine_step against
    engine_step_plain at B envs, teacher-forced (both start every step from
    the plain version's state), from states that put the robot on the
    floor, against wall and block faces, the blocks at and beyond their
    travel limits, the Fall block perched, over the chasm and between, the
    ball against the robot, walls and corners, spinning, or on the goal,
    with t spread over the episode.  Returns the max error."""
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT, EnvState
    from mujoco_maze_tpu_torch.ops import engine_kernel, lane_env

    ant = world.startswith("Ant")
    tol = ENGINE_ANT_TOL if ant else ENGINE_TOL
    steps = ENGINE_ANT_STEPS if ant or world == "Arm" else ENGINE_STEPS
    spec = engine_spec(world, "cuda")
    ks = engine_kernel.spec_from_env(spec)
    kstep = lane_env.EngineStep(ks, B)
    ks_cpu = None
    q, v, t = engine_states(spec, world, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = (float(x[0]) for x in spec.robot.action_bounds())
    nw = (ks.n_cand + 31) // 32
    errs = {"qpos": 0.0, "qvel": 0.0, "reward": 0.0}
    qv_all = []
    exact = t_mis = term_mis = knife_mis = knife_steps = cpu_steps = 0
    blow_mis = trunc = noise_steps = 0
    worst_ratio = -math.inf
    active = pair_rows = 0
    n_spair = ks.offsets["spair"][1]
    cover = {k: torch.zeros(B, dtype=torch.bool, device="cuda")
             for k in ("floor", "wall", "ball", "block", "limit",
                       "platform row")}
    knife_notes = []
    for it in range(steps):
        a = (lo + (hi - lo) * torch.rand(B, ks.nu, generator=gen,
                                         device="cuda")).contiguous()
        kq, kv, kt, kr, km, ka, ktr = kstep(q, v, t, a, count_active=True,
                                            trace=True)
        pq, pv, pt, pr, pm = engine_kernel.engine_step_plain(ks, q, v, t, a)
        words = ktr.to(torch.int64) & 0xFFFFFFFF
        act_bits = words[:, :, :nw]
        bit = lambda i: ((act_bits[:, :, i // 32] >> (i % 32)) & 1).any(dim=1)
        groups = int(spec.contact_set.has_floor) + min(ks.offsets["box"][1], 2)
        for k in range(ks.n_static):
            if spec.contact_set.has_floor:
                cover["floor"] |= bit(k)
            for g in range(int(spec.contact_set.has_floor), groups):
                cover["wall"] |= bit(g * ks.n_static + k)
        for p in range(n_spair):
            on = (act_bits[:, :, (groups * ks.n_static + p) // 32]
                  >> ((groups * ks.n_static + p) % 32)) & 1
            pair_rows += int(on.sum())
            cover["ball"] |= on.any(dim=1).bool()
        for p in range(ks.offsets["pair"][1]):
            cover["block"] |= bit(groups * ks.n_static + n_spair + p)
        last = words[:, :, 3 * nw]
        cover["limit"] |= ((last & 0xFFFFFF) != 0).any(dim=1)
        sup = (last >> 24) & 3
        cover["platform row"] |= ((sup == 1) | (sup == 3)).any(dim=1)
        active += int(ka.sum())
        blown_k = ~torch.isfinite(kq).all(1) | ~torch.isfinite(kv).all(1) | (
            kv.abs().max(1).values > BLOWN_QVEL)
        blown_p = ~torch.isfinite(pq).all(1) | ~torch.isfinite(pv).all(1) | (
            pv.abs().max(1).values > BLOWN_QVEL)
        blow_mis += int((blown_k != blown_p).sum())
        ok = ~(blown_k | blown_p)
        zero = torch.zeros(B, device="cuda")
        eq = torch.where(ok, (kq - pq).abs().max(1).values, zero)
        ev = torch.where(ok, (kv - pv).abs().max(1).values, zero)
        er = torch.where(ok, (kr - pr).abs(), zero)
        exact += int((ok & (eq == 0) & (ev == 0) & (er == 0)).sum())
        over = torch.nonzero((eq > tol["qpos"]) | (ev > tol["qvel"])
                             | (er > tol["reward"]))[:, 0]
        if len(over):
            # recompute those env-steps by the plain version on the CPU
            if ks_cpu is None:
                ks_cpu = engine_kernel.spec_from_env(engine_spec(world, "cpu"))
            cpu = engine_kernel.engine_step_plain(
                ks_cpu, *(x[over].cpu() for x in (q, v, t, a)))
            cq, cv, cr = pq.clone(), pv.clone(), pr.clone()
            cq[over], cv[over], cr[over] = (cpu[k].cuda() for k in (0, 1, 3))
            still = ((kq[over] - cq[over]).abs().max(1).values > tol["qpos"]) | (
                (kv[over] - cv[over]).abs().max(1).values > tol["qvel"]) | (
                (kr[over] - cr[over]).abs() > tol["reward"])
            cpu_steps += int((~still).sum())
            eq[over[~still]] = 0.0
            ev[over[~still]] = 0.0
            er[over[~still]] = 0.0
            rest = over[still]
            if len(rest):
                tr_p = engine_kernel.active_trace(ks, q[rest], v[rest], a[rest])
                switch = (ktr[rest] != tr_p).flatten(1).any(dim=1)
                knife = rest[switch]
                knife_steps += len(knife)
                for e in knife[:2].tolist():
                    knife_notes.append(
                        f"step {it} env {e}: qpos {float(eq[e]):.3g} qvel "
                        f"{float(ev[e]):.3g} reward {float(er[e]):.3g}")
                eq[knife] = 0.0
                ev[knife] = 0.0
                er[knife] = 0.0
                rest = rest[~switch]
            if len(rest):
                # float32 rounding alone: each coordinate against its own
                # float32 spread
                worst_ratio = max(worst_ratio, rounding_ratio(
                    ks, (kq, kv, kr), (pq, pv, pr), (cq, cv, cr), q, v, t, a,
                    rest, tol))
                noise_steps += len(rest)
                eq[rest] = 0.0
                ev[rest] = 0.0
                er[rest] = 0.0
        errs["qpos"] = max(errs["qpos"], float(eq.max()))
        errs["reward"] = max(errs["reward"], float(er.max()))
        if ant:
            qv_all.append(ev)
        else:
            errs["qvel"] = max(errs["qvel"], float(ev.max()))
        t_mis += int((kt != pt).sum())
        edge = knife_edges(ks, EnvState(qpos=pq, qvel=pv, t=pt))
        term_mis += int(((km != pm) & ~edge & ok).sum())
        knife_mis += int(((km != pm) & edge & ok).sum())
        trunc += int((pt >= EPISODE_LIMIT).sum())
        q, v, t = pq, pv, pt
    n = steps * B
    cov = {k: int(x.sum()) for k, x in cover.items()}
    qv_note = ""
    if ant:
        qv = torch.cat(qv_all)
        errs["qvel"] = float(qv.max())
        qv_q = float(torch.quantile(qv, ANT_QVEL_QUANTILE))
        qv_note = (f"; qvel {100 * ANT_QVEL_QUANTILE:g}th percentile "
                   f"{qv_q:.3g} (tol {ANT_QVEL_TOL})")
    # the env-steps that float32 rounding alone puts beyond the bounds
    noise_ok = (noise_steps <= CONDITIONED_SHARE * n
                and worst_ratio <= ROUNDING_FACTOR)
    noise_note = (f"beyond the bounds by float32 rounding alone {noise_steps} "
                  f"(tol {int(CONDITIONED_SHARE * n)})")
    if noise_steps:
        noise_note += (f", their largest (|kernel - float64| - bound) / "
                       f"float32 spread {worst_ratio:.4g} (tol "
                       f"{ROUNDING_FACTOR:g})")
    CHECK_READINGS.update(world=world, seed=seed, rounding_steps=noise_steps,
                          rounding_ratio=worst_ratio if noise_steps else None,
                          cpu_steps=cpu_steps, knife_steps=knife_steps,
                          max_err=dict(errs), exact_steps=exact,
                          pair_rows_per_eval=pair_rows / (n * 4 * ks.frame_skip))
    log(f"phase {phase}: {world} engine_step vs plain, {steps} teacher-forced "
        f"steps x {B} envs: max |err| qpos {errs['qpos']:.3g} qvel "
        f"{errs['qvel']:.3g} reward {errs['reward']:.3g} (tol {tol}){qv_note}; "
        f"bit-exact env-steps {exact} of {n}; beyond the bounds on the card "
        f"but within them against the plain version on the CPU {cpu_steps}; "
        f"at a knife edge (a switch in one version only) {knife_steps} (tol "
        f"{int(KNIFE_SHARE * n)}){': ' + '; '.join(knife_notes) if knife_notes else ''}; "
        f"t mismatches {t_mis} (tol 0), terminated {term_mis} (tol 0) and "
        f"{knife_mis} at goal-threshold knife edges; {noise_note}; "
        f"env-steps past t = 1000 "
        f"{trunc}; blown up in one version only {blow_mis} (tol 0); envs "
        f"seen {cov}; active contacts per env-step {active / n:.4g}"
        + (f"; active sphere-sphere pair rows per forward evaluation "
           f"{pair_rows / (n * 4 * ks.frame_skip):.4g}" if n_spair else ""))
    bad = (not errs["qpos"] <= tol["qpos"] or not errs["reward"] <= tol["reward"]
           or t_mis or term_mis or blow_mis or knife_steps > KNIFE_SHARE * n
           or not noise_ok)
    if ant:
        bad = bad or not qv_q <= ANT_QVEL_TOL or not errs["qvel"] < BLOWN_QVEL
    else:
        bad = bad or not errs["qvel"] <= tol["qvel"]
    if bad:
        raise SystemExit(f"engine_step disagrees with its plain version on {world}")
    # the robot stands on the floor, or on the elevated floor's boxes
    need = {"wall": 1}
    need["floor" if spec.structure.height_offset == 0 else "wall"] = B // 2
    if spec.block_runtimes:
        need.update({"block": 1, "limit": 1})
    if n_spair:
        need["ball"] = 1
    if spec._falling_support:
        need["platform row"] = 1
    if any(cov[k] < m for k, m in need.items()) or trunc == 0:
        raise SystemExit(f"{world}: expected the floor, walls, the ball, blocks, "
                         "limits, the Fall block's platform and truncations")
    return max(errs["qpos"], errs["reward"],
               errs["qvel"] if not ant else 0.0)



def engine_api_run(env, seed: int, gen_seed: int, phase: str, name: str,
                   kernel: str = "engine_step", fused=None):
    """A main path of the generic engine kernel (or of ``kernel``): ``env``
    (B envs) through the public step API and rollout_metrics, MAIN_STEPS
    steps each from the same seeds (``env.reset(seed)``, the policy's
    generator at ``gen_seed``), with auto-reset, and then, given ``fused``
    (a ``make_fast_rollout(env, MAIN_STEPS)``), one fused rollout from the
    step API's last state; the launch counts set to 0 just before and read
    just after: ``kernel`` MAIN_STEPS times a path and the fused rollout's
    kernel once, nothing else.  Returns what the runs give."""
    from mujoco_maze_tpu_torch.ops import lane_env, make_fast_rollout

    policy = env.random_policy()
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    st, obs = env.reset(seed)
    for _ in range(5):  # warm-up
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    if fused is not None:
        make_fast_rollout(env, 1)(st.qpos, st.qvel, st.t, 1)
    torch.cuda.synchronize()

    lane_env.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    st, obs = env.reset(seed)
    gen.manual_seed(gen_seed)
    st0 = st
    eps_api = torch.zeros((), dtype=torch.int64, device="cuda")
    ev[0].record()
    for _ in range(MAIN_STEPS):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
        eps_api = eps_api + (res.terminated | res.truncated).sum()
    ev[1].record()
    env.reset(seed)
    gen.manual_seed(gen_seed)
    st_m, rew_m, eps_m = env.rollout_metrics(st0, policy, MAIN_STEPS, gen)
    ev[2].record()
    out = fused(st.qpos, st.qvel, st.t, 17) if fused is not None else None
    ev[3].record()
    torch.cuda.synchronize()
    launches = dict(lane_env.LAUNCHES)
    ms_api, ms_metrics, ms_fused = (ev[i].elapsed_time(ev[i + 1])
                                    for i in range(3))
    log(f"phase {phase}: main path {name}, {MAIN_STEPS} steps per path; "
        f"launches {launches}")
    expected = {k: 0 for k in launches}
    expected[kernel] = 2 * MAIN_STEPS
    if fused is not None:
        expected[kernel.replace("_step", "_rollout")] = 1
    if launches != expected:
        raise SystemExit(f"{name} main path launches {launches}, expected "
                         f"{expected}")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase {phase}: {name} env-steps/s (CUDA events): step API "
        f"{rate(ms_api):.6g}, rollout_metrics {rate(ms_metrics):.6g}"
        + (f", fused rollout {rate(ms_fused):.6g} ({ms_fused:.6g} ms per "
           f"{MAIN_STEPS}-step launch)" if fused is not None else ""))
    return dict(policy=policy, gen=gen, st0=st0, st=st, obs=obs,
                eps_api=int(eps_api), st_m=st_m, rew_m=rew_m,
                eps_m=int(eps_m), launches=launches[kernel],
                step_api=rate(ms_api), rollout_metrics=rate(ms_metrics),
                fused=out, fused_rate=rate(ms_fused),
                fused_launches=launches.get(kernel.replace("_step", "_rollout")))


def engine_cuda_vs_cpu(cpu_env, gpu_env, state, phase: str, what: str):
    """The port's CUDA path against its CPU path: 5 steps of ``cpu_env``
    and ``gpu_env`` (no auto-reset) teacher-forced from ``state`` (numpy
    q, v, t) on the same uniform actions; obs and reward within
    ENGINE_TOL's qvel bound, terminated equal."""
    import numpy as np

    from mujoco_maze_tpu_torch.envs.env import EnvState

    n = cpu_env.num_envs
    s_cpu = EnvState(*(torch.as_tensor(x) for x in state))
    rng = np.random.RandomState(5)
    err = 0.0
    for _ in range(5):
        act = torch.as_tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32)
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        err = max(err, float((r_gpu.obs.cpu() - r_cpu.obs).abs().max()),
                  float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        if not torch.equal(r_gpu.terminated.cpu(), r_cpu.terminated):
            raise SystemExit(f"the {what} CUDA path and CPU path disagree on "
                             "terminated")
        s_cpu = r_cpu.state
    log(f"phase {phase}: CUDA path vs CPU path, {n} envs x 5 steps "
        f"teacher-forced from {what} contact states: max |err| obs and "
        f"reward {err:.3g} (tol {ENGINE_TOL['qvel']})")
    if not err <= ENGINE_TOL["qvel"]:
        raise SystemExit(f"the {what} CUDA path disagrees with the CPU path")


def engine_idle_share(env, run, phase: str, name: str,
                      kernel: str = "engine_step_kernel"):
    """Where a step-API step's time goes: one profiled window of 50 steps
    from the end of ``run``; returns the device idle share, the kernels a
    step and ``kernel``'s device ms a launch in the window."""
    from torch.profiler import ProfilerActivity, profile

    policy, gen = run["policy"], run["gen"]
    acts = [policy(run["obs"], gen) for _ in range(50)]
    s = run["st"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a in acts:
            s = env.step(s, a).state
        ev[1].record()
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(x for x, _, _ in on_device)
    idle = 1 - busy_us / window_us if busy_us else float("nan")
    n_kernels = sum(n for _, n, _ in on_device) / 50
    top = "; ".join(f"{k[:60]} {x / 50:.4g} us/step ({n / 50:.3g}/step)"
                    for x, n, k in on_device[:4])
    log(f"phase {phase}: profiled {name} step API, 50 steps in "
        f"{window_us:.6g} us: device busy {busy_us:.6g} us (idle share "
        f"{idle:.4g}), {n_kernels:.3g} kernels/step; top: {top}")
    kern = [(x, n) for x, n, k in on_device if kernel in k]
    return idle, n_kernels, (sum(x for x, _ in kern)
                             / max(sum(n for _, n in kern), 1) / 1e3)


def engine_main_path():
    """Phase 21: the main path, make_roller_umaze(B) through the public step
    API and rollout_metrics (1000 steps each, from the same seeds, with
    auto-reset), the launch counts set to 0 just before and read just
    after; checks of what comes out; engine_step's time per launch, on the
    device, its bound and its plain version's time on RollerUMaze and on
    the AntUMaze-v0 world, beside the Ant kernel's on the same state."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.examples.custom_robot import make_roller_umaze
    from mujoco_maze_tpu_torch.ops import (engine_kernel, lane_env,
                                           make_fast_step)
    from torch.profiler import ProfilerActivity, profile

    env = make_roller_umaze(B)
    spec = env.spec
    run = engine_api_run(env, 3, 5, "21", f"make_roller_umaze({B})")
    st, obs, policy, gen = run["st"], run["obs"], run["policy"], run["gen"]
    eps_api, eps_m, st_m, rew_m = (run[k] for k in ("eps_api", "eps_m",
                                                     "st_m", "rew_m"))
    r = float(spec.contact_set.sph_radius[0])
    rest_z = float(spec.dynamic_model.body_pos[0][2])
    z = st.qpos[:, 2] + rest_z
    settled = st.t >= 20
    zs = z[settled]
    cs_ = spec.contact_set
    reach = r + float(cs_.sph_margin[0] + cs_.floor_margin)  # dist < margin
    on_floor = (zs > r - 0.02) & (zs < reach)
    checks = {
        "obs shape (B, 7)": tuple(obs.shape) == (B, spec.obs_dim) == (B, 7),
        "obs and state finite": bool(torch.isfinite(obs).all()
                                     and torch.isfinite(st.qpos).all()
                                     and torch.isfinite(st.qvel).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, -1] == st.t.float() * 0.001).all()),
        "no roller through the floor (centre z > r - 0.1; a roller landing "
        "from its 0.75 start sinks ~0.035 into the soft contact)": bool(
            (z > r - 0.1).all()),
        ">= 90 % of the settled rollers on the floor (r - 0.02 < z < r + "
        "the contact margins: within the floor contact's reach)": bool(
            on_floor.float().mean() >= 0.9),
        "settled envs (t >= 20) >= B / 2": int(settled.sum()) >= B // 2,
        "rollout_metrics reward finite": bool(torch.isfinite(rew_m)),
        "episode counts equal on the same seeds": eps_api == eps_m,
        "rollout_metrics ends on the step API's state": bool(
            torch.equal(st_m.qpos, st.qpos) and torch.equal(st_m.t, st.t)),
        "episodes ended >= B (truncation at 1000)": eps_m >= B,
    }
    log(f"phase 21: output checks {checks} (episodes {eps_api} and "
        f"{eps_m}; settled rollers' centre height min {float(zs.min()):.4g}"
        f" median {float(zs.median()):.4g} max {float(zs.max()):.4g}, on the "
        f"floor {float(on_floor.float().mean()):.4g}, r = {r}, reach "
        f"{reach:.4g}; every roller's min {float(z.min()):.4g} at t = "
        f"{int(st.t[z.argmin()])})")
    if not all(checks.values()):
        raise SystemExit("the engine main path's output failed a check")

    n_small = 64
    cpu_env = make_roller_umaze(n_small, device="cpu", auto_reset=False)
    engine_cuda_vs_cpu(
        cpu_env, make_roller_umaze(n_small, auto_reset=False),
        engine_kernel.sphere_robot_states(cpu_env.spec, n_small, 5), "21",
        "RollerUMaze")
    idle, n_kernels, _ = engine_idle_share(env, run, "21", "RollerUMaze")

    # engine_step's numbers on RollerUMaze (the main path's state) and on
    # the AntUMaze-v0 world, beside the Ant kernel on the same state
    out = {"rates": {"step_api": run["step_api"],
                     "rollout_metrics": run["rollout_metrics"],
                     "idle_share": idle, "kernels_per_step": n_kernels,
                     "episodes": eps_m}}
    kstep = make_fast_step(env)
    ks = kstep.ks
    act = policy(obs, gen)
    n_act, tr = kstep(st.qpos, st.qvel, st.t, act, count_active=True,
                      trace=True)[5:]
    per_eval = float(n_act.float().mean()) / (4 * ks.frame_skip)
    ms = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 50)
    ms_plain = cuda_ms(lambda: engine_kernel.engine_step_plain(
        ks, st.qpos, st.qvel, st.t, act), 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kstep(st.qpos, st.qvel, st.t, act)
        torch.cuda.synchronize()
    dev, n_prof = device_ms(prof, "engine_step_kernel")
    flops = engine_step_flops(ks, tr)
    b = bound(B * engine_bytes(ks) + 4 * ks.packed.numel(), B * flops)
    log(f"phase 21: RollerUMaze engine_step {ms:.6g} ms/launch, {dev:.6g} ms "
        f"on the device ({n_prof} profiled), plain {ms_plain:.6g} ms; bound "
        f"{b[0]:.3g} ms by {b[1]} ({flops:.6g} fp32 operations per env-step at "
        f"{per_eval:.4g} active contacts per forward evaluation, on the "
        f"data sheet's {FP32_FLOP_S:.3g} FLOP/s; the measured peak's bound "
        f"follows phase 16); kernel/bound {ms / b[0]:.4g}x")
    out["step"] = {"name": "engine_step", "launches": run["launches"],
                   "ms": ms, "device_ms": dev, "plain_ms": ms_plain,
                   "bound_ms": b[0], "bound_by": b[1],
                   "fp32_ops_per_env_step": flops,
                   "active_contacts_per_eval": per_eval}

    ant_env = mmt.make_batched("AntUMaze-v0", B)
    ant_st, ant_obs = ant_env.reset(7)
    ant_policy = ant_env.random_policy()
    for _ in range(20):
        res = ant_env.step(ant_st, ant_policy(ant_obs, gen))
        ant_st, ant_obs = res.state, res.obs
    ant_act = ant_policy(ant_obs, gen)
    gks = engine_kernel.spec_from_env(ant_env.spec)
    gstep = lane_env.EngineStep(gks, B)
    n_act, g_tr = gstep(ant_st.qpos, ant_st.qvel, ant_st.t, ant_act,
                        count_active=True, trace=True)[5:]
    ant_per_eval = float(n_act.float().mean()) / (4 * gks.frame_skip)
    ant_kstep = make_fast_step(ant_env)
    ms_g = cuda_ms(lambda: gstep(ant_st.qpos, ant_st.qvel, ant_st.t, ant_act), 10)
    ms_a = cuda_ms(lambda: ant_kstep(ant_st.qpos, ant_st.qvel, ant_st.t,
                                     ant_act), 10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            gstep(ant_st.qpos, ant_st.qvel, ant_st.t, ant_act)
            ant_kstep(ant_st.qpos, ant_st.qvel, ant_st.t, ant_act)
        torch.cuda.synchronize()
    dev_g, _ = device_ms(prof, "engine_step_kernel")
    dev_a, _ = device_ms(prof, "ant_step_kernel")
    ms_gp = cuda_ms(lambda: engine_kernel.engine_step_plain(
        gks, ant_st.qpos, ant_st.qvel, ant_st.t, ant_act), 1)
    g_flops = engine_step_flops(gks, g_tr)
    gb = bound(B * engine_bytes(gks) + 4 * gks.packed.numel(), B * g_flops)
    log(f"phase 21: AntUMaze-v0 world: engine_step {ms_g:.6g} ms/launch, "
        f"{dev_g:.6g} ms on the device, plain {ms_gp:.6g} ms, bound "
        f"{gb[0]:.3g} ms by {gb[1]} ({g_flops:.6g} fp32 operations per env-step "
        f"at {ant_per_eval:.4g} active contacts per forward evaluation); the "
        f"Ant kernel on the same state {ms_a:.6g} ms/launch, {dev_a:.6g} ms "
        f"on the device: the topology-specific kernel is "
        f"{ms_g / ms_a:.3g}x faster")
    out["step"]["ant_world"] = {"id": "AntUMaze-v0", "ms": ms_g,
                                "device_ms": dev_g, "plain_ms": ms_gp,
                                "bound_ms": gb[0], "bound_by": gb[1],
                                "ant_step_ms": ms_a, "ant_step_device_ms": dev_a}
    return out


def ball_centre(spec, qpos, qvel):
    """The first ball's sphere centre (B, 3) and its velocity (B, 3): the
    free joint's qpos holds the body origin and quaternion, its qvel the
    origin's world velocity and the body-frame angular velocity, and the
    sphere sits at its local offset from the origin."""
    import numpy as np

    from mujoco_maze_tpu_torch.physics.engine import mat_vec

    cs = spec.contact_set
    ob = spec.ball_runtimes[0]
    a = ob.qpos_idx[0]
    model = spec.dynamic_model
    va = int(model.jnt_dofadr[list(model.jnt_qposadr).index(a)])
    s_b = int(np.flatnonzero(cs.sph_body == cs.sph_body.max())[0])
    w, x, y, z = (qpos[:, a + 3 + k] for k in range(4))
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=1).reshape(-1, 3, 3)
    off = mat_vec(R, torch.as_tensor(cs.sph_local[s_b], dtype=qpos.dtype,
                                     device=qpos.device))
    omega = mat_vec(R, qvel[:, va + 3:va + 6])
    return (qpos[:, a:a + 3] + off,
            qvel[:, va:va + 3] + torch.linalg.cross(omega, off))


def ball_band_pass(env, run, seed: int, gen_seed: int):
    """A third pass over a ball main path's step-API steps (``run`` from
    ``engine_api_run`` with ``seed`` and ``gen_seed``), read step by step:
    the first ball's sphere's bottom above the floor after every step
    (after the auto-reset fold: a reset puts the ball back at rest).
    Returns the lowest and highest bottom per env, the least share of a
    step's balls within BALL_Z, the envs whose ball was struck (its
    centre's horizontal speed above BALL_STRUCK at some step), whether
    state and obs stayed finite, the episodes ended, the radius, and the
    envs that blew up (``blown``): per env whether it did, and the state,
    t and action of the step it first did so from, and its reward summed
    over the pass."""
    spec = env.spec
    policy, gen = run["policy"], run["gen"]
    env.reset(seed)
    gen.manual_seed(gen_seed)
    s, o = run["st0"], spec._observe(run["st0"])
    r_b = float(spec.contact_set.sph_radius[-1])
    z_lo = torch.full((B,), math.inf, device="cuda")
    z_hi = torch.full((B,), -math.inf, device="cuda")
    in_band = torch.ones((), device="cuda")
    struck = torch.zeros(B, dtype=torch.bool, device="cuda")
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    eps_3 = torch.zeros((), dtype=torch.int64, device="cuda")
    ever = torch.zeros(B, dtype=torch.bool, device="cuda")
    pre = [torch.zeros_like(x) for x in (s.qpos, s.qvel, s.t)]
    pre.append(torch.zeros(B, spec.robot.action_dim, device="cuda"))
    rew_env = torch.zeros(B, device="cuda")
    for _ in range(MAIN_STEPS):
        act = policy(o, gen)
        res = env.step(s, act)
        new = blown(spec, res.state.qpos, res.state.qvel) & ~ever
        ever |= new
        pre = [torch.where(new.view(-1, *([1] * (x.dim() - 1))), x, p)
               for x, p in zip((s.qpos, s.qvel, s.t, act), pre)]
        rew_env = rew_env + res.reward
        c, cv = ball_centre(spec, res.state.qpos, res.state.qvel)
        bottom = c[:, 2] - r_b
        z_lo = torch.minimum(z_lo, bottom)
        z_hi = torch.maximum(z_hi, bottom)
        in_band = torch.minimum(in_band, ((bottom > BALL_Z[0])
                                          & (bottom < BALL_Z[1])).float().mean())
        struck |= cv[:, :2].norm(dim=1) > BALL_STRUCK
        finite &= torch.isfinite(res.state.qpos).all() & torch.isfinite(
            res.state.qvel).all() & torch.isfinite(res.obs).all()
        eps_3 = eps_3 + (res.terminated | res.truncated).sum()
        s, o = res.state, res.obs
    return (z_lo, z_hi, in_band, struck, finite, eps_3, r_b,
            dict(ever=ever, pre=pre, reward=rew_env))


def ball_main_path():
    """Phase 23: the main path, the Roller in the SmallBilliard task
    through the public step API and rollout_metrics at B envs (1000 steps
    each, from the same seeds, with auto-reset), the launch counts set to 0
    just before and read just after; checks of what comes out, the ball's
    height and strikes from a third pass; the CUDA path against the CPU
    path on a small input; the step API's device idle share; engine_step's
    time per launch, on the device, its bound and its plain version's time
    on the main path's state and on the AntSmallBilliard-v0 world."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
    from mujoco_maze_tpu_torch.ops import (engine_kernel, lane_env,
                                           make_fast_step)

    spec = engine_spec(BALL_WORLD, "cuda")
    env = BatchedMazeEnv(spec, B)
    name = f"Roller x {BALL_WORLD}({BALL_SCALE})"
    run = engine_api_run(env, 13, 15, "23", f"{name} at {B} envs")
    st, obs, policy, gen = run["st"], run["obs"], run["policy"], run["gen"]

    z_lo, z_hi, in_band, struck, finite, eps_3, r_b, _ = ball_band_pass(
        env, run, 13, 15)
    checks = {
        "obs shape (B, 10)": tuple(obs.shape) == (B, spec.obs_dim) == (B, 10),
        "no NaN or inf in state and obs over 1000 steps": bool(finite),
        "obs[3:6] = the ball's body origin": bool(torch.equal(
            obs[:, 3:6], st.qpos[:, 3:6])),
        f"at every step >= {BALL_Z_SHARE:g} of the balls' bottoms within "
        f"{BALL_Z} of the floor": float(in_band) >= BALL_Z_SHARE,
        "no ball's bottom more than half its radius into the floor": bool(
            (z_lo > -r_b / 2).all()),
        f"some env struck the ball (its centre's horizontal speed above "
        f"{BALL_STRUCK} m/s at some step)": int(struck.sum()) > 0,
        "rollout_metrics reward finite": bool(torch.isfinite(run["rew_m"])),
        "episode counts equal on the same seeds": run["eps_api"]
        == run["eps_m"] == int(eps_3),
        "rollout_metrics ends on the step API's state": bool(
            torch.equal(run["st_m"].qpos, st.qpos)
            and torch.equal(run["st_m"].t, st.t)),
        "episodes ended >= B (truncation at 1000)": run["eps_m"] >= B,
    }
    log(f"phase 23: output checks {checks} (episodes {run['eps_api']}, "
        f"{run['eps_m']}, {int(eps_3)}; the ball's bottom above the floor min "
        f"{float(z_lo.min()):.4g} max {float(z_hi.max()):.4g}, the least "
        f"share of a step's balls within {BALL_Z} {float(in_band):.6g}; envs "
        f"whose ball was struck {int(struck.sum())} of {B})")
    if not all(checks.values()):
        raise SystemExit("the ball main path's output failed a check")

    n_small = 64
    cpu_env = BatchedMazeEnv(engine_spec(BALL_WORLD, "cpu"), n_small,
                             auto_reset=False)
    engine_cuda_vs_cpu(
        cpu_env, BatchedMazeEnv(engine_spec(BALL_WORLD, "cuda"), n_small,
                                auto_reset=False),
        engine_kernel.ball_states(cpu_env.spec, n_small, 5), "23",
        "ball world")
    idle, n_kernels, window_ms = engine_idle_share(env, run, "23", name)
    out = {"rates": {"step_api": run["step_api"],
                     "rollout_metrics": run["rollout_metrics"],
                     "idle_share": idle, "kernels_per_step": n_kernels,
                     "engine_step_device_ms_in_window": window_ms,
                     "episodes": run["eps_m"], "balls_struck": int(struck.sum())},
           "launches": run["launches"]}

    # engine_step's numbers on the main path's state and on the
    # AntSmallBilliard-v0 world (ball states, legs on the ball)
    ant_spec = mmt.make_spec(BALL_ANT_ID)
    ant_ks = engine_kernel.spec_from_env(ant_spec)
    q, v, t = engine_states(ant_spec, BALL_ANT_ID, 7)
    ant_act = (-30 + 60 * torch.rand(B, ant_ks.nu, generator=gen,
                                     device="cuda")).contiguous()
    for name, ks, args in (
            ("Roller x SmallBilliard", make_fast_step(env).ks,
             (st.qpos, st.qvel, st.t, policy(obs, gen))),
            (BALL_ANT_ID + " world", ant_ks, (q, v, t, ant_act))):
        kstep = lane_env.EngineStep(ks, B)
        n_act, tr = kstep(*args, count_active=True, trace=True)[5:]
        per_eval = float(n_act.float().mean()) / (4 * ks.frame_skip)
        ms = cuda_ms(lambda: kstep(*args), 20)
        ms_plain = cuda_ms(lambda: engine_kernel.engine_step_plain(ks, *args), 1)
        # by CUDA events: this late in the process a profiler session
        # recorded no launch on the card (PERF.md section 7)
        dev = device_ms_events(lambda: kstep(*args), 5)
        flops = engine_step_flops(ks, tr)
        b = bound(B * engine_bytes(ks) + 4 * ks.packed.numel(), B * flops)
        log(f"phase 23: {name}: engine_step {ms:.6g} ms/launch, {dev:.6g} ms "
            f"on the device (CUDA events around single launches), plain "
            f"{ms_plain:.6g} ms; bound {b[0]:.3g} ms by "
            f"{b[1]} ({flops:.6g} fp32 operations per env-step at "
            f"{per_eval:.4g} active contacts per forward evaluation); "
            f"kernel/bound {ms / b[0]:.4g}x")
        out["roller" if name.startswith("Roller") else "ant_world"] = {
            "ms": ms, "device_ms": dev, "plain_ms": ms_plain, "bound_ms": b[0],
            "bound_by": b[1], "fp32_ops_per_env_step": flops,
            "active_contacts_per_eval": per_eval}
    return out


# ---------------------------------------------------------------------------
# phases 24-26: the Ant with a free object ball (AntSmallBilliard) through
# the Ant kernel's ball instantiation, in a process of its own
# ---------------------------------------------------------------------------
ANT_BALL_IDS = ("AntSmallBilliard-v0", "AntSmallBilliard-v1",
                "AntSmallBilliard-v2")      # the three reward heads
ANT_BALL_ROLL_IDS = ("AntSmallBilliard-v0", "AntSmallBilliard-v1")
ANT_BALL_MAIN_ID = "AntSmallBilliard-v0"
ANT_BALL_CHECK_STEPS = 16
BALLS_FLAG = "--ant-balls"              # runs phases 24-26 alone
BALLS_RESULT = "ANT_BALLS_RESULT "


def ant_trace_as_engine(aks, eks, trace: torch.Tensor) -> torch.Tensor:
    """The Ant kernel's trace ``(B, E, 25)`` of a ball world in the generic
    engine kernel's layout ``(B, E, 3 nw + 1)`` for ``eks`` (the same
    world's ``engine_kernel.spec_from_env``), for engine_step_flops: each
    active contact's bit (kind k of the ant's sphere s at k * n_static +
    its static index, the ball's at k * n_static + its own, the pair of
    sphere s with the ball at 3 n_static + its pair index) and each
    violated hinge limit (bit d of the Ant's word, bit k of the k-th
    limited joint in the generic one's)."""
    import numpy as np

    cs = aks.env_spec.contact_set
    model = aks.env_spec.dynamic_model
    statics = list(np.nonzero(cs.sph_vs_static)[0])
    ant = [x for x in statics if cs.sph_body[x] < 13]
    S, n = len(ant), eks.n_static
    groups = int(cs.has_floor) + min(len(cs.box_center), 2)
    ball_bit = (3 + aks.n_blk) * S
    src, dst = [], []
    for k in range(groups):
        for i, x in enumerate(ant):
            src.append(k * S + i)
            dst.append(k * n + statics.index(x))
        for x in statics:
            if cs.sph_body[x] >= 13:
                src.append(ball_bit + k)
                dst.append(k * n + statics.index(x))
    for i, x in enumerate(ant):
        (p,) = np.nonzero(cs.pair_i == x)[0]
        src.append(ball_bit + 3 + i)
        dst.append(groups * n + int(p))
    nw = (eks.n_cand + 31) // 32
    words = trace.to(torch.int64) & 0xFFFFFFFF
    ar = torch.arange(32, device=trace.device)
    bits = ((words[..., :8, None] >> ar) & 1).flatten(-2)
    out = torch.zeros(*bits.shape[:2], 32 * nw, dtype=torch.int64,
                      device=trace.device)
    out[..., dst] = bits[..., src]
    packed = (out.view(*bits.shape[:2], nw, 32) << ar).sum(dim=-1)
    lim_dofs = [int(model.jnt_dofadr[j]) for j in range(model.njnt)
                if model.jnt_limited[j] and int(model.jnt_type[j]) in (2, 3)]
    lim = sum(((words[..., 24] >> d) & 1) << k for k, d in enumerate(lim_dofs))
    result = torch.cat([packed, torch.zeros_like(packed), torch.zeros_like(
        packed), lim[..., None]], dim=-1)
    return torch.where(result >= 2 ** 31, result - 2 ** 32, result).to(torch.int32)


def ant_ball_main_path():
    """Phase 26: the main path, AntSmallBilliard-v0 at B envs through the
    public step API and rollout_metrics (MAIN_STEPS each from the same
    seeds, with auto-reset) and one fused MAIN_STEPS-step rollout, the
    launch counts set to 0 just before and read just after; checks of
    what comes out, the ball's height and strikes from a third pass; the
    CUDA path against the CPU path on a small input; the step API's device
    idle share; ant_balls_step's time per launch by envs a block, on
    the device, its bound and its plain version's time on the main path's
    state and, beside the generic engine kernel's (phase 23's), on the
    ball states with legs on the ball; ant_balls_rollout's numbers."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import (engine_kernel, lane_env,
                                           make_fast_rollout, make_fast_step)
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      ant_step_plain,
                                                      ball_states)

    env = mmt.make_batched(ANT_BALL_MAIN_ID, B)
    spec = env.spec
    name = f"{ANT_BALL_MAIN_ID} at {B} envs"
    run = engine_api_run(env, 13, 15, "26", name, kernel="ant_balls_step",
                         fused=make_fast_rollout(env, MAIN_STEPS))
    st, obs, policy, gen = run["st"], run["obs"], run["policy"], run["gen"]
    qf, vf, tf, rew_f, eps_f = run["fused"]
    z_lo, z_hi, in_band, struck, finite, eps_3, r_b, blow = ball_band_pass(
        env, run, 13, 15)
    quat_err = max(float((qf[:, a:a + 4].norm(dim=1) - 1).abs().max())
                   for a in (3, 18))
    # an env that blew up (an Ant leg driven into the ball: the engine's
    # explicit RK4, the JAX package's as the port's; ROADMAP queue 3) is
    # held to blowing up in the plain version too, from the same state and
    # action, in at most BALL_BLOWN_SHARE of the envs
    bad = torch.nonzero(blow["ever"]).flatten()
    plain_blows = True
    if len(bad):
        pq, pv, pt, pa = (x[bad] for x in blow["pre"])
        out = ant_step_plain(make_fast_step(env).ks, pq, pv, pt, pa)
        plain_blows = bool(blown(spec, out[0], out[1]).all())
        e0 = int(bad[0])
        log(f"phase 26: {len(bad)} envs blew up; the first, env {e0}, from "
            f"qpos {pq[0].tolist()}, qvel {pv[0].tolist()}, t {int(pt[0])}, "
            f"action {pa[0].tolist()}; the plain version from the same "
            f"states and actions blows up in every one: {plain_blows}")
    kept = ~blow["ever"]
    rew_kept = float(blow["reward"][kept].sum())
    checks = {
        f"obs shape (B, {spec.obs_dim})": tuple(obs.shape) == (B, spec.obs_dim)
        == (B, 33),
        f"envs that blew up at most {BALL_BLOWN_SHARE:g} of B, each blowing "
        "up in the plain version from the same state and action": len(bad)
        <= BALL_BLOWN_SHARE * B and plain_blows,
        "state and obs finite in every env that did not blow up": bool(finite)
        or bool(len(bad)),
        "obs[3:6] = the ball's body origin": bool(torch.equal(
            obs[:, 3:6], st.qpos[:, 15:18])),
        f"at every step >= {BALL_Z_SHARE:g} of the balls' bottoms within "
        f"{BALL_Z} of the floor": float(in_band) >= BALL_Z_SHARE,
        "no ball's bottom more than half its radius into the floor": bool(
            (z_lo > -r_b / 2).all()),
        f"some env struck the ball (its centre's horizontal speed above "
        f"{BALL_STRUCK} m/s at some step)": int(struck.sum()) > 0,
        "the step API's reward summed over the envs that did not blow up "
        "finite and < 0 (dist reward)": math.isfinite(rew_kept)
        and rew_kept < 0,
        "rollout_metrics reward finite, or an env blew up": bool(
            torch.isfinite(run["rew_m"])) or bool(len(bad)),
        "episode counts equal on the same seeds": run["eps_api"]
        == run["eps_m"] == int(eps_3),
        "rollout_metrics ends on the step API's state": bool(
            torch.equal(run["st_m"].qpos, st.qpos)
            and torch.equal(run["st_m"].t, st.t)),
        "episodes ended >= B (truncation at 1000)": run["eps_m"] >= B,
        "fused state finite": bool(torch.isfinite(qf).all()
                                   and torch.isfinite(vf).all()),
        "fused torso height in (0, 2)": bool(
            ((qf[:, 2] > 0) & (qf[:, 2] < 2)).all()),
        "fused quaternions (torso, ball) unit (1e-5)": quat_err < 1e-5,
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward < 0 (dist reward)": float(rew_f) < 0,
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
    }
    log(f"phase 26: output checks {checks} (episodes {run['eps_api']}, "
        f"{run['eps_m']}, {int(eps_3)}; the ball's bottom above the floor min "
        f"{float(z_lo.min()):.4g} max {float(z_hi.max()):.4g}, the least "
        f"share of a step's balls within {BALL_Z} {float(in_band):.6g}; envs "
        f"whose ball was struck {int(struck.sum())} of {B}; envs that blew "
        f"up {len(bad)} (tol {int(BALL_BLOWN_SHARE * B)}))")
    if not all(checks.values()):
        raise SystemExit("the Ant ball main path's output failed a check")

    # the port's CUDA path against its CPU path on a small input
    n_small = 16
    cpu_env = mmt.make_batched(ANT_BALL_MAIN_ID, n_small, auto_reset=False,
                               device="cpu")
    gpu_env = mmt.make_batched(ANT_BALL_MAIN_ID, n_small, auto_reset=False)
    q, v, t = (torch.as_tensor(x) for x in ball_states(cpu_env.spec, n_small, 9))
    s_cpu = EnvState(qpos=q, qvel=v, t=t)
    rng = np.random.RandomState(9)
    small_err = 0.0
    for _ in range(3):
        act = torch.as_tensor(rng.uniform(-30, 30, (n_small, 8)),
                              dtype=torch.float32)
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        small_err = max(small_err,
                        float((r_gpu.state.qpos.cpu() - r_cpu.state.qpos).abs().max()),
                        float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        if not torch.equal(r_gpu.terminated.cpu(), r_cpu.terminated):
            raise SystemExit("the Ant ball CUDA path and CPU path disagree on "
                             "terminated")
        s_cpu = r_cpu.state
    log(f"phase 26: {ANT_BALL_MAIN_ID} CUDA path vs CPU path, {n_small} envs x "
        f"3 steps teacher-forced from ball states: max |err| qpos and reward "
        f"{small_err:.3g} (tol {ANT_QPOS_TOL})")
    if not small_err <= ANT_QPOS_TOL:
        raise SystemExit("the Ant ball CUDA path disagrees with the CPU path")
    idle, n_kernels, window_ms = engine_idle_share(env, run, "26", name,
                                                   kernel="ant_step_kernel")

    # ant_balls_step's numbers: on the main path's state, and on the ball
    # states with legs on the ball that phase 23 times the generic kernel
    # on, beside the generic kernel's on the same states
    kstep = make_fast_step(env)
    ks = kstep.ks
    eks = engine_kernel.spec_from_env(spec)
    gstep = lane_env.EngineStep(eks, B)
    q23, v23, t23 = engine_states(spec, ANT_BALL_MAIN_ID, 7)
    act23 = (-30 + 60 * torch.rand(B, 8, generator=gen, device="cuda")).contiguous()
    act = policy(obs, gen)
    tables = 4 * ks.packed.numel()
    geo = lane_env.ant_geometry(ks)
    nums = {}
    for where, args in (("main path state", (st.qpos, st.qvel, st.t, act)),
                        ("ball states", (q23, v23, t23, act23))):
        group_ms = {}
        for g in ant_group_counts(ks):
            kstep.groups = g
            group_ms[g] = cuda_ms(lambda: kstep(*args), 20)
        kstep.groups = geo.groups
        ms = group_ms[geo.groups]
        dev = device_ms_events(lambda: kstep(*args), 5)
        ms_plain = cuda_ms(lambda: ant_step_plain(ks, *args), 2)
        n_act, tr = kstep(*args, count_active=True, trace=True)[5:]
        per_eval = float(n_act.float().mean()) / (4 * ks.frame_skip)
        flops = engine_step_flops(eks, ant_trace_as_engine(ks, eks, tr))
        b = bound(B * ant_bytes(ks, "step") + tables, B * flops)
        line = (f"phase 26: {ANT_BALL_MAIN_ID} on the {where}: ant_balls_step "
                f"ms per launch by envs (warps) per block {group_ms} (the "
                f"launch: {geo._asdict()}; warps an SM holds: "
                f"{lane_env.ant_resident_warps(ks)}); "
                f"{dev:.6g} ms on the device (CUDA events around single "
                f"launches), plain {ms_plain:.6g} ms; bound {b[0]:.3g} ms by "
                f"{b[1]} ({flops:.6g} fp32 operations per env-step at "
                f"{per_eval:.4g} active contacts per forward evaluation, the "
                f"generic kernel's need-based count); kernel/bound "
                f"{ms / b[0]:.4g}x")
        if where == "ball states":
            ms_g = cuda_ms(lambda: gstep(*args), 10)
            line += (f"; the generic engine kernel on the same states "
                     f"{ms_g:.6g} ms ({ms_g / ms:.3g}x)")
        log(line)
        nums[where] = {"ms": ms, "ms_by_groups": group_ms,
                       "launch": geo._asdict(),
                       "warps_per_sm": lane_env.ant_resident_warps(ks),
                       "device_ms": dev,
                       "plain_ms": ms_plain, "bound_ms": b[0],
                       "bound_by": b[1], "fp32_ops_per_env_step": flops,
                       "active_contacts_per_eval": per_eval}
        if where == "ball states":
            nums[where]["engine_step_ms"] = ms_g
    roll8 = make_fast_rollout(env, ANT_ROLL_STEPS)
    ms_roll = cuda_ms(lambda: roll8(st.qpos, st.qvel, st.t, 19), 5)
    dev_roll = device_ms_events(lambda: roll8(st.qpos, st.qvel, st.t, 19), 3)
    ms_roll_plain = cuda_ms(lambda: ant_rollout_plain(
        ks, st.qpos, st.qvel, st.t, 19, ANT_ROLL_STEPS), 1)
    active_roll = int(roll8.per_env(st.qpos, st.qvel, st.t, 19,
                                    count_active=True)[5].sum())
    # the rollout's need: the step's at no contact, ANT_ROLL_STEPS times,
    # and each active contact at the main-path step's mean need a contact
    main = nums["main path state"]
    n_act_main = main["active_contacts_per_eval"] * 4 * ks.frame_skip
    empty = engine_step_flops(eks, torch.zeros(1, 4 * ks.frame_skip, (
        (eks.n_cand + 31) // 32) * 3 + 1, dtype=torch.int32, device="cuda"))
    per_contact = (main["fp32_ops_per_env_step"] - empty) / max(n_act_main, 1e-9)
    roll_bound = bound(B * ant_bytes(ks, "rollout") + tables,
                       B * ANT_ROLL_STEPS * empty + per_contact * active_roll)
    log(f"phase 26: {ANT_BALL_MAIN_ID} ant_balls_rollout {ms_roll:.6g} ms per "
        f"{ANT_ROLL_STEPS}-step launch, {dev_roll:.6g} ms on the device (plain "
        f"{ms_roll_plain:.6g} ms, bound {roll_bound[0]:.3g} ms by "
        f"{roll_bound[1]}; {active_roll} active contacts)")
    return {
        "step": {"name": "ant_balls_step", "launches": run["launches"],
                 "ms": main["ms"], "device_ms": main["device_ms"],
                 "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                 "bound_by": main["bound_by"],
                 "fp32_ops_per_env_step": main["fp32_ops_per_env_step"],
                 "launch": main["launch"], "warps_per_sm": main["warps_per_sm"],
                 "ms_by_groups": main["ms_by_groups"],
                 "ball_states": nums["ball states"]},
        "rollout": {"name": "ant_balls_rollout",
                    "launches": run["fused_launches"], "ms": ms_roll,
                    "device_ms": dev_roll, "plain_ms": ms_roll_plain,
                    "bound_ms": roll_bound[0], "bound_by": roll_bound[1]},
        "rates": {"step_api": run["step_api"],
                  "rollout_metrics": run["rollout_metrics"],
                  "fused_rollout": run["fused_rate"], "idle_share": idle,
                  "kernels_per_step": n_kernels,
                  "ant_step_kernel_device_ms_in_window": window_ms,
                  "episodes": run["eps_m"],
                  "balls_struck": int(struck.sum())},
    }


def ant_balls_phases() -> int:
    """Phases 24-26, run in a process of their own (``python3 chip_smoke.py
    --ant-balls``, started by ``main``; it also runs alone).  Prints its
    result as one ``ANT_BALLS_RESULT {json}`` line."""
    from mujoco_maze_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.load()
    step = [ant_step_check(env_id, 141 + k, "24", 0.0, ANT_BALL_CHECK_STEPS,
                           ANT_BALL_CHECK_STEPS)
            for k, env_id in enumerate(ANT_BALL_IDS)]
    roll_err = max(ant_rollout_check(env_id, 151 + k, "25")
                   for k, env_id in enumerate(ANT_BALL_ROLL_IDS))
    out = ant_ball_main_path()
    out["step"]["max_abs_err"] = max(x["max"] for x in step)
    out["step"]["checks"] = dict(zip(ANT_BALL_IDS, step))
    out["rollout"]["max_abs_err"] = roll_err
    print(BALLS_RESULT + json.dumps(out), flush=True)
    return 0


def engine_phases() -> int:
    """Phases 20-23, run in a process of their own (``python3 chip_smoke.py
    --engine``, started by ``main``; it also runs alone).  Prints its
    result as one ``ENGINE_RESULT {json}`` line."""
    from mujoco_maze_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.load()
    worlds = ENGINE_WORLDS + ENGINE_ANT_IDS + ("Arm",)
    err = max(engine_step_check(w, 101 + k) for k, w in enumerate(worlds))
    out = engine_main_path()
    err = max([err] + [engine_step_check(w, 131 + k, phase="22")
                       for k, w in enumerate((BALL_WORLD, BALL_ANT_ID))])
    out["ball"] = ball_main_path()
    out["step"]["max_abs_err"] = err
    print(ENGINE_RESULT + json.dumps(out), flush=True)
    return 0


# Faults that --engine-faults plants, one at a time, into a copy of
# csrc/engine_lane.cuh, each with the world whose check must fail on it:
# the falling support (its both-rows branch, which most perched env-steps
# take, and its rarer single-row branches, with the size of each) on the
# Fall world (phase 20), and the sphere-sphere pair row (its margin not
# summed; its point at sphere i's centre instead of midway through the
# overlap) on the ball world (phase 22).
ENGINE_FAULTS = (
    ("both rows' net force x (1 + 1e-5)", "return both ? fc_both - fl_both",
     "return both ? (fc_both - fl_both) * 1.00001f", "GoalRewardFall:103"),
    ("platform row alone x (1 + 1e-4)", ": (use_c ? fmaxf(fc_only, 0.f)",
     ": (use_c ? fmaxf(fc_only, 0.f) * 1.0001f", "GoalRewardFall:103"),
    ("limit row alone x (1 + 1e-3)", ": (use_l ? -fmaxf(fl_only, 0.f) : 0.f)",
     ": (use_l ? -fmaxf(fl_only, 0.f) * 1.001f : 0.f)", "GoalRewardFall:103"),
    ("pair row's margin sphere i's alone, not summed",
     "const float margin = pr[2];", "const float margin = si[5];",
     f"{BALL_WORLD}:131"),
    ("pair row's point at sphere i's centre",
     "const float reach = rj + dist * 0.5f;", "const float reach = dn;",
     f"{BALL_WORLD}:131"),
)
FAULT_WORLDS = ("GoalRewardFall:103", "GoalRewardFall:203",
                f"{BALL_WORLD}:131", f"{BALL_WORLD}:231")


def engine_check(args) -> int:
    """``--engine-check WORLD:SEED ...``: phase 20's check of each world
    alone, each printing its readings as one ``ENGINE_CHECK {json}``
    line; exits non-zero at the first that fails."""
    from mujoco_maze_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.load()
    for arg in args:
        world, seed = arg.rsplit(":", 1)
        CHECK_READINGS.clear()
        passed = False
        try:
            engine_step_check(world, int(seed), phase="22" if world in (
                BALL_WORLD, BALL_ANT_ID) else "20")
            passed = True
        finally:
            print(CHECK_RESULT + json.dumps(
                {**CHECK_READINGS, "world": world, "seed": int(seed),
                 "passed": passed}), flush=True)
    return 0


def engine_faults() -> int:
    """``--engine-faults``: phase 20's Fall check and phase 22's ball-world
    check on this checkout, each at two seeds (the phase's own and
    another), which must pass, then on copies of this script and the
    package in a temporary directory with one of ENGINE_FAULTS planted in
    each, each with its world, which must fail.  Prints the readings of
    every run and, last, one JSON line of them."""
    import shutil
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))

    def run(root, worlds):
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "chip_smoke.py"), CHECK_FLAG,
             *worlds], cwd=root, stdout=subprocess.PIPE, text=True)
        readings = []
        for line in proc.stdout.splitlines():
            if line.startswith(CHECK_RESULT):
                readings.append(json.loads(line[len(CHECK_RESULT):]))
            else:
                print(line, flush=True)
        return proc.returncode, readings

    log(nvidia_smi())
    rc, clean = run(here, FAULT_WORLDS)
    ok = rc == 0 and len(clean) == len(FAULT_WORLDS)
    log(f"faults: the checkout: passed {ok} (exit code {rc}); {clean}")
    result = {"clean": clean, "faults": []}
    for name, old, new, world in ENGINE_FAULTS:
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copy(os.path.join(here, "chip_smoke.py"), tmp)
            shutil.copytree(os.path.join(here, "mujoco_maze_tpu_torch"),
                            os.path.join(tmp, "mujoco_maze_tpu_torch"),
                            ignore=shutil.ignore_patterns(".kernel_build",
                                                          "__pycache__"))
            src = os.path.join(tmp, "mujoco_maze_tpu_torch", "csrc",
                               "engine_lane.cuh")
            with open(src) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"no single site for the fault {name!r}")
            with open(src, "w") as f:
                f.write(text.replace(old, new))
            rc, readings = run(tmp, (world,))
        log(f"faults: {name}: caught {rc != 0} (exit code {rc}); {readings}")
        result["faults"].append({"fault": name, "caught": rc != 0,
                                 "readings": readings})
        ok = ok and rc != 0
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# the registry sweep (``python3 chip_smoke.py --sweep``), outside the
# default run: every registered ID's kernel against its plain version
# ---------------------------------------------------------------------------
SWEEP_FLAG = "--sweep"
SWEEP_B = 256
SWEEP_OUT = "artifacts/PORT_REGISTRY_SWEEP.json"


def point_step_once(env_id: str, seed: int) -> dict:
    """The sweep's check of an object-free Point maze: one step launch
    against the plain version, at phase 2's rule (qpos, qvel, t and reward
    within STEP_TOL, terminated exact), from states spread over the
    maze's free cells (the point anywhere in its cell, so that many press
    on a wall; its heading uniform, its velocities U(+-2)), every 16th env
    on the first goal where there is one, t uniform over the episode."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.point_kernel import point_step_plain

    env = mmt.make_batched(env_id, B)
    ms = env.spec.structure
    kstep = make_fast_step(env)
    rng = np.random.RandomState(seed)
    free = [(i, j) for i in range(ms.grid.shape[0])
            for j in range(ms.grid.shape[1]) if ms.grid[i, j] != 1]
    s, half = ms.size_scaling, ms.size_scaling / 2
    cell = rng.randint(len(free), size=B)
    q = np.zeros((B, 3), np.float32)
    for e in range(B):
        i, j = free[cell[e]]
        q[e, :2] = (j * s - ms.torso_x, i * s - ms.torso_y)
    q[:, :2] += rng.uniform(-half + 0.05, half - 0.05, (B, 2))
    q[:, 2] = rng.uniform(-math.pi, math.pi, B)
    if env.spec.task.goals:                    # none in the no-reward mazes
        q[::16, :2] = np.asarray(env.spec.task.goals[0].pos[:2])
    v = rng.uniform(-2.0, 2.0, (B, 3)).astype(np.float32)
    t = rng.randint(0, 1000, B).astype(np.int32)
    a = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32) * [1.0, 0.25]
    args = [torch.as_tensor(x, device="cuda") for x in (q, v, t, a)]
    args[3] = args[3].float()
    qk, vk, tk, rk, mk = kstep(*args)
    qp, vp, tp, rp, mp = point_step_plain(kstep.ks, *args)
    e = [float(ori_diff(qk, qp).max()), float((vk - vp).abs().max()),
         float((tk - tp).abs().max()), float((rk - rp).abs().max())]
    n_term = int((mk != mp).sum())
    log(f"sweep: {env_id} point step kernel vs plain, {B} envs: max |err| "
        f"qpos {e[0]:.3g} qvel {e[1]:.3g} t {e[2]:.3g} reward {e[3]:.3g} (tol "
        f"{STEP_TOL}); terminated mismatches {n_term} (tol 0); terminated "
        f"{int(mk.sum())}")
    if not max(e) <= STEP_TOL or n_term:
        raise SystemExit(f"point step kernel disagrees with its plain version "
                         f"on {env_id}")
    return {"qpos": e[0], "qvel": e[1], "reward": e[3], "knife_edges": 0,
            "max": max(e)}


def swimmer_step_once(env_id: str, seed: int) -> dict:
    """The sweep's check of a Swimmer or Reacher ID: one step launch
    against the plain version from phase 13's states (the env's reset,
    every 64th env on the goal, t over the episode, random actions) at
    phase 13's rule (every output within STEP_TOL, terminated exact)."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.swimmer_kernel import swimmer_step_plain

    env = mmt.make_batched(env_id, B)
    spec = env.spec
    kstep = make_fast_step(env)
    st, obs = env.reset(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = spec.heads.goals
    on_goal = torch.arange(B, device="cuda") % 64 == 0
    q = torch.where(on_goal[:, None] & (g.dim_mask[0] > 0), g.pos[0],
                    st.qpos[:, :3])
    q = torch.cat([q, st.qpos[:, 3:]], dim=1)
    t = torch.randint(0, 1000, (B,), generator=gen, device="cuda",
                      dtype=torch.int32)
    act = env.random_policy()(obs, gen)
    kern = kstep(q, st.qvel, t, act)
    plain = swimmer_step_plain(kstep.ks, q, st.qvel, t, act)
    e = [float((kern[i].float() - plain[i].float()).abs().max())
         for i in range(4)]
    n_term = int((kern[4] != plain[4]).sum())
    log(f"sweep: {env_id} swimmer step kernel vs plain, {B} envs: max |err| "
        f"qpos {e[0]:.3g} qvel {e[1]:.3g} t {e[2]:.3g} reward {e[3]:.3g} (tol "
        f"{STEP_TOL}); terminated mismatches {n_term} (tol 0)")
    if not max(e) <= STEP_TOL or n_term:
        raise SystemExit(f"swimmer step kernel disagrees with its plain "
                         f"version on {env_id}")
    return {"qpos": e[0], "qvel": e[1], "reward": e[3], "knife_edges": 0,
            "max": max(e)}


def registry_sweep(args) -> int:
    """``python3 chip_smoke.py --sweep [--out PATH]``: every registered ID
    built at SWEEP_B envs on the card (``make_batched``), its step kernel
    launched once from its family's contact-rich states and held against
    its plain version at the family's phase rule: the object-free Point
    mazes at phase 2's, the Point object worlds at phase 17's
    (``object_states``), the Ant's at phase 5's (``contact_states``), 9's
    (``block_states``) and 24's (``ball_states``), the Swimmer and the
    Reacher at phase 13's.  One JSON line per ID, then the whole as
    ``PATH`` (default SWEEP_OUT, beside the JAX package's
    REGISTRY_SWEEP.json); exits 1 if any ID fails."""
    global B
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import _build, lane_env

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    out_path = args[args.index("--out") + 1] if "--out" in args else SWEEP_OUT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    B = SWEEP_B
    device_name, smi = torch.cuda.get_device_name(0), nvidia_smi()
    log(f"sweep: device {device_name}; nvidia-smi: {smi}")
    _build.load()
    rows = []
    for k, env_id in enumerate(mmt.env_ids()):
        robot = mmt.entry(env_id).robot_name
        t0 = time.perf_counter()
        lane_env.reset_launch_counts()
        row = {"id": env_id}
        try:
            if robot == "Ant":
                spec = mmt.make_spec(env_id)
                row["family"] = ("ant balls" if spec.ball_runtimes else
                                 "ant blocks" if spec.block_runtimes else "ant")
                res = ant_step_check(env_id, 1000 + k, "sweep", 0.0, 1, 1,
                                     sweep=True)
            elif robot == "Point":
                spec = mmt.make_spec(env_id)
                if spec.object_spec is not None:
                    row["family"] = "point objects"
                    res = obj_step_check(env_id, 1000 + k, "sweep", 1,
                                         sweep=True)
                else:
                    row["family"] = "point"
                    res = point_step_once(env_id, 1000 + k)
            else:
                row["family"] = "swimmer"
                res = swimmer_step_once(env_id, 1000 + k)
            row.update(ok=True, **{key: res[key] for key in (
                "qpos", "qvel", "reward", "knife_edges") if key in res})
        except (SystemExit, Exception) as err:  # recorded, the sweep goes on
            row.update(ok=False, error=f"{type(err).__name__}: {err}")
        row["kernel"] = [n for n, c in lane_env.LAUNCHES.items() if c]
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    failed = [r["id"] for r in rows if not r["ok"]]
    summary = {"script": "python3 chip_smoke.py --sweep", "device": device_name,
               "nvidia_smi": smi, "torch": torch.__version__,
               "num_envs": SWEEP_B, "ids": len(rows),
               "passed": len(rows) - len(failed), "failed": failed,
               "families": {f: sum(r.get("family") == f for r in rows)
                            for f in sorted({r.get("family") for r in rows
                                             if r.get("family")})},
               "seconds": time.perf_counter() - T0, "rows": rows}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    log(f"sweep: {summary['passed']} of {len(rows)} IDs passed "
        f"{summary['families']}; failed {failed}; wrote {out_path}")
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# the Ant kernels of this tree against another tree's on one card: both
# held to the plain version and to each other at phases 5/9/24's rule,
# timed in turns
# ---------------------------------------------------------------------------
PROBE_FLAG = "--ant-parent-probe"       # PARENT_DIR
PROBE_OUT_FLAG = "--ant-probe-out"      # IN OUT [--time], in the probed tree
PROBE_WORLDS = ("AntUMaze-v0", "AntPush-v0", "AntFall-v0",
                "AntSmallBilliard-v0")
PROBE_STEP_REPS, PROBE_ROLL_REPS = 20, 5
# the rollout's seeds: phases 6, 10 and 25's for these IDs
PROBE_ROLL_SEEDS = {"AntUMaze-v0": 41, "AntPush-v0": 61, "AntFall-v0": 62,
                    "AntSmallBilliard-v0": 151}


def probe_inputs(path: str) -> None:
    """The probe's inputs on PROBE_WORLDS at B envs, saved to ``path``: a
    step from the family's contact-rich states (``contact_states``,
    ``block_states``, ``ball_states``) with seeded actions, and an
    ANT_ROLL_STEPS-step rollout from t spread over the episode's end (the
    object worlds' reset states, the mazes' contact states) with the seed
    of phases 6, 10 and 25, as those phases draw them."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ball_states,
                                                      block_states,
                                                      contact_states)

    out = {}
    for env_id in PROBE_WORLDS:
        env = mmt.make_batched(env_id, B)
        spec = env.spec
        draw = (ball_states if spec.ball_runtimes else block_states
                if spec.block_runtimes else contact_states)
        q, v, t = (np.asarray(x) for x in draw(spec, B, 5))
        act = np.random.RandomState(5).uniform(-30, 30, (B, 8)).astype(
            np.float32)
        seed = PROBE_ROLL_SEEDS[env_id]
        if spec.ball_runtimes or spec.block_runtimes:
            st, _ = env.reset(seed)
            qr, vr = st.qpos.cpu().numpy(), st.qvel.cpu().numpy()
        else:
            qr, vr, _ = (np.asarray(x) for x in contact_states(spec, B, seed))
        t_end = (EPISODE_LIMIT - ANT_ROLL_STEPS
                 + np.arange(B) % ANT_ROLL_STEPS).astype(np.int32)
        for k, x in (("q", q), ("v", v), ("t", t), ("a", act), ("qr", qr),
                     ("vr", vr), ("tr", t_end)):
            out[f"{env_id}/{k}"] = x
    np.savez(path, **out)


def probe_outputs(args) -> int:
    """``--ant-probe-out IN OUT [--time]``, run from the probed tree: every
    output of one Ant step launch (with its active counts and traces) and
    of one rollout launch on the inputs at IN, saved to OUT; with
    ``--time``, each world's step and rollout times instead (CUDA events
    over back-to-back launches, and around single launches for the
    device time), the launch shape, and what ``ptxas -v`` says of the Ant
    kernels."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import _build, lane_env
    from mujoco_maze_tpu_torch.ops import make_fast_rollout, make_fast_step

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    ins = np.load(args[0])
    timed = "--time" in args
    out = {}
    for env_id in PROBE_WORLDS:
        env = mmt.make_batched(env_id, B)
        x = {k: torch.as_tensor(ins[f"{env_id}/{k}"], device="cuda")
             for k in ("q", "v", "t", "a", "qr", "vr", "tr")}
        kstep = make_fast_step(env)
        roll = make_fast_rollout(env, ANT_ROLL_STEPS)
        step = lambda: kstep(x["q"], x["v"], x["t"], x["a"])
        seed = PROBE_ROLL_SEEDS[env_id]
        rollout = lambda: roll.per_env(x["qr"], x["vr"], x["tr"], seed)
        if not timed:
            res = kstep(x["q"], x["v"], x["t"], x["a"], count_active=True,
                        trace=True)
            rolled = roll.per_env(x["qr"], x["vr"], x["tr"], seed,
                                  count_active=True)
            for kind, outs in (("step", res), ("rollout", rolled)):
                for i, y in enumerate(outs):
                    out[f"{env_id}/{kind}/{i}"] = y.cpu().numpy()
            continue
        step()
        rollout()
        geo = (lane_env.ant_geometry(kstep.ks)._asdict()
               if hasattr(lane_env, "ant_geometry")
               else {"threads": kstep.block, "groups": kstep.block})
        nums = {"step_ms": cuda_ms(step, PROBE_STEP_REPS),
                "step_device_ms": device_ms_events(step, 5),
                "rollout_ms": cuda_ms(rollout, PROBE_ROLL_REPS),
                "rollout_device_ms": device_ms_events(rollout, 2), **geo}
        out[f"{env_id}/times"] = np.asarray(json.dumps(nums))
    if timed:
        report = _build.ptxas_report()
        keep, prev = [], None
        for ln in report.splitlines():
            if "Compiling entry function" in ln:
                prev = ln if "ant_step_kernel" in ln or "ant_rollout_kernel" in ln else None
                if prev:
                    keep.append(ln.strip())
            elif prev and ("Used" in ln or "stack frame" in ln):
                keep.append(ln.strip())
        out["ptxas"] = np.asarray("\n".join(keep))
    np.savez(args[1], **out)
    return 0


def probe_hold(ks, spec, ins, kern, ref):
    """One Ant step launch ``kern`` (its outputs with active counts and
    traces) held against ``ref`` (the plain version's outputs, or another
    kernel's with its traces) on the inputs ``ins``, at phases 5/9/24's
    rule: qpos 5e-3 and reward 1e-3 (in the block and ball worlds an
    env-step beyond them passes at a knife edge that the two traces name,
    or in the ball worlds within twice the plain version's own float32
    spread, in at most KNIFE_SHARE of them), qvel 5e-2 in 99.9 %, t
    exact, terminated exact but at a goal knife edge, blow-ups in both
    (ball worlds: at most BALL_BLOWN_SHARE of the envs; none in the
    mazes).  Returns (passed, numbers)."""
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops.ant_kernel import active_trace

    q, v, t, a = ins
    balls = bool(spec.ball_runtimes)
    objects = balls or bool(spec.block_runtimes)
    qk, vk, tk, rk, mk = kern[:5]
    qp, vp, tp, rp, mp = ref[:5]
    bk, bp = blown(spec, qk, vk), blown(spec, qp, vp)
    ok = ~(bk | bp)
    zero = torch.zeros_like(rk)
    eq = torch.where(ok, (qk - qp).abs().max(dim=1).values, zero)
    er = torch.where(ok, (rk - rp).abs(), zero)
    ev = torch.where(ok, (vk - vp).abs().max(dim=1).values, zero)
    raw = float(eq.max())
    knife = cond = 0
    over = torch.nonzero((eq > ANT_QPOS_TOL) | (er > ANT_REWARD_TOL))[:, 0]
    if objects and len(over):
        tr_ref = (ref[6][over] if len(ref) > 6
                  else active_trace(ks, q[over], v[over], a[over]))
        switch = (kern[6][over] != tr_ref).flatten(1).any(dim=1)
        knife = int(switch.sum())
        eq[over[switch]] = 0.0
        er[over[switch]] = 0.0
        rest = over[~switch]
        if balls and len(rest):
            ratio = ant_rounding_ratio(ks, (qk, rk), (qp, rp), q, v, t, a,
                                       rest)
            c = rest[ratio <= ROUNDING_FACTOR]
            cond = len(c)
            eq[c] = 0.0
            er[c] = 0.0
    edge = knife_edges(ks, EnvState(qpos=qp, qvel=vp, t=tp))
    nums = {"qpos": float(eq.max()), "qpos_raw": raw,
            "reward": float(er.max()),
            "qvel_quantile": float(torch.quantile(ev, ANT_QVEL_QUANTILE)),
            "qvel_max": float(ev.max()),
            "t_mismatches": int((tk != tp).sum()),
            "terminated_mismatches": int(((mk != mp) & ~edge & ok).sum()),
            "blown": int(bp.sum()), "blow_mismatches": int((bk != bp).sum()),
            "knife_edges": knife, "conditioned": cond,
            "bit_equal_envs": int(((qk == qp).all(dim=1) & (vk == vp).all(dim=1)
                                   & (rk == rp) & (mk == mp)).sum())}
    passed = (nums["qpos"] <= ANT_QPOS_TOL and nums["reward"] <= ANT_REWARD_TOL
              and nums["qvel_quantile"] <= ANT_QVEL_TOL
              and nums["qvel_max"] < 1e3 and not nums["t_mismatches"]
              and not nums["terminated_mismatches"]
              and not nums["blow_mismatches"]
              and knife + cond <= KNIFE_SHARE * B
              and (objects or not nums["blown"])
              and (not balls or nums["blown"] <= BALL_BLOWN_SHARE * B))
    return passed, nums


def ant_parent_probe(args) -> int:
    """``python3 chip_smoke.py --ant-parent-probe PARENT_DIR``: the Ant
    kernels (all three instantiations) of the tree at PARENT_DIR (a
    checkout with its own ``mujoco_maze_tpu_torch``) and of this one, each
    built from its own sources and run in a process of its own, on the
    same inputs (``probe_inputs``): each tree's step held against the
    plain version and the two against each other at phases 5/9/24's rule
    (``probe_hold``), each rollout against the plain version as phases
    6/10/25 hold it (equal episode counts, qpos 5e-3); then both trees'
    kernels timed in turns, parent, this, this, parent, and the ptxas
    lines of both trees' Ant kernels.  Prints one ``ANT_PROBE {json}``
    line."""
    import shutil
    import tempfile

    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      ant_step_plain)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = os.path.abspath(args[0])
    work = tempfile.mkdtemp()
    copy = os.path.join(parent, "_probe_chip_smoke.py")
    shutil.copy(__file__, copy)
    inputs = os.path.join(work, "inputs.npz")
    probe_inputs(inputs)
    ins = np.load(inputs)
    trees = {"parent": copy, "this": os.path.abspath(__file__)}
    got, times = {}, {"parent": [], "this": []}
    for k, tree in enumerate(("parent", "this", "this", "parent")):
        for timed in ((False, True) if k < 2 else (True,)):
            path = os.path.join(work, f"{tree}{k}{int(timed)}.npz")
            script = trees[tree]
            subprocess.run([sys.executable, script, PROBE_OUT_FLAG, inputs,
                            path] + (["--time"] if timed else []),
                           check=True, cwd=os.path.dirname(script))
            res = np.load(path)
            if timed:
                times[tree].append(res)
            else:
                got[tree] = res
    os.remove(copy)
    ok, result = True, {"worlds": {}}
    for env_id in PROBE_WORLDS:
        env = mmt.make_batched(env_id, B)
        spec = env.spec
        ks = make_fast_step(env).ks
        x = {k: torch.as_tensor(ins[f"{env_id}/{k}"], device="cuda")
             for k in ("q", "v", "t", "a", "qr", "vr", "tr")}
        step_in = (x["q"], x["v"], x["t"], x["a"])
        plain = ant_step_plain(ks, *step_in)
        roll_plain = ant_rollout_plain(ks, x["qr"], x["vr"], x["tr"],
                                       PROBE_ROLL_SEEDS[env_id],
                                       ANT_ROLL_STEPS)
        outs = {tree: [torch.as_tensor(got[tree][f"{env_id}/step/{i}"],
                                       device="cuda") for i in range(7)]
                for tree in got}
        rolls = {tree: [torch.as_tensor(got[tree][f"{env_id}/rollout/{i}"],
                                        device="cuda") for i in range(6)]
                 for tree in got}
        world = {}
        for name, kern, ref in (("parent vs plain", outs["parent"], plain),
                                ("this vs plain", outs["this"], plain),
                                ("this vs parent", outs["this"],
                                 outs["parent"])):
            passed, nums = probe_hold(ks, spec, step_in, kern, ref)
            ok = ok and passed
            world[name] = {"passed": passed, **nums}
        for tree in ("parent", "this"):
            rk = rolls[tree]
            eps_diff = int((rk[4] != roll_plain[4]).sum())
            q_err = float((rk[0] - roll_plain[0]).abs().max())
            passed = eps_diff == 0 and q_err <= ANT_QPOS_TOL
            ok = ok and passed
            world[f"{tree} rollout vs plain"] = {
                "passed": passed, "episode_mismatches": eps_diff,
                "qpos": q_err}
        world["outputs equal to the bit, this vs parent"] = sum(
            bool(np.array_equal(got["parent"][f"{env_id}/{kind}/{i}"],
                                got["this"][f"{env_id}/{kind}/{i}"],
                                equal_nan=True))
            for kind, n in (("step", 7), ("rollout", 6)) for i in range(n))
        world["active contacts of the step"] = int(outs["this"][5].sum())
        for tree in ("parent", "this"):
            runs = [json.loads(str(r[f"{env_id}/times"])) for r in times[tree]]
            world[f"{tree} times"] = {
                k: [r[k] for r in runs] for k in runs[0]}
        p_ms = np.mean(world["parent times"]["step_device_ms"])
        t_ms = np.mean(world["this times"]["step_device_ms"])
        pr_ms = np.mean(world["parent times"]["rollout_device_ms"])
        tr_ms = np.mean(world["this times"]["rollout_device_ms"])
        world["step device ms parent / this"] = float(p_ms / t_ms)
        world["rollout device ms parent / this"] = float(pr_ms / tr_ms)
        log(f"probe: {env_id}: " + json.dumps(world))
        result["worlds"][env_id] = world
    for tree in ("parent", "this"):
        result[f"{tree} ptxas"] = str(times[tree][0]["ptxas"]).splitlines()
        log(f"probe: {tree} tree's Ant kernels, ptxas -v:\n  "
            + "\n  ".join(result[f"{tree} ptxas"]))
    result["passed"] = ok
    result["device"] = torch.cuda.get_device_name(0)
    result["nvidia_smi"] = nvidia_smi()
    shutil.rmtree(work, ignore_errors=True)
    print("ANT_PROBE " + json.dumps(result), flush=True)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# where an Ant forward evaluation's time goes: the phase counters of a
# profiling build of the Ant kernels
# ---------------------------------------------------------------------------
PHASES_FLAG = "--ant-phases"
ANT_PHASES = ("kinematics", "mass matrix", "bias: RNE, actuation, the ball",
              "factor and inverse", "qacc0", "limits and block boxes",
              "contact detection", "compaction and trace", "contact rows",
              "Jacobi sweeps", "falling support", "qacc")   # enum AntPhase


def ant_phases() -> int:
    """``python3 chip_smoke.py --ant-phases``: the Ant kernels built with
    their phase counters (``-DMMT_ANT_PHASES``, into a library of its own:
    the name hashes the flags) on PROBE_WORLDS at B envs, on the main
    path's state (three public-API steps from reset, as phases 7, 12 and
    26 time the kernel) and on the family's contact-rich states: the step
    kernel's ms per launch with the counters on, and per forward
    evaluation the SM cycles (clock64) of each phase in lane 0 of each
    group, the mean over every group and evaluation of five launches.
    Prints one ``ANT_PHASES {json}`` line."""
    import ctypes

    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.ops import _build, lane_env, make_fast_step
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ball_states,
                                                      block_states,
                                                      contact_states)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DMMT_ANT_PHASES",)
    t0 = time.perf_counter()
    lib = lane_env._lib()
    log(f"phases: built {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = (ctypes.c_ulonglong * (len(ANT_PHASES) + 1))()
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi(), "worlds": {}}
    for env_id in PROBE_WORLDS:
        env = mmt.make_batched(env_id, B)
        spec = env.spec
        kstep = make_fast_step(env)
        ks = kstep.ks
        world = "_balls" if ks.n_ball else "_blocks" if ks.n_w else ""
        read = getattr(lib, f"mmt_ant{world}_phases")
        read.argtypes = [ctypes.c_void_p]
        policy = env.random_policy()
        gen = torch.Generator(device="cuda").manual_seed(5)
        st, obs = env.reset(5)
        for _ in range(3):
            res = env.step(st, policy(obs, gen))
            st, obs = res.state, res.obs
        draw = (ball_states if spec.ball_runtimes else block_states
                if spec.block_runtimes else contact_states)
        q, v, t = (torch.as_tensor(x, device="cuda")
                   for x in draw(spec, B, 5))
        act = torch.as_tensor(np.random.RandomState(5).uniform(
            -30, 30, (B, 8)), dtype=torch.float32, device="cuda")
        rows = {}
        for where, args in (("main path state", (st.qpos, st.qvel, st.t,
                                                 policy(obs, gen))),
                            ("contact-rich states", (q, v, t, act))):
            kstep(*args)
            torch.cuda.synchronize()
            if read(None):
                raise SystemExit("the phase counters could not be zeroed")
            ms = cuda_ms(lambda: kstep(*args), 5)
            if read(ctypes.addressof(counters)):
                raise SystemExit("the phase counters could not be read")
            n = counters[len(ANT_PHASES)]
            cycles = {name: counters[i] / n for i, name in enumerate(ANT_PHASES)}
            active = int(kstep(*args, count_active=True)[5].sum())
            rows[where] = {"ms": ms, "forward_evaluations": n,
                           "cycles_per_evaluation": sum(cycles.values()),
                           "active_contacts_per_evaluation":
                               active / (B * 4 * ks.frame_skip),
                           "cycles": cycles}
            log(f"phases: {env_id} on the {where}: {ms:.6g} ms/launch with "
                f"the counters on; {sum(cycles.values()):.6g} SM cycles a "
                f"forward evaluation in lane 0 of a group at "
                f"{rows[where]['active_contacts_per_evaluation']:.4g} active "
                f"contacts: " + ", ".join(f"{k} {x:.5g}"
                                         for k, x in cycles.items()))
        out["worlds"][env_id] = rows
    print("ANT_PHASES " + json.dumps(out), flush=True)
    return 0


POINT_PROBE_FLAG = "--point-parent-probe"     # PARENT_DIR
POINT_PROBE_OUT_FLAG = "--point-probe-out"    # PATH (.npz), in the probed tree
POINT_PROBE_WORLDS = ("PointUMaze-v0", "Point4Rooms-v2", "PointPush-v0",
                      "PointBilliard-v0", "PointFall-v0",
                      "PointMultiPushSmall-v0")


def point_probe_outputs(path: str) -> int:
    """Every output of one Point step launch (the object worlds' with its
    trace) and of one ROLLOUT_STEPS-step rollout launch on
    POINT_PROBE_WORLDS at B envs, from the reset states (plain mazes) or
    ``object_states`` (object worlds, the reduced object solve) and seeded
    actions, saved to ``path``: run from the tree whose kernels are
    probed."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout, make_fast_step
    from mujoco_maze_tpu_torch.ops.point_kernel import object_states

    out = {}
    for env_id in POINT_PROBE_WORLDS:
        env = mmt.make_batched(env_id, B)
        if env.spec.object_spec is not None:
            q, v, t = (torch.as_tensor(x, device="cuda")
                       for x in object_states(env.spec, B, 5))
        else:
            st, _ = env.reset(5)
            q, v, t = st.qpos, st.qvel, st.t
        act = torch.as_tensor(np.random.RandomState(5).uniform(
            -1, 1, (B, 2)) * [1.0, 0.25], dtype=torch.float32, device="cuda")
        step = make_fast_step(env)
        res = (step(q, v, t, act, trace=True)
               if env.spec.object_spec is not None else step(q, v, t, act))
        t_end = (EPISODE_LIMIT - ROLLOUT_STEPS
                 + torch.arange(B, device="cuda") % ROLLOUT_STEPS).int()
        roll = make_fast_rollout(env, ROLLOUT_STEPS).per_env(q, v, t_end, 7)
        for kind, outs in (("step", res), ("rollout", roll)):
            for i, x in enumerate(outs):
                out[f"{env_id}/{kind}/{i}"] = x.cpu().numpy()
    np.savez(path, **out)
    return 0


def point_parent_probe(args) -> int:
    """``python3 chip_smoke.py --point-parent-probe PARENT_DIR``: the Point
    kernels' plain-maze and object-solve modes (``point_step``,
    ``point_obj_step`` and their rollouts) of the tree at PARENT_DIR (a
    checkout with its own ``mujoco_maze_tpu_torch``) and of this one, each
    built from its own sources in a process of its own, on the same states
    and actions; every output must be equal to the bit."""
    import shutil
    import tempfile

    import numpy as np

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    parent = os.path.abspath(args[0])
    work = tempfile.mkdtemp()
    copy = os.path.join(parent, "_probe_chip_smoke.py")
    shutil.copy(__file__, copy)
    got = {}
    for tree, script in (("parent", copy), ("this", __file__)):
        path = os.path.join(work, f"{tree}.npz")
        subprocess.run([sys.executable, script, POINT_PROBE_OUT_FLAG, path],
                       check=True, cwd=os.path.dirname(script))
        got[tree] = np.load(path)
    keys = sorted(got["parent"].files)
    same = {k: bool(np.array_equal(got["parent"][k], got["this"][k],
                                   equal_nan=True)) for k in keys}
    worlds, steps = POINT_PROBE_WORLDS, ROLLOUT_STEPS
    log(f"probe: the parent's and this tree's Point kernels on {worlds} "
        f"at {B} envs, one step (qpos, qvel, t, reward, terminated, and the "
        f"traces where there are) and one {steps}-step rollout: "
        f"{sum(same.values())} of {len(same)} outputs equal to the bit; "
        f"differing: {[k for k, x in same.items() if not x]}")
    os.remove(copy)
    shutil.rmtree(work, ignore_errors=True)
    return 0 if all(same.values()) and keys == sorted(got["this"].files) else 1


# ---------------------------------------------------------------------------
# phases 27-30: a Point robot without the object solve (the quasi-static
# rows of the Point kernels), and the float64 fidelity path, in a process
# of their own
# ---------------------------------------------------------------------------
QUASI_FLAG = "--point-quasi"           # runs phases 27-30 alone
QUASI_RESULT = "POINT_QUASI_RESULT "
# the five worlds of phase 27: one block, three blocks (pair separation),
# the Fall block (a z slide the push leaves alone), the heads on the block,
# the ball with the heads on it
QUASI_IDS = ("PointPush-v0", "PointMultiPushSmall-v0", "PointFall-v0",
             "PointBlockCarry-v0", "PointBilliard-v0")
QUASI_ROLL_IDS = ("PointPush-v0", "PointBilliard-v0")
QUASI_MAIN_IDS = ("PointPush-v0", "PointBilliard-v0")
QUASI_CHECK_STEPS = 16
QUASI_SWEEP_ENVS = 256
# the float64 fidelity path on the card: the rate at 4096 envs, libm's sine
# and cosine, and the MuJoCo goldens of tests/test_point_golden.py at its
# teacher-forced bounds: (id, seed, mean one-step error)
F64_RATE_IDS = ("PointUMaze-v0", "PointBilliard-v0")
F64_RATE_STEPS = 20
TRIG_ARGS = 10 ** 6
TRIG_MAX_OFF = 10
F64_EXACT_CASES = (("PointUMaze-v0", 0, 2e-3),
                   ("PointUMaze-v0", 7, 2e-3),
                   ("Point4Rooms-v1", 3, 2e-3),
                   ("PointCorridor-v0", 5, 1e-4))
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "goldens")


def quasi_spec(env_id: str, device="cuda"):
    """``env_id``'s task with a Point robot without the object solve
    (``USES_POINT_WORLD = False``, nothing else changed): the quasi-static
    push and kick/roll/bounce ball, on ``device``."""
    from mujoco_maze_tpu_torch import registry
    from mujoco_maze_tpu_torch.envs.env import MazeEnvSpec
    from mujoco_maze_tpu_torch.models.point import PointRobot

    class QuasiPoint(PointRobot):
        USES_POINT_WORLD = False

    e = registry.entry(env_id)
    return MazeEnvSpec(QuasiPoint(), e.task_cls, e.maze_size_scaling,
                       inner_reward_scaling=e.inner_reward_scaling,
                       device=device)


def quasi_events(spec, qpos, qvel, actions):
    """Which quasi-static rows one step of ``spec`` exercises, per env
    ``(B,)`` bool each: a block pushed (the robot disc overlapping it), a
    pair separated, a ball kicked, a ball bounced off a wall (its resolved
    move differs from its free one).  Also read by
    tests/test_torch_point_quasi_step.py."""
    robot = spec.robot
    q, v = robot.kinematic_step(qpos, qvel, actions)
    q, v = robot.residual_step(q, v)
    x, y = q[:, 0], q[:, 1]
    zero = torch.zeros_like(x, dtype=torch.bool)
    pushed, separated, kicked, bounced = zero, zero, zero, zero

    def center(b, qq, a):
        i = b.qpos_idx[a]
        return float(b.body_pos[a]) + (qq[:, i] if i >= 0 else 0.0)

    blocks = spec.block_runtimes
    for b in blocks:
        cx, cy = center(b, q, 0), center(b, q, 1)
        hx, hy = float(b.half[0]), float(b.half[1])
        dx = x - torch.clamp(x, cx - hx, cx + hx)
        dy = y - torch.clamp(y, cy - hy, cy + hy)
        pushed = pushed | (torch.sqrt(dx * dx + dy * dy + 1e-12)
                           < robot.RADIUS)
    q2 = spec._push_blocks(q, q[:, :2]) if blocks else q
    for i, bi in enumerate(blocks):
        for bj in blocks[i + 1:]:
            over = torch.ones_like(pushed)
            for a in range(2):
                gap = float(bi.half[a] + bj.half[a]) - torch.abs(
                    center(bi, q2, a) - center(bj, q2, a))
                over = over & (gap > 0)
            separated = separated | over
    if spec.ball_runtimes:
        q3, _ = spec._step_balls(q2, v, q2[:, :2])
        for b in spec.ball_runtimes:
            xi, yi = b.qpos_idx[0], b.qpos_idx[1]
            bx, by = center(b, q2, 0), center(b, q2, 1)
            dist = torch.sqrt((bx - x) ** 2 + (by - y) ** 2 + 1e-12)
            reach = spec.ROBOT_GEOM_R + b.size
            hit = dist < reach
            kicked = kicked | hit
            # the ball's move without a wall, against its resolved move
            push = (reach - dist) * spec.BALL_KICK_GAIN
            vx = torch.where(hit, v[:, xi] + (bx - x) / dist * push, v[:, xi])
            vy = torch.where(hit, v[:, yi] + (by - y) / dist * push, v[:, yi])
            free = torch.stack([bx + vx * robot.timestep,
                                by + vy * robot.timestep], 1)
            got = torch.stack([center(b, q3, 0), center(b, q3, 1)], 1)
            bounced = bounced | ((got - free).abs().max(dim=1).values > 1e-6)
    return {"block pushed": pushed, "pair separated": separated,
            "ball kicked": kicked, "ball bounced": bounced}


def quasi_step_flops(ks) -> int:
    """fp32 operations of one env-step with the quasi-static rows, counted
    from csrc/point_lane.cu as ``step_flops`` counts (selects and
    comparisons none): the Point step; the world velocities' clip 2 each;
    per block, the push 40; per block pair, the separation 40; per ball,
    the kick, roll and steering 53 and the two crossing passes over the
    ball walls 60 each per wall; the heads' anchor 3."""
    nb, nl, nw = ks.quasi_counts
    n = step_flops(ks.walls.shape[0], ks.goals.shape[0]) + 2 * ks.n_world
    n += 40 * nb + 40 * (nb * (nb - 1) // 2)
    n += nl * (53 + 2 * 60 * nw)
    return n + (3 if ks.obs_offset == 3 else 0)


def quasi_step_check(env_id: str, seed: int, envs: int = B,
                     steps: int = QUASI_CHECK_STEPS):
    """Phase 27 for one ID: the quasi step kernel vs its plain version at
    ``envs`` envs, teacher-forced for ``steps`` steps from
    ``point_kernel.quasi_states`` (the robot against block faces and inside
    blocks, blocks at their limits and overlapping, the ball on the robot,
    headed into walls and corners), then along the public step API's
    trajectory with random actions; every output bit-equal.  Returns the
    counts of env-steps whose rows fired."""
    from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.point_kernel import (point_step_plain,
                                                        quasi_states)

    spec = quasi_spec(env_id)
    env = BatchedMazeEnv(spec, envs)
    kstep = make_fast_step(env)
    ks = kstep.ks
    q, v, t, a = (torch.as_tensor(x, device="cuda")
                  for x in quasi_states(spec, envs, seed))
    st = EnvState(qpos=q, qvel=v, t=t)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = env.random_policy()
    off, events, errs = 0, {}, []
    for s in range(steps):
        act = a if s == 0 else policy(None, gen)
        kout = kstep(st.qpos, st.qvel, st.t, act)
        pout = point_step_plain(ks, st.qpos, st.qvel, st.t, act)
        same = torch.ones(envs, dtype=torch.bool, device="cuda")
        for k_, p_ in zip(kout, pout):
            eq = k_ == p_
            same &= eq if eq.dim() == 1 else eq.all(dim=1)
        off += int((~same).sum())
        errs.append(max_abs_diff(kout, pout))
        for name, hit in quasi_events(spec, st.qpos, st.qvel, act).items():
            events[name] = events.get(name, 0) + int(hit.sum())
        res = env.step(st, act)
        st = res.state
    err = max_abs_diff(errs, [0.0] * len(errs))
    log(f"phase 27: {env_id} quasi step kernel vs plain, {steps} "
        f"teacher-forced steps x {envs} envs: env-steps not bit-equal {off} "
        f"of {steps * envs} (tol 0, a NaN on either side unequal), max "
        f"|kernel - plain| {err:.3g}; env-steps with the rows exercised "
        f"{events}")
    if off or err != 0.0:
        raise SystemExit(f"quasi step kernel disagrees with its plain "
                         f"version on {env_id}")
    return {"env_steps": steps * envs, "not_bit_equal": off,
            "max_abs_err": err, **events}


def quasi_rollout_check(env_id: str, seed: int):
    """Phase 28 for one ID: the quasi rollout kernel vs its plain version
    (the same Philox stream), ROLLOUT_STEPS steps from t spread over the
    window's end: every output bit-equal, the episode counts and each
    reset draw exact, the world dofs of the envs that reset on the last
    step at qpos0 (0), at rest."""
    from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout
    from mujoco_maze_tpu_torch.ops.point_kernel import (point_rollout_plain,
                                                        quasi_states,
                                                        rollout_draws)

    env = BatchedMazeEnv(quasi_spec(env_id), B)
    roll = make_fast_rollout(env, ROLLOUT_STEPS)
    q, v, _, _ = (torch.as_tensor(x, device="cuda")
                  for x in quasi_states(env.spec, B, seed))
    t0 = (EPISODE_LIMIT - ROLLOUT_STEPS
          + torch.arange(B, device="cuda") % ROLLOUT_STEPS).to(torch.int32)
    kern = roll.per_env(q, v, t0, seed)
    plain = point_rollout_plain(roll.ks, q, v, t0, seed, ROLLOUT_STEPS)
    off = sum(int((k_ != p_).reshape(B, -1).any(dim=1).sum())
              for k_, p_ in zip(kern, plain))
    err = max_abs_diff(kern, plain)
    qk, vk, tk, _, ek = kern
    last = tk == 0
    _, q_r, v_r = rollout_draws(torch.arange(B, device="cuda"),
                                ROLLOUT_STEPS - 1, seed)
    draw_off = int(((qk[last, :3] != q_r[last]) | (vk[last, :3] != v_r[last]))
                   .any(dim=1).sum())
    world_off = int(((qk[last, 3:] != 0) | (vk[last, 3:] != 0))
                    .any(dim=1).sum())
    log(f"phase 28: {env_id} quasi rollout kernel vs plain, {ROLLOUT_STEPS} "
        f"steps x {B} envs from t in [{EPISODE_LIMIT - ROLLOUT_STEPS}, "
        f"{EPISODE_LIMIT}): outputs not bit-equal {off} (tol 0), max "
        f"|kernel - plain| {err:.3g}; episodes "
        f"{int(ek.sum())} vs {int(plain[4].sum())}; {int(last.sum())} envs "
        f"reset on the last step: reset draws off {draw_off}, world dofs not "
        f"at qpos0 at rest {world_off} (tol 0)")
    if off or err != 0.0 or draw_off or world_off:
        raise SystemExit(f"quasi rollout kernel disagrees with its plain "
                         f"version on {env_id}")
    if int(ek.sum()) < B or int(last.sum()) == 0:
        raise SystemExit(f"{env_id}: expected every env to reset in the window")
    return err


def quasi_main_path(env_id: str):
    """Phase 29 for one ID: the main path, ``MazeEnvSpec(QuasiPoint(),
    task, scaling)`` then ``BatchedMazeEnv(spec, B)``, through the step
    API, ``rollout_metrics`` and the fused rollout, 1000 steps each,
    counted and checked; the CUDA path against the CPU path on a small
    input; the step API's device idle share; the kernels' times per launch
    and on the device, their bounds and their plain versions' times."""
    import numpy as np

    from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import lane_env, make_fast_rollout
    from mujoco_maze_tpu_torch.ops.point_kernel import (point_rollout_plain,
                                                        point_step_plain,
                                                        quasi_states)
    from torch.profiler import ProfilerActivity, profile

    spec = quasi_spec(env_id)
    env = BatchedMazeEnv(spec, B)
    policy = env.random_policy()
    gen = torch.Generator(device="cuda").manual_seed(29)
    st, obs = env.reset(29)
    fused = make_fast_rollout(env, MAIN_STEPS)
    for _ in range(5):  # warm-up
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    make_fast_rollout(env, 1)(st.qpos, st.qvel, st.t, 1)
    torch.cuda.synchronize()

    lane_env.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(MAIN_STEPS):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    ev[1].record()
    st_m, rew_m, eps_m = env.rollout_metrics(st, policy, MAIN_STEPS, gen)
    ev[2].record()
    qf, vf, tf, rew_f, eps_f = fused(st.qpos, st.qvel, st.t, 43)
    ev[3].record()
    torch.cuda.synchronize()
    launches = dict(lane_env.LAUNCHES)
    ms_api, ms_metrics, ms_fused = (ev[i].elapsed_time(ev[i + 1])
                                    for i in range(3))
    log(f"phase 29: quasi main path {env_id} x {B} envs, {MAIN_STEPS} steps "
        f"per path; launches {launches}")
    expected = {k: 0 for k in launches}
    expected.update({"point_quasi_step": 2 * MAIN_STEPS,
                     "point_quasi_rollout": 1})
    if launches != expected:
        raise SystemExit(f"quasi main path launches {launches}, expected "
                         f"{expected}")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase 29: {env_id} env-steps/s (CUDA events): step API "
        f"{rate(ms_api):.6g}, rollout_metrics {rate(ms_metrics):.6g}, fused "
        f"rollout {rate(ms_fused):.6g} ({ms_fused:.6g} ms per 1000-step launch)")
    xmin, xmax, ymin, ymax = spec.structure.xy_limits()

    def inside(x, y, pad):
        return bool((x > xmin - pad).all() and (x < xmax + pad).all()
                    and (y > ymin - pad).all() and (y < ymax + pad).all())

    objects = ([spec.block_center(qf, b) for b in spec.block_runtimes]
               + [spec.ball_center3(qf, b) for b in spec.ball_runtimes])
    # every env truncates near the end of each 1000-step path, so the
    # objects' motion is read over 200 more (uncounted) public-API steps
    moved = torch.zeros(B, dtype=torch.bool, device="cuda")
    s2, o2 = st, obs
    for _ in range(200):
        r2 = env.step(s2, policy(o2, gen))
        s2, o2 = r2.state, r2.obs
        moved |= s2.qpos[:, 3:].abs().max(dim=1).values > 1e-3
    checks = {
        f"obs shape (B, {spec.obs_dim})": tuple(obs.shape) == (B, spec.obs_dim),
        "obs finite": bool(torch.isfinite(obs).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, -1] == st.t.float() * 0.001).all()),
        "obs first object = its centre": bool((obs[:, 3:6] == (
            spec.ball_center3(st.qpos, spec.ball_runtimes[0])
            if spec.ball_runtimes else
            spec.block_center(st.qpos, spec.block_runtimes[0]))).all()),
        "rollout_metrics reward finite": bool(torch.isfinite(rew_m)),
        "rollout_metrics ended >= B episodes": int(eps_m) >= B,
        "fused state finite": bool(torch.isfinite(qf).all()
                                   and torch.isfinite(vf).all()),
        "fused robot and objects inside the maze (+-1)": inside(
            qf[:, 0], qf[:, 1], 1.0) and all(inside(c[:, 0], c[:, 1], 1.0)
                                            for c in objects),
        "objects moved in 200 steps (envs that pushed or struck one)":
            int(moved.sum()) > 0,
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward finite": bool(torch.isfinite(rew_f)),
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
    }
    log(f"phase 29: {env_id} output checks {checks}; envs whose objects "
        f"moved in those 200 steps {int(moved.sum())} of {B}")
    if not all(checks.values()):
        raise SystemExit(f"the quasi main path's output failed a check on "
                         f"{env_id}")

    # the port's CUDA path against its CPU path on a small input
    n_small = 64
    cpu_env = BatchedMazeEnv(quasi_spec(env_id, "cpu"), n_small,
                             auto_reset=False)
    gpu_env = BatchedMazeEnv(spec, n_small, auto_reset=False)
    q, v, t, a = quasi_states(cpu_env.spec, n_small, 5)
    s_cpu = EnvState(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                     t=torch.as_tensor(t))
    rng = np.random.RandomState(5)
    small_err = 0.0
    for k in range(5):
        act = (torch.as_tensor(a) if k == 0 else torch.as_tensor(
            rng.uniform(-1, 1, (n_small, 2)) * [1.0, 0.25], dtype=torch.float32))
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        small_err = max(small_err,
                        float((r_gpu.obs.cpu() - r_cpu.obs).abs().max()),
                        float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        if not torch.equal(r_gpu.terminated.cpu(), r_cpu.terminated):
            raise SystemExit("the quasi CUDA path and CPU path disagree on "
                             "terminated")
        s_cpu = r_cpu.state
    log(f"phase 29: {env_id} CUDA path vs CPU path, {n_small} envs x 5 steps "
        f"teacher-forced from quasi states: max |err| obs and reward "
        f"{small_err:.3g} (tol {STEP_TOL})")
    if not small_err <= STEP_TOL:
        raise SystemExit("the quasi CUDA path disagrees with the CPU path")

    # where a step-API step's time goes: one profiled window of 50 steps
    acts = [policy(obs, gen) for _ in range(50)]
    s = st
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a_ in acts:
            s = env.step(s, a_).state
        ev[1].record()
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t_ for t_, _, _ in on_device)
    idle = 1 - busy_us / window_us if busy_us else float("nan")
    n_kernels = sum(n for _, n, _ in on_device) / 50
    top = "; ".join(f"{k[:60]} {t_ / 50:.4g} us/step ({n / 50:.3g}/step)"
                    for t_, n, k in on_device[:4])
    log(f"phase 29: profiled {env_id} step API, 50 steps in {window_us:.6g} "
        f"us: device busy {busy_us:.6g} us (idle share {idle:.4g}), "
        f"{n_kernels:.3g} kernels/step; top: {top}")

    # the kernels' numbers at the main path's shapes
    kstep = env._kernel_step
    ks = kstep.ks
    act = policy(obs, gen)
    roll64 = make_fast_rollout(env, ROLLOUT_STEPS)
    ms_step = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 200)
    ms_roll = cuda_ms(lambda: fused.per_env(st.qpos, st.qvel, st.t, 19), 1)
    ms_roll64 = cuda_ms(lambda: roll64.per_env(st.qpos, st.qvel, st.t, 19), 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kstep(st.qpos, st.qvel, st.t, act)
        roll64.per_env(st.qpos, st.qvel, st.t, 19)
        torch.cuda.synchronize()
    dev_step, n_step = device_ms(prof, "point_quasi_step_kernel")
    dev_roll64, _ = device_ms(prof, "point_quasi_rollout_kernel")
    if not n_step:   # the profiler recorded no launch: CUDA events instead
        dev_step = device_ms_events(lambda: kstep(st.qpos, st.qvel, st.t, act), 5)
        dev_roll64 = device_ms_events(
            lambda: roll64.per_env(st.qpos, st.qvel, st.t, 19), 2)
    ms_step_plain = cuda_ms(lambda: point_step_plain(ks, st.qpos, st.qvel,
                                                     st.t, act), 5)
    ms_roll_plain = cuda_ms(lambda: point_rollout_plain(
        ks, st.qpos, st.qvel, st.t, 19, ROLLOUT_STEPS), 1)
    flops = quasi_step_flops(ks)
    nq = 3 + ks.n_world
    tables = 4 * (4 * ks.walls.shape[0] + 9 * ks.goals.shape[0]
                  + ks.quasi_table.numel())
    step_bound = bound(B * obj_bytes(nq, "step") + tables, B * flops)
    roll_bound = bound(B * obj_bytes(nq, "rollout") + tables,
                       B * MAIN_STEPS * (flops + 33))
    roll64_bound = bound(B * obj_bytes(nq, "rollout") + tables,
                         B * ROLLOUT_STEPS * (flops + 33))
    log(f"phase 29: {env_id} point_quasi_step {ms_step:.6g} ms/launch, "
        f"{dev_step:.6g} ms on the device ({n_step} profiled), plain "
        f"{ms_step_plain:.6g} ms, bound {step_bound[0]:.3g} ms by "
        f"{step_bound[1]} ({flops} fp32 operations per env-step); "
        f"point_quasi_rollout {ms_roll:.6g} ms per {MAIN_STEPS}-step launch "
        f"(bound {roll_bound[0]:.3g} ms), {ms_roll64:.6g} ms per "
        f"{ROLLOUT_STEPS}-step launch, {dev_roll64:.6g} ms on the device, "
        f"plain {ms_roll_plain:.6g} ms (bound {roll64_bound[0]:.3g} ms)")
    return {
        "rates": {"step_api": rate(ms_api), "rollout_metrics": rate(ms_metrics),
                  "fused": rate(ms_fused), "idle_share": idle,
                  "kernels_per_step": n_kernels},
        "step": {"launches": launches["point_quasi_step"], "ms": ms_step,
                 "device_ms": dev_step, "plain_ms": ms_step_plain,
                 "bound_ms": step_bound[0], "bound_by": step_bound[1],
                 "fp32_ops_per_env_step": flops},
        "rollout": {"launches": launches["point_quasi_rollout"],
                    "steps_per_launch": ROLLOUT_STEPS, "ms": ms_roll64,
                    "device_ms": dev_roll64, "plain_ms": ms_roll_plain,
                    "bound_ms": roll64_bound[0], "bound_by": roll64_bound[1],
                    "ms_per_1000_steps": ms_roll,
                    "bound_ms_per_1000_steps": roll_bound[0]},
    }


@contextlib.contextmanager
def card_solve_flips():
    """Within one float64 step on the card: each Newton solve runs twice,
    with the card's ``torch.linalg.solve`` (whose result the step keeps)
    and with the host's (LAPACK) in its place.  Yields a dict that
    receives, per env, ``diff`` (some host solve's bits differ from the
    card's on the same system), ``flip`` (some line-search branch differs
    between the two runs) and ``moved`` (the two results differ by more
    than rounding, 1e-9 relative), each where a contact row is active."""
    from mujoco_maze_tpu_torch.physics import point_world as pw

    orig = pw._solve_newton
    rec = {}

    def twin(p, M, a0, J, aref, rinv):
        live = (rinv > 0.0).any(-1)
        diff = torch.zeros_like(live)

        def host_solve(H, g):
            nonlocal diff
            theirs = torch.linalg.solve(H.cpu(), g.cpu()).to(H.device)
            diff = diff | (torch.linalg.solve(H, g) != theirs).any(-1)
            return theirs

        mine, theirs = [], []
        x = orig(p, M, a0, J, aref, rinv, branches=mine)
        x_host = orig(p, M, a0, J, aref, rinv, solve=host_solve,
                      branches=theirs)
        flip = torch.stack([a != b for a, b in zip(mine, theirs)]).any(0)
        moved = ((x - x_host).abs() > 1e-9 * (1.0 + x.abs())).any(-1)
        for name, hit in (("diff", diff), ("flip", flip), ("moved", moved)):
            rec[name] = rec.get(name, torch.zeros_like(live)) | (hit & live)
        return x

    pw._solve_newton = twin
    try:
        yield rec
    finally:
        pw._solve_newton = orig


def golden_errors(spec, g, flips):
    """The float64 path's qpos after each step of a MuJoCo golden, all of
    its steps in one batch on the card, each from the golden's state
    before it (teacher-forced); adds the step's counts of
    :func:`card_solve_flips` and its env-steps to ``flips``."""
    from mujoco_maze_tpu_torch.envs.env import EnvState

    import numpy as np

    qp = np.concatenate([g["reset_qpos"][None], g["qpos"][:-1]])
    qv = np.concatenate([g["reset_qvel"][None], g["qvel"][:-1]])
    n = len(g["actions"])
    st = EnvState(qpos=torch.tensor(qp, device="cuda"),
                  qvel=torch.tensor(qv, device="cuda"),
                  t=torch.zeros(n, dtype=torch.int32, device="cuda"))
    with card_solve_flips() as rec:
        q = spec.step(st, torch.tensor(g["actions"], device="cuda")).state.qpos
    flips["env_steps"] += n
    for name, hit in rec.items():
        flips[name] += int(hit.sum())
    return q.cpu().numpy()


def f64_golden_check():
    """The MuJoCo goldens of tests/test_point_golden.py, case for case at
    its teacher-forced bounds, through the float64 path on the card (the
    free runs, one env stepped serially, are the CPU test's); returns each
    case's numbers and the cases that miss a bound."""
    import numpy as np

    from mujoco_maze_tpu_torch import registry

    def load(name):
        return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))

    def spec_of(env_id):
        return registry.make_spec(env_id, dtype=torch.float64, device="cuda")

    out, bad = {}, []
    flips = {"env_steps": 0, "diff": 0, "flip": 0, "moved": 0}
    for env_id, seed, tf_mean in F64_EXACT_CASES:
        g = load(f"{env_id}_s{seed}")
        q = golden_errors(spec_of(env_id), g, flips)
        errs = np.abs(q[:, :3] - g["qpos"][:, :3]).max(1)
        out[f"{env_id}_s{seed}"] = {
            "tf_mean": float(errs.mean()), "tf_median": float(np.median(errs))}
        if not (errs.mean() < tf_mean and np.median(errs) < 1e-9):
            bad.append(f"{env_id}_s{seed}")
    for seed in (2, 9):
        g = load(f"PointPush-v0_s{seed}")
        q = golden_errors(spec_of("PointPush-v0"), g, flips)
        rob = np.abs(q[:, :3] - g["qpos"][:, :3]).max(1)
        blk = np.abs(q[:, 3:5] - g["qpos"][:, 3:5]).max(1)
        out[f"PointPush-v0_s{seed}"] = {
            "robot_median": float(np.median(rob)), "robot_mean": float(rob.mean()),
            "block_mean": float(blk.mean())}
        if not (np.median(rob) < 1e-9 and blk.mean() < 1e-3
                and rob.mean() < 2e-3):
            bad.append(f"PointPush-v0_s{seed}")
    spec = spec_of("PointBilliard-v0")
    g = load("PointBilliard-v0_strike")
    errs = np.abs(golden_errors(spec, g, flips) - g["qpos"]).max(1)
    out["PointBilliard-v0_strike"] = {
        "tf_mean": float(errs.mean()), "tf_median": float(np.median(errs))}
    if not (errs.mean() < 1e-3 and np.median(errs) < 1e-9):
        bad.append("PointBilliard-v0_strike")
    g = load("PointBilliard-v0_s11")
    q = golden_errors(spec, g, flips)
    ball_err = np.abs(q[:, 3:6] - g["qpos"][:, 3:6]).max(1)
    rob = np.abs(q[:, :3] - g["qpos"][:, :3]).max(1)
    out["PointBilliard-v0_s11"] = {"ball_max": float(ball_err.max()),
                                   "robot_mean": float(rob.mean())}
    if not (ball_err.max() < 1e-9 and rob.mean() < 1e-3):
        bad.append("PointBilliard-v0_s11")
    out["solve_flips"] = flips
    return out, bad


def f64_phase():
    """Phase 30: the float64 fidelity path on the card: PointUMaze-v0 and
    PointBilliard-v0 at B envs through ``BatchedMazeEnv.step`` (no kernel:
    ``spec.step``), env-steps/s and no NaN; the card's sine and cosine
    against numpy's on the host over TRIG_ARGS arguments (|x| <= 50), and
    the floor switch they decide; the MuJoCo goldens teacher-forced at
    tests/test_point_golden.py's bounds, and on them how often the card's
    Newton solves move a line-search branch against the host's."""
    import numpy as np

    from mujoco_maze_tpu_torch import registry
    from mujoco_maze_tpu_torch.envs.batched import BatchedMazeEnv
    from mujoco_maze_tpu_torch.ops import lane_env
    from mujoco_maze_tpu_torch.physics.exact_trig import sincos

    rates = {}
    for env_id in F64_RATE_IDS:
        env = BatchedMazeEnv(registry.make_spec(env_id, dtype=torch.float64), B)
        policy = env.random_policy()
        gen = torch.Generator(device="cuda").manual_seed(30)
        st, obs = env.reset(30)
        res = env.step(st, policy(obs, gen))       # warm-up
        st, obs = res.state, res.obs
        lane_env.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(F64_RATE_STEPS):
            res = env.step(st, policy(obs, gen))
            st, obs = res.state, res.obs
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        finite = bool(torch.isfinite(st.qpos).all()
                      and torch.isfinite(st.qvel).all())
        launched = sum(lane_env.LAUNCHES.values())
        rates[env_id] = {"env_steps_s": B * F64_RATE_STEPS / (ms * 1e-3),
                         "ms_per_step": ms / F64_RATE_STEPS, "finite": finite,
                         "dtype": str(st.qpos.dtype)}
        log(f"phase 30: {env_id} float64 x {B} envs, {F64_RATE_STEPS} steps "
            f"through BatchedMazeEnv.step: {rates[env_id]['env_steps_s']:.6g} "
            f"env-steps/s ({ms / F64_RATE_STEPS:.6g} ms a step, "
            f"{time.perf_counter() - t0:.2f} s wall), state finite {finite}, "
            f"kernel launches {launched} (tol 0)")
        if not finite or launched or st.qpos.dtype != torch.float64:
            raise SystemExit(f"the float64 path failed on {env_id}")
    rng = np.random.RandomState(2026)
    x = rng.uniform(-50.0, 50.0, TRIG_ARGS)
    s, c = (y.cpu().numpy() for y in sincos(torch.tensor(x, device="cuda")))
    s_off = np.nonzero(s != np.sin(x))[0]
    c_off = np.nonzero(c != np.cos(x))[0]
    sw = (0.5 * (c * c + s * s) - 0.5 < 0) != (
        0.5 * (np.cos(x) ** 2 + np.sin(x) ** 2) - 0.5 < 0)
    trig = {"args": TRIG_ARGS, "sin_off": len(s_off), "cos_off": len(c_off),
            "switch_off": int(sw.sum()),
            "args_off": [float(v) for v in x[np.union1d(s_off, c_off)][:10]]}
    log(f"phase 30: the card's float64 sin/cos vs numpy on the host over "
        f"{TRIG_ARGS} arguments in [-50, 50]: sin off {len(s_off)}, cos off "
        f"{len(c_off)}, floor switch off {int(sw.sum())} (tol {TRIG_MAX_OFF} "
        f"each) {trig['args_off']}")
    if max(len(s_off), len(c_off), int(sw.sum())) > TRIG_MAX_OFF:
        raise SystemExit("the card's sine and cosine differ from numpy's")
    goldens, bad = f64_golden_check()
    fl = goldens["solve_flips"]
    log(f"phase 30: MuJoCo goldens teacher-forced through the float64 path "
        f"on the card (tests/test_point_golden.py's bounds; the free runs are "
        f"the CPU test's): {goldens}; failed {bad}")
    log(f"phase 30: the card's Newton solves against the host's (LAPACK) on "
        f"those {fl['env_steps']} env-steps, where a contact row is active: "
        f"solve bits differ on {fl['diff']}, a line-search branch differs on "
        f"{fl['flip']}, the solve's result moves (> 1e-9 relative) on "
        f"{fl['moved']}")
    if bad:
        raise SystemExit(f"the float64 path misses the golden bounds on {bad}")
    return {"rates": rates, "trig": trig, "goldens": goldens}


def point_quasi_phases() -> int:
    """Phases 27-30, run in a process of their own (``python3 chip_smoke.py
    --point-quasi``, started by ``main``; it also runs alone).  Prints its
    result as one ``POINT_QUASI_RESULT {json}`` line."""
    from mujoco_maze_tpu_torch import registry
    from mujoco_maze_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    _build.load()
    checks = {env_id: quasi_step_check(env_id, 171 + k)
              for k, env_id in enumerate(QUASI_IDS)}
    tasks = [i for i in registry.env_ids() if i.startswith("Point")
             and quasi_spec(i, "cpu").nq > 3]
    sweep = [quasi_step_check(env_id, 181 + k, QUASI_SWEEP_ENVS, 1)
             for k, env_id in enumerate(tasks)]
    sweep_off = sum(x["not_bit_equal"] for x in sweep)
    log(f"phase 27: {len(tasks)} Point object tasks with the quasi robot, one "
        f"launch each at {QUASI_SWEEP_ENVS} envs: env-steps not bit-equal "
        f"{sweep_off} (tol 0)")
    if len(tasks) != 27:
        raise SystemExit(f"expected 27 Point object tasks, found {len(tasks)}")
    step_err = max_abs_diff([x["max_abs_err"] for x in
                             list(checks.values()) + sweep],
                            [0.0] * (len(checks) + len(sweep)))
    roll_err = max_abs_diff([quasi_rollout_check(env_id, 191 + k)
                             for k, env_id in enumerate(QUASI_ROLL_IDS)],
                            [0.0] * len(QUASI_ROLL_IDS))
    mains = {env_id: quasi_main_path(env_id) for env_id in QUASI_MAIN_IDS}
    f64 = f64_phase()
    log(f"phases 27-30 took {time.perf_counter() - t0:.1f} s")
    first = mains[QUASI_MAIN_IDS[0]]
    out = {"step": {**first["step"], "max_abs_err": step_err,
                    "launches": sum(m["step"]["launches"] for m in mains.values()),
                    "checks": checks},
           "rollout": {**first["rollout"], "max_abs_err": roll_err,
                       "launches": sum(m["rollout"]["launches"]
                                       for m in mains.values())},
           "main_paths": {k: {"rates": m["rates"], "step": m["step"],
                              "rollout": m["rollout"]}
                          for k, m in mains.items()},
           "float64": f64, "seconds": time.perf_counter() - t0}
    print(QUASI_RESULT + json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT, EnvState
    from mujoco_maze_tpu_torch.ops import (_build, lane_env, make_fast_rollout,
                                           make_fast_step)
    from mujoco_maze_tpu_torch.ops.point_kernel import (point_rollout_plain,
                                                        point_step_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device {device_name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t
    log(f"phase 1: built {lib.name} with one nvcc call in {build_s:.2f} s")

    # -- 2. step kernel vs plain version, teacher-forced -------------------
    step_err = 0.0
    for env_id in IDS:
        env = mmt.make_batched(env_id, B)
        kstep = make_fast_step(env)
        gen = torch.Generator(device="cuda").manual_seed(1)
        policy = env.random_policy()
        st, obs = env.reset(0)
        errs = torch.zeros(4, device="cuda")
        term_diff = torch.zeros((), dtype=torch.int64, device="cuda")
        episodes = torch.zeros((), dtype=torch.int64, device="cuda")
        for _ in range(1000):
            act = policy(obs, gen)
            qk, vk, tk, rk, mk = kstep(st.qpos, st.qvel, st.t, act)
            qp, vp, tp, rp, mp = point_step_plain(kstep.ks, st.qpos, st.qvel,
                                                  st.t, act)
            errs = torch.maximum(errs, torch.stack([
                ori_diff(qk, qp).max(), (vk - vp).abs().max(),
                (tk - tp).abs().max().float(), (rk - rp).abs().max()]))
            term_diff += (mk != mp).sum()
            res = env.step(st, act)
            episodes += (res.terminated | res.truncated).sum()
            st, obs = res.state, res.obs
        e = errs.tolist()
        n_term = int(term_diff)
        log(f"phase 2: {env_id} step kernel vs plain, 1000 steps x {B} envs "
            f"({int(episodes)} episodes ended): max |err| qpos {e[0]:.3g} "
            f"qvel {e[1]:.3g} t {e[2]:.3g} reward {e[3]:.3g} (tol {STEP_TOL}); "
            f"terminated mismatches {n_term} (tol 0)")
        if max(e) > STEP_TOL or n_term:
            raise SystemExit(f"step kernel disagrees with its plain version on {env_id}")
        if int(episodes) < B:
            raise SystemExit(f"{env_id}: expected every env to end an episode")
        step_err = max(step_err, max(e))

    # -- 3. rollout kernel vs the Philox-identical plain version -----------
    # Step counts spread over [1000 - 64, 1000): every env truncates inside
    # the window, so the reset draws, the done fold and t = 0 are compared
    # too; an env that truncates on the last step ends on its reset draw.
    rollout_err = 0.0
    for env_id in IDS:
        env = mmt.make_batched(env_id, B)
        roll = make_fast_rollout(env, ROLLOUT_STEPS)
        st, _ = env.reset(2)
        t0 = (EPISODE_LIMIT - ROLLOUT_STEPS
              + torch.arange(B, device="cuda") % ROLLOUT_STEPS).to(torch.int32)
        kern = roll.per_env(st.qpos, st.qvel, t0, 7)
        plain = point_rollout_plain(roll.ks, st.qpos, st.qvel, t0, 7,
                                    ROLLOUT_STEPS)
        per_env, eps_diff = rollout_diff(kern, plain)
        split = int((per_env > STEP_TOL).sum())
        err = float(per_env.max())
        eps_k, eps_p = int(kern[4].sum()), int(plain[4].sum())
        log(f"phase 3: {env_id} rollout kernel vs plain, {ROLLOUT_STEPS} steps x "
            f"{B} envs from t in [{EPISODE_LIMIT - ROLLOUT_STEPS}, {EPISODE_LIMIT}): "
            f"max |err| {err:.3g} (tol {STEP_TOL}); envs beyond it {split} "
            f"(tol 0); episodes {eps_k} vs {eps_p}, envs whose counts differ "
            f"{eps_diff} (tol 0)")
        if split or eps_diff:
            raise SystemExit(f"rollout kernel disagrees with its plain version on {env_id}")
        if eps_k < B:
            raise SystemExit(f"{env_id}: expected every env to reset in the window")
        rollout_err = max(rollout_err, err)

    # -- 4. the main path through the public API ---------------------------
    env = mmt.make_batched(MAIN_ID, B)
    policy = env.random_policy()
    gen = torch.Generator(device="cuda").manual_seed(3)
    st, obs = env.reset(3)
    fused = make_fast_rollout(env, MAIN_STEPS)
    for _ in range(10):  # warm-up
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    fused(st.qpos, st.qvel, st.t, 1)
    torch.cuda.synchronize()

    lane_env.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(MAIN_STEPS):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    ev[1].record()
    st_m, rew_m, eps_m = env.rollout_metrics(st, policy, MAIN_STEPS, gen)
    ev[2].record()
    qf, vf, tf, rew_f, eps_f = fused(st.qpos, st.qvel, st.t, 11)
    ev[3].record()
    torch.cuda.synchronize()
    launches = dict(lane_env.LAUNCHES)
    ms_step_api = ev[0].elapsed_time(ev[1])
    ms_metrics = ev[1].elapsed_time(ev[2])
    ms_fused = ev[2].elapsed_time(ev[3])
    log(f"phase 4: main path {MAIN_ID} x {B} envs, {MAIN_STEPS} steps per path; "
        f"launches {launches}")
    if (min(launches["point_step"], launches["point_rollout"]) <= 0
            or any(n for k, n in launches.items() if not k.startswith("point"))):
        raise SystemExit("a kernel of the main path was never launched, or "
                         "another path's kernel was")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase 4: env-steps/s (CUDA events): step API {rate(ms_step_api):.6g}, "
        f"rollout_metrics {rate(ms_metrics):.6g}, fused rollout {rate(ms_fused):.6g}")

    # what comes out: shapes, finite values, the bounds of the maze
    lo, hi = env.spec.observation_bounds()
    checks = {
        "obs shape (B, 7)": tuple(obs.shape) == (B, 7),
        "obs finite": bool(torch.isfinite(obs).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, 6] == st.t.float() * 0.001).all()),
        "rollout_metrics reward finite and < 0 (dist reward)": bool(
            torch.isfinite(rew_m)) and float(rew_m) < 0,
        "rollout_metrics ended >= B episodes": int(eps_m) >= B,
        "fused xy inside the maze (+-0.2)": bool(
            (qf[:, 0] > lo[0] - 0.2).all() and (qf[:, 0] < hi[0] + 0.2).all()
            and (qf[:, 1] > lo[1] - 0.2).all() and (qf[:, 1] < hi[1] + 0.2).all()),
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward < 0 (dist reward)": float(rew_f) < 0,
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
        "fused state finite": bool(torch.isfinite(qf).all() and torch.isfinite(vf).all()),
    }
    log(f"phase 4: output checks {checks}")
    if not all(checks.values()):
        raise SystemExit("the main path's output failed a check")

    # the port's CUDA path against its CPU path on a small input
    cpu_env = mmt.make_batched(MAIN_ID, 64, auto_reset=False, device="cpu")
    gpu_env = mmt.make_batched(MAIN_ID, 64, auto_reset=False)
    s_cpu, _ = cpu_env.reset(5)
    rng = np.random.RandomState(5)
    small_err = 0.0
    for _ in range(20):
        act = torch.as_tensor(rng.uniform(-1, 1, (64, 2)) * [1.0, 0.25],
                              dtype=torch.float32)
        r_cpu = cpu_env.step(s_cpu, act)
        s_gpu = EnvState(qpos=s_cpu.qpos.cuda(), qvel=s_cpu.qvel.cuda(),
                         t=s_cpu.t.cuda())
        r_gpu = gpu_env.step(s_gpu, act.cuda())
        small_err = max(small_err, float((r_gpu.obs.cpu() - r_cpu.obs).abs().max()),
                        float((r_gpu.reward.cpu() - r_cpu.reward).abs().max()))
        s_cpu = r_cpu.state
    log(f"phase 4: CUDA path vs CPU path, 64 envs x 20 steps teacher-forced: "
        f"max |err| {small_err:.3g} (tol {STEP_TOL})")
    if small_err > STEP_TOL:
        raise SystemExit("the CUDA path disagrees with the CPU path")

    # per-kernel times at the main path's shapes
    kstep = make_fast_step(env)
    act = policy(obs, gen)
    ms_step = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 200)
    ms_step_plain = cuda_ms(
        lambda: point_step_plain(kstep.ks, st.qpos, st.qvel, st.t, act), 20)
    ms_roll = cuda_ms(lambda: fused(st.qpos, st.qvel, st.t, 13), 3)
    plain_out = []
    ms_roll_plain = cuda_ms(lambda: plain_out.append(point_rollout_plain(
        fused.ks, st.qpos, st.qvel, st.t, 13, MAIN_STEPS)), 1)
    per_env, eps_diff = rollout_diff(fused.per_env(st.qpos, st.qvel, st.t, 13),
                                     plain_out[0])
    err = float(per_env.max())
    n_eps = int(plain_out[0][4].sum())
    log(f"phase 4: rollout kernel vs plain, {MAIN_STEPS} steps x {B} envs "
        f"({n_eps} episodes ended): max |err| {err:.3g} (tol {STEP_TOL}); envs "
        f"beyond it {int((per_env > STEP_TOL).sum())} (tol 0); envs whose "
        f"episode counts differ {eps_diff} (tol 0)")
    if err > STEP_TOL or eps_diff:
        raise SystemExit("rollout kernel disagrees with its plain version "
                         f"over {MAIN_STEPS} steps")
    rollout_err = max(rollout_err, err)
    n_walls, n_goals = kstep.ks.walls.shape[0], kstep.ks.goals.shape[0]
    tables = 4 * (4 * n_walls + 9 * n_goals)
    step_bound = bound(B * (12 + 12 + 4 + 8 + 12 + 12 + 4 + 4 + 1) + tables,
                       B * step_flops(n_walls, n_goals))
    # the rollout's Philox integer work is left out of its bound
    roll_bound = bound(B * (12 + 12 + 4 + 12 + 12 + 4 + 4 + 4) + tables,
                       B * MAIN_STEPS * (step_flops(n_walls, n_goals) + 33))
    log(f"phase 4: point_step {ms_step:.6g} ms/launch (plain {ms_step_plain:.6g} ms, "
        f"bound {step_bound[0]:.3g} ms by {step_bound[1]}); point_rollout "
        f"{ms_roll:.6g} ms/launch of {MAIN_STEPS} steps (plain {ms_roll_plain:.6g} ms, "
        f"bound {roll_bound[0]:.3g} ms by {roll_bound[1]}); W={n_walls} G={n_goals}")

    # where a step-API step's time goes: one profiled window of 50 steps
    from torch.profiler import ProfilerActivity, profile

    acts = [policy(obs, gen) for _ in range(50)]
    s = st
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a in acts:
            s = env.step(s, a).state
        ev[1].record()
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _, _ in on_device)
    top = "; ".join(f"{k[:60]} {t / 50:.4g} us/step ({n // 50}/step)"
                    for t, n, k in on_device[:4])
    log(f"phase 4: profiled step API, 50 steps in {window_us:.6g} us: "
        f"device busy {busy_us:.6g} us (idle share "
        f"{1 - busy_us / window_us:.4g}), {sum(n for _, n, _ in on_device) // 50} "
        f"kernels/step; top: {top}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused(st.qpos, st.qvel, st.t, 13)
        torch.cuda.synchronize()
    dev_point_roll, _ = device_ms(prof, "point_rollout_kernel")
    log(f"phase 4: point_rollout {dev_point_roll:.6g} ms on the device per "
        f"{MAIN_STEPS}-step launch (profiler)")

    # -- 5-8. the Ant in the object-free mazes --------------------------------
    ant_step_err = max(
        ant_step_check(env_id, 31 + k, "5", ANT_CHECK_BUDGET_S / len(ANT_IDS),
                       ANT_MIN_CHECK_STEPS, ANT_MAX_CHECK_STEPS)["max"]
        for k, env_id in enumerate(ANT_IDS))
    ant_roll_err = max(ant_rollout_check(env_id, 41 + k, "6")
                       for k, env_id in enumerate(ANT_IDS))
    ant = ant_main_path(ANT_MAIN_ID, "7", "8")

    # -- 9-12. the Ant block worlds -------------------------------------------
    block_step_err = max(
        ant_step_check(env_id, 51 + k, "9", 0.0, BLOCK_CHECK_STEPS,
                       BLOCK_CHECK_STEPS)["max"]
        for k, env_id in enumerate(BLOCK_IDS))
    block_roll_err = max(ant_rollout_check(env_id, 61 + k, "10")
                         for k, env_id in enumerate(BLOCK_MAIN_IDS))
    fall_mechanic_check()
    blocks = {env_id: ant_main_path(env_id, "12", "12")
              for env_id in BLOCK_MAIN_IDS}

    # -- 13-15. the Swimmer and the Reacher ----------------------------------
    swim_step_err = max(swimmer_step_check(env_id, 71 + k)
                        for k, env_id in enumerate(SWIMMER_IDS))
    swim_roll_err = max(swimmer_rollout_check(env_id, 81 + k)
                        for k, env_id in enumerate(SWIMMER_ROLL_IDS))
    swim = swimmer_main_path()

    # -- 16. the card's fp32 peak ---------------------------------------------
    peak = peak_phase()

    # -- 17-19. the Point object worlds, in a process of their own -----------
    objects = run_child(OBJ_FLAG, OBJ_RESULT, "17-19")

    # -- 20-23. custom robots through the generic engine kernel ---------------
    engine = run_child(ENGINE_FLAG, ENGINE_RESULT, "20-23")
    # -- 24-26. the Ant with a free object ball --------------------------------
    balls = run_child(BALLS_FLAG, BALLS_RESULT, "24-26")
    # -- 27-30. the quasi-static rows; the float64 Point path ---------------
    quasi = run_child(QUASI_FLAG, QUASI_RESULT, "27-30")
    # engine_step's operation bound against the fp32 peak phase 16 measured
    # (the child process's bound is on the data sheet's 67e12)
    eng = engine["step"]
    eng["bound_ms_measured_peak"] = (
        1e3 * B * eng["fp32_ops_per_env_step"] / peak["measured_fp32_flop_s"])
    log(f"phase 21: RollerUMaze engine_step bound {eng['bound_ms']:.3g} ms on "
        f"the data sheet's {FP32_FLOP_S:.3g} FLOP/s, "
        f"{eng['bound_ms_measured_peak']:.3g} ms on the measured "
        f"{peak['measured_fp32_flop_s']:.6g}; kernel/bound "
        f"{eng['ms'] / eng['bound_ms_measured_peak']:.4g}x on the measured peak")

    src = "mujoco_maze_tpu_torch/csrc/point_lane.cu"
    kernels = [
        {"name": "point_step", "route": "cuda", "source": src,
         "replaces": "mujoco_maze_tpu/ops/lane_env.py:256",
         "launches": launches["point_step"], "max_abs_err": step_err,
         "ms": ms_step, "plain_ms": ms_step_plain, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None},
        {"name": "point_rollout", "route": "cuda", "source": src,
         "replaces": "mujoco_maze_tpu/ops/lane_env.py:185",
         "launches": launches["point_rollout"], "max_abs_err": rollout_err,
         "ms": ms_roll, "plain_ms": ms_roll_plain, "bound_ms": roll_bound[0],
         "bound_by": roll_bound[1], "library_ms": None},
    ]
    # the block worlds' kernels: numbers on the first main path, launches
    # summed over both
    first = blocks[BLOCK_MAIN_IDS[0]]
    for kind in ("step", "rollout"):
        first[kind]["launches"] = sum(b[kind]["launches"]
                                      for b in blocks.values())
    for nums, src, worlds, errs in (
            (ant, "ant_lane.cu", "the 21 object-free Ant mazes",
             (ant_step_err, ant_roll_err)),
            (first, "ant_blocks.cu", "the 21 Ant block worlds",
             (block_step_err, block_roll_err))):
        for (kind, line), err in zip((("step", "228"), ("rollout", "222")), errs):
            kernels.append({
                **nums[kind], "route": "cuda",
                "source": f"mujoco_maze_tpu_torch/csrc/{src}",
                "replaces": f"mujoco_maze_tpu/ops/ant_pallas.py:{line}",
                "max_abs_err": err, "library_ms": None, "worlds": worlds})
    for kind, line in (("step", "228"), ("rollout", "222")):
        kernels.append({
            **balls[kind], "route": "cuda",
            "source": "mujoco_maze_tpu_torch/csrc/ant_balls.cu",
            "device_code": "mujoco_maze_tpu_torch/csrc/ant_lane.cuh",
            "replaces": f"mujoco_maze_tpu/ops/ant_pallas.py:{line}",
            "library_ms": None,
            "worlds": "the 3 AntSmallBilliard worlds (one free object ball)",
            "main_path": ANT_BALL_MAIN_ID, **(
                {"main_path_rates": balls["rates"]} if kind == "step" else {})})
    for (kind, line), err in zip((("step", "151"), ("rollout", "143")),
                                 (swim_step_err, swim_roll_err)):
        kernels.append({
            **swim[kind], "route": "cuda",
            "source": "mujoco_maze_tpu_torch/csrc/swimmer_lane.cu",
            "replaces": f"mujoco_maze_tpu/ops/swimmer_pallas.py:{line}",
            "max_abs_err": err, "library_ms": None,
            "worlds": "the 52 Swimmer and Reacher IDs"})
    kernels.append({**peak, "route": "cuda",
                    "source": "mujoco_maze_tpu_torch/csrc/roofline.cu",
                    "replaces": "mujoco_maze_tpu/utils/roofline.py:54",
                    "library_ms": None})
    for kind, line in (("step", "635"), ("rollout", "621")):
        kernels.append({
            **objects[kind], "route": "cuda",
            "source": "mujoco_maze_tpu_torch/csrc/point_lane.cu",
            "replaces": f"mujoco_maze_tpu/ops/point_pallas.py:{line}",
            "object_solve": "mujoco_maze_tpu_torch/csrc/point_objects.cuh "
                            "(mujoco_maze_tpu/ops/object_lanes.py:1009)",
            "library_ms": None, "worlds": "the 27 Point object worlds",
            "main_path": OBJ_MAIN_ID, **(
                {"main_path_rates": objects["rates"]} if kind == "step" else {})})
    # engine_step: its numbers on RollerUMaze; the launches of both of its
    # main paths (phases 21 and 23) summed; the ball world's numbers beside
    ball = engine["ball"]
    kernels.append({
        **engine["step"], "route": "cuda",
        "launches": engine["step"]["launches"] + ball["launches"],
        "source": "mujoco_maze_tpu_torch/csrc/engine_lane.cu",
        "replaces": "mujoco_maze_tpu/ops/engine_pallas.py:190",
        "device_code": "mujoco_maze_tpu_torch/csrc/engine_lane.cuh",
        "library_ms": None,
        "worlds": "custom USES_WORLD_ENGINE robots (examples/custom_robot.py),"
                  " with free object balls",
        "main_path": f"make_roller_umaze({B}); the Roller in "
                     f"{BALL_WORLD}({BALL_SCALE}) at {B} envs",
        "main_path_rates": engine["rates"],
        "ball_main_path": {"launches": ball["launches"],
                           "rates": ball["rates"],
                           "roller_smallbilliard": ball["roller"],
                           "ant_smallbilliard_world": ball["ant_world"]}})
    for kind, line in (("step", "635"), ("rollout", "621")):
        kernels.append({
            **quasi[kind], "name": f"point_quasi_{kind}_kernel", "route": "cuda",
            "source": "mujoco_maze_tpu_torch/csrc/point_lane.cu",
            "replaces": f"mujoco_maze_tpu/ops/point_pallas.py:{line} "
                        "(_push_blocks_lanes :230, _step_balls_lanes :325)",
            "library_ms": None,
            "worlds": "the 27 Point object worlds with a Point robot without "
                      "the object solve (USES_POINT_WORLD = False)",
            "main_path": " and ".join(QUASI_MAIN_IDS) + " with that robot",
            **({"main_path_rates": {k: m["rates"] for k, m in
                                    quasi["main_paths"].items()},
                "float64_path": quasi["float64"]} if kind == "step" else {})})
    log(f"done in {time.perf_counter() - T0:.1f} s (build {build_s:.2f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    ARGS = sys.argv[1:]
    sys.exit(point_objects_phases() if OBJ_FLAG in ARGS
             else point_quasi_phases() if QUASI_FLAG in ARGS
             else engine_phases() if ENGINE_FLAG in ARGS
             else ant_balls_phases() if BALLS_FLAG in ARGS
             else registry_sweep(ARGS) if ARGS[:1] == [SWEEP_FLAG]
             else ant_parent_probe(ARGS[1:]) if ARGS[:1] == [PROBE_FLAG]
             else ant_phases() if ARGS[:1] == [PHASES_FLAG]
             else probe_outputs(ARGS[1:]) if ARGS[:1] == [PROBE_OUT_FLAG]
             else point_parent_probe(ARGS[1:])
             if ARGS[:1] == [POINT_PROBE_FLAG]
             else point_probe_outputs(ARGS[1])
             if ARGS[:1] == [POINT_PROBE_OUT_FLAG]
             else engine_faults() if FAULTS_FLAG in ARGS
             else engine_check(ARGS[1:]) if ARGS[:1] == [CHECK_FLAG]
             else main())
