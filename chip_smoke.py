"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mujoco_maze_tpu_torch/csrc`` (one ``nvcc``
call), holds each kernel against its plain PyTorch version, drives the
port's two main paths — ``make_batched("PointUMaze-v0", 4096)`` and
``make_batched("AntUMaze-v0", 4096)``, each stepped through the public
API, ``rollout_metrics``, and the fused random-policy rollout — counts the
kernel launches of each path, and times them with CUDA events.

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
   against walls, with t spread over the episode;
6. the Ant rollout kernel against its plain version (the same Philox
   stream), 8 steps from t spread over [992, 1000): every env resets;
7. the Ant main path at 4096 envs, 1000 steps per path, counted and timed
   as in phase 4, with checks of what comes out;
8. each Ant kernel's time per launch, device time, bound and plain time;
9. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": {...}}`` line.

It needs one CUDA device and exits non-zero without one.  It imports
torch, numpy and the port only: no JAX, no gymnasium, nothing of the JAX
package.
"""

from __future__ import annotations

import json
import math
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
ANT_CHECK_BUDGET_S = 45.0   # phase 5's plain steps, over the three IDs
ANT_SETTLE = 4              # public-API steps before the comparison starts
ANT_ROLL_STEPS = 8
# The Ant kernel and its plain version compute the same function by
# different algorithms (csrc/ant_lane.cu, "Arithmetic"): bounds from the
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
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


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


# fp32 operations of one Ant env step, counted from csrc/ant_lane.cu (a
# sine, cosine, square root, division, min or max counts as one; integer
# and Philox work not counted).  Per forward evaluation, fixed: kinematics
# 1,641; mass matrix 7,839; RNE bias 4,306; actuation 60; Cholesky and
# inverse 6,531; qacc0 406; joint limits 320; sphere detection (floor and
# the 4 near boxes, 37 spheres) 8,436; near-box prune 22 per box; qacc
# 420.  Per active contact (rows, A = J Minv J^T, 4 Jacobi sweeps,
# J^T f): 1,379; the sweeps' Minv products of a forward with contacts
# (1,568) are left out, so the bound stays a lower bound.  Per step: 20
# forward evaluations, 5 RK4 integrations of 790, the heads 30 + 12 per
# goal.
ANT_FORWARD_FIXED = 1641 + 7839 + 4306 + 60 + 6531 + 406 + 320 + 8436 + 420


def ant_step_flops(n_box: int, n_goal: int) -> int:
    """Fixed fp32 operations of one env step (without contacts)."""
    return 20 * (ANT_FORWARD_FIXED + 22 * n_box) + 5 * 790 + 30 + 12 * n_goal


ANT_FLOPS_PER_CONTACT = 1379
# bytes per env of one step launch: qpos 60 + qvel 56 + t 4 + actions 32 in;
# qpos 60 + qvel 56 + t 4 + reward 4 + terminated 1 out
ANT_STEP_BYTES = 60 + 56 + 4 + 32 + 60 + 56 + 4 + 4 + 1
# a rollout reads qpos, qvel, t and writes them with reward sums and counts
ANT_ROLL_BYTES = 60 + 56 + 4 + 60 + 56 + 4 + 4 + 4


def device_ms(prof, name: str):
    """Device time per launch (ms) of the kernels whose name holds
    ``name`` in a profile, and their launch count."""
    hits = [e for e in prof.key_averages()
            if name in e.key and e.self_device_time_total > 0]
    n = sum(e.count for e in hits)
    return (sum(e.self_device_time_total for e in hits) / n / 1e3 if n else
            float("nan")), n


def knife_edges(ks, qpos: torch.Tensor) -> torch.Tensor:
    """Envs whose goal distance at ``qpos`` lies within KNIFE_EDGE of a
    valid goal's threshold: there `terminated` may rightly differ."""
    g = ks.env_spec.heads.goals
    d = ((qpos[:, None, :3] - g.pos) * g.dim_mask).norm(dim=-1)
    return (((d - g.threshold).abs() < KNIFE_EDGE) & g.valid).any(dim=1)


def ant_step_check(env_id: str, seed: int):
    """Phase 5 for one ID: the step kernel vs its plain version,
    teacher-forced from the public step API's trajectory."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_step_plain,
                                                      contact_census,
                                                      contact_states)

    env = mmt.make_batched(env_id, B)
    kstep = make_fast_step(env)
    ks = kstep.ks
    q, v, t = (torch.as_tensor(x, device="cuda")
               for x in contact_states(env.spec, B, seed))
    st = EnvState(qpos=q, qvel=v, t=t)
    obs = env.spec._observe(st)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = env.random_policy()
    for _ in range(ANT_SETTLE):
        res = env.step(st, policy(obs, gen))
        st, obs = res.state, res.obs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ant_step_plain(ks, st.qpos, st.qvel, st.t, policy(obs, gen))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    steps = int(min(ANT_MAX_CHECK_STEPS, max(
        ANT_MIN_CHECK_STEPS, ANT_CHECK_BUDGET_S / (len(ANT_IDS) * plain_s))))
    errs = {"qpos": [], "qvel": [], "reward": []}
    t_diff = term_mis = knife_mis = knife_envs = resets = 0
    floor_seen = torch.zeros(B, dtype=torch.bool, device="cuda")
    wall_seen = torch.zeros_like(floor_seen)
    active = 0
    for _ in range(steps):
        act = policy(obs, gen)
        qk, vk, tk, rk, mk, ak = kstep(st.qpos, st.qvel, st.t, act,
                                       count_active=True)
        qp, vp, tp, rp, mp = ant_step_plain(ks, st.qpos, st.qvel, st.t, act)
        errs["qpos"].append((qk - qp).abs().max(dim=1).values)
        errs["qvel"].append((vk - vp).abs().max(dim=1).values)
        errs["reward"].append((rk - rp).abs())
        t_diff += int((tk != tp).sum())
        edge = knife_edges(ks, qp)
        knife_envs += int(edge.sum())
        term_mis += int(((mk != mp) & ~edge).sum())
        knife_mis += int(((mk != mp) & edge).sum())
        floor, walls = contact_census(ks, st.qpos)
        floor_seen |= floor > 0
        wall_seen |= walls > 0
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
    log(f"phase 5: {env_id} ant step kernel vs plain, {steps} teacher-forced "
        f"steps x {B} envs (one plain step {plain_s:.3f} s): "
        + "; ".join(f"{k} median {m:.3g} max {x:.3g} envs>1e-4 {n}"
                    for k, (m, x, n) in stats.items())
        + f"; qvel {100 * ANT_QVEL_QUANTILE:g}th percentile {qv_quant:.3g} "
        f"(tol {ANT_QVEL_TOL}), env-steps beyond it {qv_beyond} of {qv.numel()}"
        + f"; t mismatches {t_diff} (tol 0); terminated mismatches {term_mis} "
        f"(tol 0) and {knife_mis} at the {knife_envs} knife-edge env-steps; "
        f"envs on the floor {int(floor_seen.sum())}, against a wall "
        f"{int(wall_seen.sum())}; episodes ended {resets}; active contacts "
        f"per env-step {active / (steps * B):.4g}")
    tols = {"qpos": ANT_QPOS_TOL, "reward": ANT_REWARD_TOL}
    if (any(not stats[k][1] <= tol for k, tol in tols.items())  # NaN fails
            or not qv_quant <= ANT_QVEL_TOL or not stats["qvel"][1] < 1e3
            or t_diff or term_mis):
        raise SystemExit(f"ant step kernel disagrees with its plain version on {env_id}")
    if int(wall_seen.sum()) == 0 or int(floor_seen.sum()) < B // 2 or resets == 0:
        raise SystemExit(f"{env_id}: expected feet on the floor, walls and resets")
    return max(stats[k][1] for k in stats)


def ant_rollout_check(env_id: str, seed: int):
    """Phase 6 for one ID: the rollout kernel vs its plain version over
    ANT_ROLL_STEPS steps from t spread over the window's end."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      contact_states,
                                                      rollout_reset)

    env = mmt.make_batched(env_id, B)
    roll = make_fast_rollout(env, ANT_ROLL_STEPS)
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
                             env.spec.init_qpos)
    draw_err = max(float((kern[0][last] - q_r[last]).abs().max()),
                   float((kern[1][last] - v_r[last]).abs().max()),
                   float((plain[0][last] - q_r[last]).abs().max()),
                   float((plain[1][last] - v_r[last]).abs().max()))
    q_err = float((kern[0] - plain[0]).abs().max())
    eps_k = int(kern[4].sum())
    log(f"phase 6: {env_id} ant rollout kernel vs plain, {ANT_ROLL_STEPS} steps x "
        f"{B} envs from t in [{EPISODE_LIMIT - ANT_ROLL_STEPS}, {EPISODE_LIMIT}): "
        f"episodes {eps_k} vs {int(plain[4].sum())}, envs whose counts differ "
        f"{eps_diff} (tol 0); reset draws of the {int(last.sum())} envs reset on "
        f"the last step: max |err| {draw_err:.3g} (tol {ANT_RESET_TOL}); qpos "
        f"max |err| {q_err:.3g} (tol {ANT_QPOS_TOL})")
    if (eps_diff or not draw_err <= ANT_RESET_TOL or not q_err <= ANT_QPOS_TOL
            or int(kern[4].min()) < 1 or int(last.sum()) < B // ANT_ROLL_STEPS // 2):
        raise SystemExit(f"ant rollout kernel disagrees with its plain version on {env_id}")
    return max(q_err, draw_err)


def ant_main_path():
    """Phases 7 and 8: the Ant main path through the public API, counted
    and timed, its outputs checked; then each Ant kernel's numbers."""
    import numpy as np

    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import (lane_env, make_fast_rollout,
                                           make_fast_step)
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      ant_step_plain,
                                                      contact_states)
    from torch.profiler import ProfilerActivity, profile

    env = mmt.make_batched(ANT_MAIN_ID, B)
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
    log(f"phase 7: ant main path {ANT_MAIN_ID} x {B} envs, {MAIN_STEPS} steps per "
        f"path; launches {launches}")
    expected = {"point_step": 0, "point_rollout": 0,
                "ant_step": 2 * MAIN_STEPS, "ant_rollout": 1}
    if launches != expected:
        raise SystemExit(f"ant main path launches {launches}, expected {expected}")
    rate = lambda ms: B * MAIN_STEPS / (ms * 1e-3)
    log(f"phase 7: env-steps/s (CUDA events): step API {rate(ms_api):.6g}, "
        f"rollout_metrics {rate(ms_metrics):.6g}, fused rollout {rate(ms_fused):.6g} "
        f"({ms_fused:.6g} ms per 1000-step launch)")
    quat_norm = qf[:, 3:7].norm(dim=1)
    checks = {
        "obs shape (B, 30)": tuple(obs.shape) == (B, 30),
        "obs finite": bool(torch.isfinite(obs).all()),
        "obs time channel = t * 0.001": bool(
            (obs[:, -1] == st.t.float() * 0.001).all()),
        "obs = (qpos, qvel, t)": bool(
            (obs[:, :15] == st.qpos).all() and (obs[:, 15:29] == st.qvel).all()),
        "rollout_metrics reward finite and < 0 (dist reward)": bool(
            torch.isfinite(rew_m)) and float(rew_m) < 0,
        "rollout_metrics ended >= B episodes": int(eps_m) >= B,
        "fused state finite": bool(torch.isfinite(qf).all() and torch.isfinite(vf).all()),
        "fused torso height in (0, 2)": bool(((qf[:, 2] > 0) & (qf[:, 2] < 2)).all()),
        "fused quaternions unit (1e-5)": float((quat_norm - 1).abs().max()) < 1e-5,
        "fused t < 1000 (auto-reset at the episode limit)": int(tf.max()) < 1000,
        "fused reward < 0 (dist reward)": float(rew_f) < 0,
        "fused episodes >= B (truncation at 1000)": int(eps_f) >= B,
    }
    log(f"phase 7: output checks {checks}")
    if not all(checks.values()):
        raise SystemExit("the ant main path's output failed a check")

    # the port's CUDA path against its CPU path on a small input
    n_small = 16
    cpu_env = mmt.make_batched(ANT_MAIN_ID, n_small, auto_reset=False, device="cpu")
    gpu_env = mmt.make_batched(ANT_MAIN_ID, n_small, auto_reset=False)
    q, v, t = (torch.as_tensor(x) for x in contact_states(cpu_env.spec, n_small, 9))
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
    log(f"phase 7: ant CUDA path vs CPU path, {n_small} envs x 3 steps "
        f"teacher-forced: max |err| qpos and reward {small_err:.3g} "
        f"(tol {ANT_QPOS_TOL})")
    if not small_err <= ANT_QPOS_TOL:
        raise SystemExit("the ant CUDA path disagrees with the CPU path")

    # -- 8. per-kernel numbers at the main path's shapes ---------------------
    kstep = make_fast_step(env)
    ks = kstep.ks
    act = policy(obs, gen)
    for blk in (128, 64, lane_env.ANT_BLOCK):
        kstep.block = blk
        ms_blk = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 20)
        log(f"phase 8: ant_step at {blk} threads per block: {ms_blk:.6g} ms per launch")
    ms_step = ms_blk
    ms_step_plain = cuda_ms(lambda: ant_step_plain(ks, st.qpos, st.qvel, st.t, act), 2)
    active_step = int(kstep(st.qpos, st.qvel, st.t, act, count_active=True)[5].sum())
    roll8 = make_fast_rollout(env, ANT_ROLL_STEPS)
    ms_roll = cuda_ms(lambda: roll8(st.qpos, st.qvel, st.t, 19), 5)
    ms_roll_plain = cuda_ms(lambda: ant_rollout_plain(
        ks, st.qpos, st.qvel, st.t, 19, ANT_ROLL_STEPS), 1)
    active_roll = int(roll8.per_env(st.qpos, st.qvel, st.t, 19,
                                    count_active=True)[5].sum())
    n_box, n_goal = ks.offsets["box"][1], ks.offsets["goals"][1]
    tables = 4 * ks.packed.numel()
    step_bound = bound(B * ANT_STEP_BYTES + tables,
                       B * ant_step_flops(n_box, n_goal)
                       + ANT_FLOPS_PER_CONTACT * active_step)
    roll_bound = bound(B * ANT_ROLL_BYTES + tables,
                       B * ANT_ROLL_STEPS * ant_step_flops(n_box, n_goal)
                       + ANT_FLOPS_PER_CONTACT * active_roll)

    # device times, and where a step-API step's time goes
    acts = [policy(obs, gen) for _ in range(20)]
    s = st
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        for a in acts:
            s = env.step(s, a).state
        ev[1].record()
        torch.cuda.synchronize()
    window_us = 1e3 * ev[0].elapsed_time(ev[1])
    on_device = [e for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in on_device)
    dev_step, n_step = device_ms(prof, "ant_step_kernel")
    log(f"phase 8: profiled ant step API, 20 steps in {window_us:.6g} us: device "
        f"busy {busy_us:.6g} us (idle share {1 - busy_us / window_us:.4g}), "
        f"{sum(e.count for e in on_device) // 20} kernels/step; ant_step_kernel "
        f"{dev_step:.6g} ms per launch on the device ({n_step} launches)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            roll8(st.qpos, st.qvel, st.t, 23)
        torch.cuda.synchronize()
    dev_roll, _ = device_ms(prof, "ant_rollout_kernel")
    log(f"phase 8: ant_step {ms_step:.6g} ms/launch ({active_step} active "
        f"contacts summed over its forward evaluations; plain {ms_step_plain:.6g} "
        f"ms, bound {step_bound[0]:.3g} ms by {step_bound[1]}); ant_rollout "
        f"{ms_roll:.6g} ms per {ANT_ROLL_STEPS}-step launch, {dev_roll:.6g} ms on "
        f"the device (plain {ms_roll_plain:.6g} ms, bound {roll_bound[0]:.3g} ms "
        f"by {roll_bound[1]}); {n_box} boxes, {n_goal} goal")
    src = "mujoco_maze_tpu_torch/csrc/ant_lane.cu"
    entries = [
        {"name": "ant_step", "route": "cuda", "source": src,
         "replaces": "mujoco_maze_tpu/ops/ant_pallas.py:228",
         "launches": launches["ant_step"], "ms": ms_step,
         "plain_ms": ms_step_plain, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None},
        {"name": "ant_rollout", "route": "cuda", "source": src,
         "replaces": "mujoco_maze_tpu/ops/ant_pallas.py:222",
         "launches": launches["ant_rollout"], "ms": ms_roll,
         "plain_ms": ms_roll_plain, "bound_ms": roll_bound[0],
         "bound_by": roll_bound[1], "library_ms": None},
    ]
    return entries


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
            or launches["ant_step"] or launches["ant_rollout"]):
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

    # -- 5-8. the Ant ------------------------------------------------------
    ant_step_err = max(ant_step_check(env_id, 31 + k)
                       for k, env_id in enumerate(ANT_IDS))
    ant_roll_err = max(ant_rollout_check(env_id, 41 + k)
                       for k, env_id in enumerate(ANT_IDS))
    ant_kernels = ant_main_path()
    ant_kernels[0]["max_abs_err"] = ant_step_err
    ant_kernels[1]["max_abs_err"] = ant_roll_err

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
    ] + ant_kernels
    log(f"done in {time.perf_counter() - T0:.1f} s (build {build_s:.2f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
