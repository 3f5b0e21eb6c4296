"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mujoco_maze_tpu_torch/csrc`` (one ``nvcc``
call), holds each kernel against its plain PyTorch version, drives the
port's main path — ``make_batched("PointUMaze-v0", 4096)`` stepped through
the public API, ``rollout_metrics``, and the fused random-policy rollout —
counts the kernel launches of that path, and times it with CUDA events.

Phases (each fails the run on its own; nothing is caught):

1. build, and the card's name and power limit;
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
5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
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
    if min(launches.values()) <= 0:
        raise SystemExit("a kernel of the main path was never launched")
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
    log(f"done in {time.perf_counter() - T0:.1f} s (build {build_s:.2f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
