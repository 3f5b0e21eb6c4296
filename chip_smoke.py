"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mujoco_maze_tpu_torch/csrc`` (one ``nvcc``
per source, all started together, then one link), holds each kernel
against its plain PyTorch version, drives the port's main paths —
``make_batched(id, 4096)`` for PointUMaze-v0, AntUMaze-v0, AntPush-v0 and
AntFall-v0, each stepped through the public API, ``rollout_metrics``, and
the fused random-policy rollout — counts the kernel launches of each path,
and times them with CUDA events.

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
8. each Ant kernel's time per launch by block size, device time, bound
   and plain time;
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
13. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
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
    block has left the maze)."""
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
                parts.append(f"{name} in the {who} only: sphere {bit % S} vs "
                             f"{kinds[bit // S]}")
        for name, only in (("kernel only", ck - cp), ("plain only", cp - ck)):
            for bit in sorted(only):
                c = bits.index(bit) if bit in bits else None
                gap = (f"{float(info['gap'][0, ev, c]):.3g}" if c is not None
                       else "n/a")
                parts.append(f"{name}: sphere {bit % S} vs {kinds[bit // S]} "
                             f"(plain dist - margin {gap})")
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
                   min_steps: int, max_steps: int):
    """Phases 5 and 9 for one ID: the step kernel vs its plain version,
    teacher-forced from the public step API's trajectory, from states
    that touch the world (``contact_states``; in the block worlds
    ``block_states``: legs on block faces, blocks at and beyond their
    travel limits, the Fall block perched or over the chasm)."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EnvState
    from mujoco_maze_tpu_torch.ops import make_fast_step
    from mujoco_maze_tpu_torch.ops.ant_kernel import (active_trace,
                                                      ant_step_plain,
                                                      block_census,
                                                      block_states,
                                                      contact_census,
                                                      contact_states)

    env = mmt.make_batched(env_id, B)
    spec = env.spec
    blocks = bool(spec.block_runtimes)
    kstep = make_fast_step(env)
    ks = kstep.ks
    make_states = block_states if blocks else contact_states
    q, v, t = (torch.as_tensor(x, device="cuda")
               for x in make_states(spec, B, seed))
    st = EnvState(qpos=q, qvel=v, t=t)
    obs = spec._observe(st)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = env.random_policy()
    # the object-free states settle through the public API first; the
    # block worlds' start as drawn, at and beyond the travel limits
    for _ in range(0 if blocks else ANT_SETTLE):
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
    most_active = 0
    blown_envs = torch.zeros(B, dtype=torch.bool, device="cuda")
    seen = {name: torch.zeros(B, dtype=torch.bool, device="cuda")
            for name in ("floor", "wall", "block", "limit", "perched", "chasm")}
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
        qp, vp, tp, rp, mp = ant_step_plain(ks, st.qpos, st.qvel, st.t, act)
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
        if blocks:
            # in the block worlds an env-step beyond the qpos or reward
            # bound is held to be a knife edge: one version alone switches
            # a contact, a limit, the support's rows, a sphere's side of a
            # box face or a tangent frame at some forward evaluation
            over = torch.nonzero((eq > ANT_QPOS_TOL) | (er > ANT_REWARD_TOL))[:, 0]
            if len(over):
                tr_p = active_trace(ks, st.qpos[over], st.qvel[over], act[over])
                knife = over[(out[6][over] != tr_p).flatten(1).any(dim=1)]
                knife_steps += len(knife)
                knife_max = max(knife_max, float(eq[knife].max())
                                if len(knife) else 0.0)
                knife_rew = max(knife_rew, float(er[knife].max())
                                if len(knife) else 0.0)
                eq[knife] = 0.0
                er[knife] = 0.0
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
        f"forward evaluation (of {ks.offsets['sph'][1] * (3 + ks.n_blk)} "
        f"candidates; the kernel's list holds {40 * (6 if ks.n_w else 3)}); "
        f"envs whose plain state blew up "
        f"(non-finite, |qvel| > {BLOWN_QVEL:g} or a block {BLOWN_TRAVEL:g} past "
        f"its travel) {int(blown_envs.sum())}, "
        f"env-steps where only one version did {blow_mis} (tol 0)"
        + (f"; env-steps beyond the qpos or reward bound at a knife edge (a "
           f"switch in one version only) {knife_steps} (tol "
           f"{int(KNIFE_SHARE * steps * B)}), their max qpos {knife_max:.3g}, "
           f"reward {knife_rew:.3g}" if blocks else ""))
    dump_divergence(env_id, phase, ks, kstep, saved, torch.stack(raw_q))
    tols = {"qpos": ANT_QPOS_TOL, "reward": ANT_REWARD_TOL}
    if (any(not stats[k][1] <= tol for k, tol in tols.items())  # NaN fails
            or not qv_quant <= ANT_QVEL_TOL or not stats["qvel"][1] < 1e3
            or t_diff or term_mis or blow_mis
            or knife_steps > KNIFE_SHARE * steps * B
            or (not blocks and int(blown_envs.sum()))):
        raise SystemExit(f"ant step kernel disagrees with its plain version on {env_id}")
    if resets == 0 or (not blocks and (
            cover["wall"] == 0 or cover["floor"] < B // 2)):
        raise SystemExit(f"{env_id}: expected feet on the floor, walls and resets")
    if blocks and (cover["block"] < B // 10 or cover["limit"] < B // 10 or (
            spec._falling_support
            and (cover["perched"] < B // 4 or cover["chasm"] < B // 10))):
        raise SystemExit(f"{env_id}: expected legs on blocks, blocks at their "
                         "limits, and perched and fallen Fall blocks")
    return max(stats[k][1] for k in stats)


def ant_rollout_check(env_id: str, seed: int, phase: str):
    """Phases 6 and 10 for one ID: the rollout kernel vs its plain version
    over ANT_ROLL_STEPS steps from t spread over the window's end, from
    the env's own reset states: every env resets; the reset draws of the
    envs reset on the last step are the plain version's to the bit, and
    their world dofs are back at qpos0, at rest."""
    import mujoco_maze_tpu_torch as mmt
    from mujoco_maze_tpu_torch.envs.env import EPISODE_LIMIT
    from mujoco_maze_tpu_torch.ops import make_fast_rollout
    from mujoco_maze_tpu_torch.ops.ant_kernel import (ant_rollout_plain,
                                                      contact_states,
                                                      rollout_reset)

    env = mmt.make_batched(env_id, B)
    roll = make_fast_rollout(env, ANT_ROLL_STEPS)
    if env.spec.block_runtimes:
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
                             env.spec.init_qpos)
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


# fp32 operations of one Ant env step, counted from csrc/ant_lane.cuh (a
# sine, cosine, square root, division, min or max counts as one; integer
# and Philox work not counted).  Per forward evaluation, fixed: kinematics
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
    nq, nv = 15 + ks.n_w, 14 + ks.n_w
    io = 4 * (nq + nv + 1)
    return 2 * io + 32 + 4 + 1 if per_launch == "step" else 2 * io + 8


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
    sizes = ((64, lane_env.ANT_BLOCK) if blocks
             else (128, 64, lane_env.ANT_BLOCK))
    block_ms = {}
    for blk in sizes:
        kstep.block = blk
        block_ms[blk] = cuda_ms(lambda: kstep(st.qpos, st.qvel, st.t, act), 20)
    log(f"phase {numbers_phase}: {env_id} ant step ms per launch by threads per "
        f"block: {block_ms}")
    ms_step = block_ms[lane_env.ANT_BLOCK]
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
                 "ms": ms_step, "plain_ms": ms_step_plain,
                 "bound_ms": step_bound[0], "bound_by": step_bound[1]},
        "rollout": {"name": roll_name, "launches": launches[roll_name],
                    "ms": ms_roll, "plain_ms": ms_roll_plain,
                    "bound_ms": roll_bound[0], "bound_by": roll_bound[1]},
    }


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
            or any(n for k, n in launches.items() if k.startswith("ant"))):
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
                       ANT_MIN_CHECK_STEPS, ANT_MAX_CHECK_STEPS)
        for k, env_id in enumerate(ANT_IDS))
    ant_roll_err = max(ant_rollout_check(env_id, 41 + k, "6")
                       for k, env_id in enumerate(ANT_IDS))
    ant = ant_main_path(ANT_MAIN_ID, "7", "8")

    # -- 9-12. the Ant block worlds -------------------------------------------
    block_step_err = max(
        ant_step_check(env_id, 51 + k, "9", 0.0, BLOCK_CHECK_STEPS,
                       BLOCK_CHECK_STEPS)
        for k, env_id in enumerate(BLOCK_IDS))
    block_roll_err = max(ant_rollout_check(env_id, 61 + k, "10")
                         for k, env_id in enumerate(BLOCK_MAIN_IDS))
    fall_mechanic_check()
    blocks = {env_id: ant_main_path(env_id, "12", "12")
              for env_id in BLOCK_MAIN_IDS}

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
    log(f"done in {time.perf_counter() - T0:.1f} s (build {build_s:.2f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
