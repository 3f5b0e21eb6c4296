// Point robot: the step and rollout kernels, on a plain (object-free)
// maze and in the object worlds.
//
// Replaces the TPU kernels of the JAX package:
//   point_step    <- mujoco_maze_tpu/ops/lane_env.py LaneEnvKernel.build_step
//                    with ops/point_pallas.py build_step_kernel / _step_math
//                    (and _detect, _resolve, lane_env.goal_heads)
//   point_rollout <- mujoco_maze_tpu/ops/lane_env.py LaneEnvKernel.build_rollout
//                    with ops/point_pallas.py build_rollout_kernel
//                    (sample_ctrl / sample_reset, lane_env.uniform)
//   point_obj_step, point_obj_rollout <- the same, in the object worlds:
//                    the reduced object solve of point_objects.cuh runs
//                    between the kinematics and the residual
//                    (_step_math :419-430), the heads read the first object
//                    where the task says so (:567-574), and a reset puts
//                    the world dofs at 0, at rest (sample_reset :599-612).
//   point_quasi_step, point_quasi_rollout <- the same, in the object worlds
//                    of a Point robot without the object solve: the
//                    quasi-static block push with its pair separation
//                    (point_pallas.py _push_blocks_lanes :230) and the
//                    kick/roll/bounce ball (_step_balls_lanes :325) run at
//                    the robot's post-residual position (the branch
//                    :445-456), and the heads read the first object through
//                    its qpos addresses.
//
// point_step has three modes: the plain mazes' (kPlainMode), the reduced
// object solve (kObjMode) and the quasi-static rows (kQuasiMode).  Each
// mode's code sits behind if constexpr, so the plain and object-solve
// instantiations are the same code as before the quasi-static mode came.
//
// Design.  The plain-maze and quasi-static kernels: one thread is one
// env; its state stays in registers for the whole step (or the whole
// rollout).  Blocks of 128 threads; the last block masks the ragged edge.
// The object-solve kernels (point_obj_step_kernel,
// point_obj_rollout_kernel): a group of mmt_obj::kLanes lanes is one
// env, the warp's groups in lockstep, ObjParams::groups envs a block;
// each is built twice, for the envs' row stores in shared memory and in
// global memory (kSharedRows, picked by ObjParams::shared_rows), so that
// the shared stores are addressed as shared memory;
// every lane of the group runs the robot's part of the step on the same
// values, the lanes share the object solve, and the group's lane 0 writes
// the env's outputs (point_objects.cuh, "Design").  The Pallas kernels
// baked the wall segments and goals into the program at trace time; here
// they are runtime tables (walls (W, 4), goals (G, 9)) that each block
// stages into shared memory (48 walls are 768 bytes), and the scalars
// come by value in PointParams.  So one binary, built once, serves every
// plain Point maze.
//
// Layout.  The kernels read and write the public (B, nq) row-major tensors
// in place, with the row strides passed in.  The JAX wrapper transposed to
// (nq, B) to put the batch on the TPU's 128-wide lanes; on this card a warp
// reading 32 rows of 3 floats touches 384 contiguous bytes, so the
// row-major layout costs no extra memory transactions and saves the
// transposes.
//
// What bounds them on an H100.  A step moves about 70 bytes per env
// (q, v, t, actions in; q, v, t, reward, terminated out): 0.3 MB at
// B = 4096, under a tenth of a microsecond of HBM3 time, and some 3,000
// float operations per env, a few tenths of a microsecond at the fp32 peak.
// So the step kernel is bound by the launch itself (a few microseconds).
// The rollout keeps the state in registers for all its steps and is bound
// by fp32 arithmetic: per env-step, W walls times (ejection + 2 arrow tips
// + 2 crossing-detect passes), plus the sines and cosines.  At B = 4096 one
// thread per env fills only 32 of 132 SMs with 4 warps each; that, and the
// serial dependence inside a step, is the first thing to attack when the
// plain-maze kernels are made fast.  The object-solve kernels are bound by
// each env's chain of dependent solve steps (point_objects.cuh, "What
// bounds it"); their groups spread 4096 envs over every SM.
//
// Arithmetic.  The plain PyTorch versions (ops/segments.py,
// models/point.py, tasks/core.py) and this file do the same float32
// operations in the same order: divisions by constants are products with
// float32 reciprocals passed in PointParams, sums of a few terms are
// written out left to right, and the library is built without
// fast-math flags and with -fmad=false, so no multiply-add is contracted.
// The wrap at +-pi, the c_old*c_new <= 0 and cw1*cw2 <= 0 crossing tests
// and a != 0 are knife edges; precise sinf/cosf/sqrtf keep them where the
// plain versions put them.  Wall contributions are summed in wall order,
// from 0, here and there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "point_objects.cuh"

struct PointParams {
  float dt, com_offset, vel_limit;
  float margin, lam, mu, edecay;        // wall-contact ejection
  float restitution, radius;            // manual collision, tip inflation
  float inv_m, arm_over_m, inv_ip, coef;  // arrow-tip 3-dof response
  float tip0x, tip0y, tip1x, tip1y;     // arrow-tip corners, body frame
  float penalty, inv_scale;             // task heads
  int reward_type;                      // 0 none, 1 dist, 2 goal
  int episode_limit;
};

// The quasi-static rows' counts (mirrors lane_env.QuasiParams); outside
// the anonymous namespace, as the C entry points take it by value.
struct QuasiParams {
  int n_blocks, n_balls, n_walls, n_world, n_table, head_obj;
};

namespace {

constexpr int kBlock = 128;
constexpr int kWallCols = 4;   // p1x p1y p2x p2y
constexpr int kGoalCols = 9;   // pos(3) dim_mask(3) threshold^2 reward_scale valid
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Tables {
  const float* walls;  // shared memory, n_walls x kWallCols
  int n_walls;
  const float* goals;  // shared memory, n_goals x kGoalCols
  int n_goals;
};

__device__ __forceinline__ float sign_of(float x) {  // torch.sign
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// Nearest wall crossing of (ox, oy) -> (nx, ny): segments.detect.  The
// first wall with the least squared distance wins, as torch.argmin does.
__device__ bool detect(const Tables& tb, float ox, float oy, float nx,
                       float ny, float* bpx, float* bpy, float* brx,
                       float* bry) {
  const float dx = nx - ox, dy = ny - oy;
  const bool moved = dx * dx + dy * dy > 1e-16f;
  bool any = false;
  float best = INFINITY;
  *bpx = 0.f; *bpy = 0.f; *brx = 0.f; *bry = 0.f;
  for (int w = 0; w < tb.n_walls; ++w) {
    const float* s = tb.walls + w * kWallCols;
    const float p1x = s[0], p1y = s[1], p2x = s[2], p2y = s[3];
    const float v1x = p2x - p1x, v1y = p2y - p1y;
    const float nrm2 = v1x * v1x + v1y * v1y;
    const float safe_n = nrm2 == 0.f ? 1.f : nrm2;
    const float c_old = v1x * (oy - p1y) - v1y * (ox - p1x);
    const float c_new = v1x * (ny - p1y) - v1y * (nx - p1x);
    const bool s1 = c_old * c_new <= 0.f;
    const float cw1 = dx * (p1y - oy) - dy * (p1x - ox);
    const float cw2 = dx * (p2y - oy) - dy * (p2x - ox);
    const bool s2 = cw1 * cw2 <= 0.f;
    const float a = v1x * dy - v1y * dx;
    const float b = v1x * (p2y - oy) - v1y * (p2x - ox);
    const float t = b / (a == 0.f ? 1.f : a);
    const float px = ox + t * dx, py = oy + t * dy;
    const bool hit = s1 && s2 && moved && a != 0.f;
    const float sc = ((nx - p1x) * v1x + (ny - p1y) * v1y) / safe_n;
    const float rx = 2.f * (p1x + sc * v1x) - nx;
    const float ry = 2.f * (p1y + sc * v1y) - ny;
    const float ex = px - ox, ey = py - oy;
    const float d2 = ex * ex + ey * ey;
    if (hit && d2 < best) {
      best = d2; *bpx = px; *bpy = py; *brx = rx; *bry = ry;
    }
    any = any || hit;
  }
  return any;
}

// An object world's data for the step: its scalars, its table (shared
// memory), this env's group of lanes with its row store, and its trace
// (nullable).
struct ObjCtx {
  ObjParams p;
  const float* tab;
  mmt_obj::Group g;
  uint32_t* trace;
};

// The quasi-static rows' table (shared memory; ops/point_kernel.py
// quasi_table): a header, then the blocks, the ball, the ball walls.
constexpr int kQuasiMaxWorld = 9;    // world dofs of the build
constexpr int kQHead = 16, kQBlock = 16, kQBall = 8;
constexpr int kQPushR = 6, kQKick = 7, kQKeep = 8;   // header slots
struct QuasiCtx {
  QuasiParams p;
  const float* tab;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// A world dof's value by qpos address (>= 3), or 0 where absent (-1).
__device__ __forceinline__ float world_at(const float* w, int adr) {
  return adr >= 0 ? w[adr - 3] : 0.f;
}

// Quasi-static push of the blocks by the robot disc at (x, y), then the
// pair separation (MazeEnvSpec._push_blocks / _separate_blocks, in their
// order of operations); the kick/roll/bounce ball (_step_balls).  wq, wv:
// the env's world dofs.
__device__ void quasi_rows(const QuasiCtx& qc, const PointParams& p, float x,
                           float y, float* wq, float* wv) {
  const float* tab = qc.tab;
  const float push_r = tab[kQPushR];
  for (int k = 0; k < qc.p.n_blocks; ++k) {
    const float* b = tab + kQHead + k * kQBlock;
    const int ix = (int)b[11], iy = (int)b[12];
    const float cx = b[0] + world_at(wq, ix);
    const float cy = b[1] + world_at(wq, iy);
    const float lox = cx - b[3], hix = cx + b[3];
    const float loy = cy - b[4], hiy = cy + b[4];
    const float dx = x - clampf(x, lox, hix), dy = y - clampf(y, loy, hiy);
    const float dist = sqrtf(dx * dx + dy * dy + 1e-12f);
    const float overlap = push_r - dist;
    const bool far = dist > 1e-6f;
    // inside the AABB: out along the least exit depth, the first of equal
    const float pen0 = hix - x, pen1 = x - lox, pen2 = hiy - y, pen3 = y - loy;
    const bool use_x = fminf(pen0, pen1) <= fminf(pen2, pen3);
    const float nix = use_x ? (pen0 <= pen1 ? 1.f : -1.f) : 0.f;
    const float niy = use_x ? 0.f : (pen2 <= pen3 ? 1.f : -1.f);
    const float nx = far ? -dx / dist : nix;
    const float ny = far ? -dy / dist : niy;
    const float push = overlap > 0.f ? overlap : 0.f;
    if (ix >= 0) wq[ix - 3] = clampf(cx + push * nx * b[5], b[7], b[9]) - b[0];
    if (iy >= 0) wq[iy - 3] = clampf(cy + push * ny * b[6], b[8], b[10]) - b[1];
  }
  for (int i = 0; i < qc.p.n_blocks; ++i) {
    for (int j = i + 1; j < qc.p.n_blocks; ++j) {
      const float* bi = tab + kQHead + i * kQBlock;
      const float* bj = tab + kQHead + j * kQBlock;
      float ci[2], cj[2], pen[2];
      for (int a = 0; a < 2; ++a) {
        ci[a] = bi[a] + world_at(wq, (int)bi[11 + a]);
        cj[a] = bj[a] + world_at(wq, (int)bj[11 + a]);
        pen[a] = (bi[3 + a] + bj[3 + a]) - fabsf(ci[a] - cj[a]);
      }
      const bool overlapping = pen[0] > 0.f && pen[1] > 0.f;
      const bool use_x = pen[0] <= pen[1];
      for (int a = 0; a < 2; ++a) {
        const bool sel = overlapping && (a == 0 ? use_x : !use_x);
        const float d = pen[a] > 0.f ? pen[a] : 0.f;
        float sgn = sign_of(cj[a] - ci[a]);
        sgn = sgn == 0.f ? 1.f : sgn;
        const int adr_i = (int)bi[11 + a], adr_j = (int)bj[11 + a];
        // both slide on this axis: half each; else the one that does
        const float share = (adr_i >= 0 && adr_j >= 0) ? 0.5f : 1.f;
        if (adr_i >= 0) {
          const float move = (sel ? d * share : 0.f) * sgn;
          wq[adr_i - 3] = clampf(ci[a] - move, bi[7 + a], bi[9 + a]) - bi[a];
        }
        if (adr_j >= 0) {
          const float move = (sel ? d * share : 0.f) * sgn;
          wq[adr_j - 3] = clampf(cj[a] + move, bj[7 + a], bj[9 + a]) - bj[a];
        }
      }
    }
  }
  const Tables wt{tab + kQHead + qc.p.n_blocks * kQBlock +
                      qc.p.n_balls * kQBall,
                  qc.p.n_walls, nullptr, 0};
  for (int k = 0; k < qc.p.n_balls; ++k) {
    const float* b = tab + kQHead + qc.p.n_blocks * kQBlock + k * kQBall;
    const int xi = (int)b[3] - 3, yi = (int)b[4] - 3;
    float bx = b[0] + wq[xi], by = b[1] + wq[yi];
    float vx = wv[xi], vy = wv[yi];
    const float dx = bx - x, dy = by - y;
    const float dist = sqrtf(dx * dx + dy * dy + 1e-12f);
    const float overlap = b[2] - dist;
    if (overlap > 0.f) {
      vx = vx + dx / dist * overlap * tab[kQKick];
      vy = vy + dy / dist * overlap * tab[kQKick];
    }
    const float ox = bx, oy = by;
    bx = bx + vx * p.dt;
    by = by + vy * p.dt;
    vx = vx * tab[kQKeep];
    vy = vy * tab[kQKeep];
    // the ball's manual wall resolution (segments.resolve)
    float px, py, rx, ry, qx, qy, sx, sy;
    float resx = bx, resy = by;
    const bool hit1 = detect(wt, ox, oy, bx, by, &px, &py, &rx, &ry);
    const float b2x = px + p.restitution * (rx - px);
    const float b2y = py + p.restitution * (ry - py);
    const bool hit2 = detect(wt, ox, oy, b2x, b2y, &qx, &qy, &sx, &sy);
    if (hit1) {
      resx = hit2 ? ox : b2x;
      resy = hit2 ? oy : b2y;
    }
    const bool bounced = fabsf(resx - bx) > 1e-7f || fabsf(resy - by) > 1e-7f;
    const float mx = resx - ox, my = resy - oy;
    const float mnorm = sqrtf(mx * mx + my * my + 1e-12f);
    const float speed = sqrtf(vx * vx + vy * vy);
    if (bounced && mnorm > 1e-6f) {
      vx = mx / mnorm * speed * p.restitution;
      vy = my / mnorm * speed * p.restitution;
    }
    wq[xi] = resx - b[0];
    wq[yi] = resy - b[1];
    wv[xi] = vx;
    wv[yi] = vy;
  }
}

constexpr int kPlainMode = 0, kObjMode = 1, kQuasiMode = 2;

// One Point env step (envs/env.py _step_manual, float32 branch, plus the
// task heads): kinematics and wrap; [the objects' RK4 step;] COM residual;
// wall ejection; two arrow-tip contacts; wall-crossing resolution with
// restitution and give-up; t + 1.  No reset.  oq, ov: the object dofs in
// the solve's order (kObjMode), or the world dofs by qpos address - 3
// (kQuasiMode, whose quasi-static rows run after the residual).
template <int kMode>
__device__ void point_step(const PointParams& p, const Tables& tb, float* q,
                           float* v, int* t, float ax, float ar,
                           float* reward, bool* term, const ObjCtx* oc,
                           float* oq, float* ov, const QuasiCtx* qc) {
  const float ox = q[0], oy = q[1];
  // kinematics (point.py:44-57): single-branch wrap, full qvel clip
  float ori = q[2] + ar;
  if (ori < -kPi) ori = ori + kTwoPi;
  if (ori > kPi) ori = ori - kTwoPi;
  float x = q[0] + cosf(ori) * ax;
  float y = q[1] + sinf(ori) * ax;
  float vx = fminf(fmaxf(v[0], -p.vel_limit), p.vel_limit);
  float vy = fminf(fmaxf(v[1], -p.vel_limit), p.vel_limit);
  float vr = fminf(fmaxf(v[2], -p.vel_limit), p.vel_limit);
  if constexpr (kMode == kQuasiMode) {
    for (int k = 0; k < qc->p.n_world; ++k)
      ov[k] = fminf(fmaxf(ov[k], -p.vel_limit), p.vel_limit);
  }
  if constexpr (kMode == kObjMode) {
    // the objects' RK4 step from the post-teleport, pre-residual robot
    // pose with the clipped velocities; the robot's dofs do not feel it
#pragma unroll
    for (int i = 0; i < mmt_obj::kDofs; ++i)
      ov[i] = fminf(fmaxf(ov[i], -p.vel_limit), p.vel_limit);
    mmt_obj::object_step(oc->p, oc->tab, oc->g, oc->trace, x, y, ori, vx,
                         vy, vr, oq, ov);
  }

  // closed-form mj_step residual (models/point.py residual_step)
  const float r = p.com_offset, dt = p.dt;
  const float th1 = ori + vr * dt;
  const float s0 = sinf(ori), c0 = cosf(ori);
  const float s1 = sinf(th1), c1 = cosf(th1);
  const float dvx = vr * r * (s1 - s0);
  const float dvy = -vr * r * (c1 - c0);
  const float ddx = r * (c0 - c1) - vr * r * s0 * dt;
  const float ddy = r * (s0 - s1) + vr * r * c0 * dt;
  x = x + vx * dt + ddx;
  y = y + vy * dt + ddy;
  vx = vx + dvx;
  vy = vy + dvy;
  ori = th1;
  if constexpr (kMode == kQuasiMode) quasi_rows(*qc, p, x, y, oq, ov);

  // wall-contact ejection (segments.impedance_eject, oriented by old)
  {
    float accx = 0.f, accy = 0.f;
    for (int w = 0; w < tb.n_walls; ++w) {
      const float* s = tb.walls + w * kWallCols;
      const float p1x = s[0], p1y = s[1];
      const float v1x = s[2] - p1x, v1y = s[3] - p1y;
      const float nrm2 = v1x * v1x + v1y * v1y;
      const float safe_n = nrm2 == 0.f ? 1.f : nrm2;
      const float tt = clamp01(((x - p1x) * v1x + (y - p1y) * v1y) / safe_n);
      const float cx = p1x + tt * v1x, cy = p1y + tt * v1y;
      const float dx = x - cx, dy = y - cy;
      float dist = sqrtf(dx * dx + dy * dy + 1e-12f);
      float side = sign_of((ox - cx) * dx + (oy - cy) * dy);
      side = side == 0.f ? 1.f : side;
      dist = dist * side;
      const float pen = fmaxf(p.margin - dist, 0.f);
      const bool active = pen > 0.f;
      const float adist = fabsf(dist);
      const float nx = dx / adist * side, ny = dy / adist * side;
      const float vn = vx * nx + vy * ny;
      const float vn2 = p.edecay * (vn - p.lam * (vn - p.lam * pen) * dt);
      const float dvn = active ? fmaxf(vn2 - vn, 0.f) : 0.f;
      const float tx = -ny, ty = nx;
      const float vt = vx * tx + vy * ty;
      float dvt = -sign_of(vt) * fminf(fabsf(vt), p.mu * dvn);
      dvt = active ? dvt : 0.f;
      accx = accx + (dvn * nx + dvt * tx);
      accy = accy + (dvn * ny + dvt * ty);
    }
    vx = vx + accx;
    vy = vy + accy;
  }

  // arrow-box tip contacts (segments.tip_impedance_eject), one tip after
  // the other: each tip sees the previous tip's qvel update
  {
    const float ct = cosf(ori), st = sinf(ori);
    const float ux = -st, uy = ct;
    const float tips[2][2] = {{p.tip0x, p.tip0y}, {p.tip1x, p.tip1y}};
    for (int k = 0; k < 2; ++k) {
      const float tbx = tips[k][0], tby = tips[k][1];
      const float tipx = x + (tbx * ct - tby * st);
      const float tipy = y + (tbx * st + tby * ct);
      const float rrx = tipx - x, rry = tipy - y;
      float accx = 0.f, accy = 0.f, accr = 0.f;
      for (int w = 0; w < tb.n_walls; ++w) {
        const float* s = tb.walls + w * kWallCols;
        const float p1x = s[0], p1y = s[1];
        const float v1x = s[2] - p1x, v1y = s[3] - p1y;
        const float nrm2 = v1x * v1x + v1y * v1y;
        const float safe_n = nrm2 == 0.f ? 1.f : nrm2;
        const float tt =
            clamp01(((tipx - p1x) * v1x + (tipy - p1y) * v1y) / safe_n);
        const float cx = p1x + tt * v1x, cy = p1y + tt * v1y;
        const float dcx = ox - cx, dcy = oy - cy;
        const float dcn = sqrtf(dcx * dcx + dcy * dcy + 1e-12f);
        const float nx = dcx / dcn, ny = dcy / dcn;
        const float s_d = (tipx - cx) * nx + (tipy - cy) * ny;
        const float pen = fmaxf(-(s_d + p.radius), 0.f);
        const bool active = pen > 0.f;
        const float rxn = rrx * ny - rry * nx;
        const float un = nx * ux + ny * uy;
        const float g = rxn - p.arm_over_m * un;
        const float A = p.inv_m + (g * g) * p.inv_ip;
        const float vn = nx * vx + ny * vy + rxn * vr;
        const float vn2 = p.edecay * (vn - p.lam * (vn - p.lam * pen) * dt);
        const float dvn = active ? fmaxf(vn2 - vn, 0.f) : 0.f;
        const float f = dvn / A;
        accx = accx + f * (nx * p.inv_m - ux * p.coef * g);
        accy = accy + f * (ny * p.inv_m - uy * p.coef * g);
        accr = accr + f * g * p.inv_ip;
      }
      vx = vx + accx;
      vy = vy + accy;
      vr = vr + accr;
    }
  }

  // manual wall resolution (segments.resolve): restitution + give-up
  {
    float px, py, rx, ry, qx, qy, sx, sy;
    const bool hit1 = detect(tb, ox, oy, x, y, &px, &py, &rx, &ry);
    const float bx = px + p.restitution * (rx - px);
    const float by = py + p.restitution * (ry - py);
    const bool hit2 = detect(tb, ox, oy, bx, by, &qx, &qy, &sx, &sy);
    if (hit1) {
      x = hit2 ? ox : bx;
      y = hit2 ? oy : by;
    }
  }

  // task heads on obs[:3] = (x, y, ori), or on the first object's center
  // where the task observes it there: lane_env.goal_heads, with the
  // first-hit-wins order of the goals and their dim masks
  float hx = x, hy = y, hz = ori;
  if constexpr (kMode == kQuasiMode) {
    if (qc->p.head_obj) {
      const float* h = qc->tab;
      hx = h[0] + world_at(oq, (int)h[3]);
      hy = h[1] + world_at(oq, (int)h[4]);
      hz = h[2] + world_at(oq, (int)h[5]);
    }
  }
  if constexpr (kMode == kObjMode) {
    if (oc->p.head_obj) {
      const float* base = oc->tab + mmt_obj::kHeadBase;
      const float* hd = oc->tab + mmt_obj::kHeadDof;
      hx = base[0] + (hd[0] >= 0.f ? mmt_obj::pick(oq, (int)hd[0]) : 0.f);
      hy = base[1] + (hd[1] >= 0.f ? mmt_obj::pick(oq, (int)hd[1]) : 0.f);
      hz = base[2] + (hd[2] >= 0.f ? mmt_obj::pick(oq, (int)hd[2]) : 0.f);
    }
  }
  float rew = p.reward_type == 2 ? p.penalty : 0.f;
  bool hit_any = false;
  for (int gi = tb.n_goals - 1; gi >= 0; --gi) {
    const float* gr = tb.goals + gi * kGoalCols;
    const float ddx = (hx - gr[0]) * gr[3];
    const float ddy = (hy - gr[1]) * gr[4];
    const float ddz = (hz - gr[2]) * gr[5];
    const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
    if (gi == 0 && p.reward_type == 1) rew = -(sqrtf(d2) * p.inv_scale);
    const bool near = gr[8] != 0.f && d2 <= gr[6];
    hit_any = hit_any || near;
    if (near && p.reward_type == 2) rew = gr[7];
  }

  q[0] = x; q[1] = y; q[2] = ori;
  v[0] = vx; v[1] = vy; v[2] = vr;
  *t = *t + 1;
  *reward = rew;
  *term = hit_any;
}

// Stage the wall and goal tables into shared memory.
__device__ Tables stage_tables(float* smem, const float* walls, int n_walls,
                               const float* goals, int n_goals) {
  const int nw = n_walls * kWallCols, ng = n_goals * kGoalCols;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) smem[i] = walls[i];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) smem[nw + i] = goals[i];
  __syncthreads();
  return Tables{smem, n_walls, smem + nw, n_goals};
}

__global__ void point_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    const float* __restrict__ walls, int n_walls,
    const float* __restrict__ goals, int n_goals, PointParams p, int n) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, walls, n_walls, goals, n_goals);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float q[3] = {qpos[i * q_stride], qpos[i * q_stride + 1],
                qpos[i * q_stride + 2]};
  float v[3] = {qvel[i * v_stride], qvel[i * v_stride + 1],
                qvel[i * v_stride + 2]};
  int t = t_in[i];
  float rew;
  bool done;
  point_step<kPlainMode>(p, tb, q, v, &t, act[i * a_stride],
                         act[i * a_stride + 1], &rew, &done, nullptr, nullptr,
                         nullptr, nullptr);
  for (int k = 0; k < 3; ++k) {
    qpos_out[i * 3 + k] = q[k];
    qvel_out[i * 3 + k] = v[k];
  }
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
}

__global__ void point_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, const float* __restrict__ walls, int n_walls,
    const float* __restrict__ goals, int n_goals, PointParams p, int n,
    int num_steps, uint32_t seed) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, walls, n_walls, goals, n_goals);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float q[3] = {qpos[i * q_stride], qpos[i * q_stride + 1],
                qpos[i * q_stride + 2]};
  float v[3] = {qvel[i * v_stride], qvel[i * v_stride + 1],
                qvel[i * v_stride + 2]};
  int t = t_in[i];
  float rew_sum = 0.f;
  int eps = 0;
  for (int s = 0; s < num_steps; ++s) {
    // counter (env, step, block, 0): actions, then the reset draws
    const uint4 b0 = mmt::philox_block((uint32_t)i, (uint32_t)s, 0u, seed);
    const uint4 b1 = mmt::philox_block((uint32_t)i, (uint32_t)s, 1u, seed);
    float rew;
    bool term;
    point_step<kPlainMode>(p, tb, q, v, &t, mmt::uniform24(b0.x, -1.f, 1.f),
                           mmt::uniform24(b0.y, -0.25f, 0.25f), &rew, &term,
                           nullptr, nullptr, nullptr, nullptr);
    // branch-free auto-reset (point_pallas.py sample_reset): q ~ U(+-0.1),
    // v ~ U(0, 0.1), t = 0
    const bool done = term || t >= p.episode_limit;
    const float qr[3] = {mmt::uniform24(b0.z, -0.1f, 0.1f),
                         mmt::uniform24(b0.w, -0.1f, 0.1f),
                         mmt::uniform24(b1.x, -0.1f, 0.1f)};
    const float vr[3] = {mmt::uniform24(b1.y, 0.f, 0.1f),
                         mmt::uniform24(b1.z, 0.f, 0.1f),
                         mmt::uniform24(b1.w, 0.f, 0.1f)};
    for (int k = 0; k < 3; ++k) {
      q[k] = done ? qr[k] : q[k];
      v[k] = done ? vr[k] : v[k];
    }
    t = done ? 0 : t;
    rew_sum = rew_sum + rew;
    eps = eps + (done ? 1 : 0);
  }
  for (int k = 0; k < 3; ++k) {
    qpos_out[i * 3 + k] = q[k];
    qvel_out[i * 3 + k] = v[k];
  }
  t_out[i] = t;
  reward_sum[i] = rew_sum;
  episodes[i] = eps;
}

size_t table_bytes(int n_walls, int n_goals) {
  return sizeof(float) * (size_t)(n_walls * kWallCols + n_goals * kGoalCols);
}

// Stage the object table after the wall and goal tables.
__device__ const float* stage_objects(float* smem, const float* table,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = table[i];
  __syncthreads();
  return smem;
}

// Load an env's object dofs (solve order) from its qpos / qvel rows.
__device__ void load_objects(const float* tab, int nd, const float* qrow,
                             const float* vrow, float* oq, float* ov) {
#pragma unroll
  for (int s = 0; s < mmt_obj::kDofs; ++s) {
    const int a = (int)tab[mmt_obj::kHeadIdx + s];
    oq[s] = s < nd ? qrow[a] : 0.f;
    ov[s] = s < nd ? vrow[a] : 0.f;
  }
}

__device__ void store_objects(const float* tab, int nd, const float* oq,
                              const float* ov, float* qrow, float* vrow) {
#pragma unroll
  for (int s = 0; s < mmt_obj::kDofs; ++s) {
    if (s < nd) {
      const int a = (int)tab[mmt_obj::kHeadIdx + s];
      qrow[a] = oq[s];
      vrow[a] = ov[s];
    }
  }
}

// The object kernels' block: the tables, the object table and the item
// list in shared memory (mmt_obj::build_items, by the first warp), then
// one group of mmt_obj::kLanes lanes per env, op.groups envs (whole
// warps).  Returns the env of this thread's group (past the batch for a
// spare group, which steps a copy of the last env and writes nothing), or
// -1 where the whole warp is past the batch.
__device__ int stage_obj_block(float* smem, const float* walls, int n_walls,
                               const float* goals, int n_goals,
                               const float* obj_table, const ObjParams& op,
                               int n, Tables* tb, const float** tab) {
  *tb = stage_tables(smem, walls, n_walls, goals, n_goals);
  *tab = stage_objects(smem + n_walls * kWallCols + n_goals * kGoalCols,
                       obj_table, op.n_table);
  if (threadIdx.x < 32)
    mmt_obj::build_items(op, *tab, reinterpret_cast<int*>(smem + op.off_items));
  __syncthreads();
  const int first = blockIdx.x * op.groups;
  const int warp_env = first + (threadIdx.x & ~31) / mmt_obj::kLanes;
  return warp_env < n ? first + (int)threadIdx.x / mmt_obj::kLanes : -1;
}

template <bool kSharedRows>
__global__ void point_obj_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    const float* __restrict__ walls, int n_walls,
    const float* __restrict__ goals, int n_goals, PointParams p,
    const float* __restrict__ obj_table, ObjParams op, float* rows,
    uint32_t* trace, int n) {
  extern __shared__ float smem[];
  Tables tb;
  const float* tab;
  const int e = stage_obj_block(smem, walls, n_walls, goals, n_goals,
                                obj_table, op, n, &tb, &tab);
  if (e < 0) return;
  const bool live = e < n;
  const int i = live ? e : n - 1;
  const int nq = 3 + op.nd;
  const float* qrow = qpos + (size_t)i * q_stride;
  const float* vrow = qvel + (size_t)i * v_stride;
  float q[3] = {qrow[0], qrow[1], qrow[2]};
  float v[3] = {vrow[0], vrow[1], vrow[2]};
  float oq[mmt_obj::kDofs], ov[mmt_obj::kDofs];
  load_objects(tab, op.nd, qrow, vrow, oq, ov);
  int t = t_in[i];
  const ObjCtx oc{op, tab,
                  mmt_obj::make_group<kSharedRows>(
                      op, smem, rows, threadIdx.x / mmt_obj::kLanes),
                  trace && live ? trace + (size_t)i * 4 * op.trace_words
                                : nullptr};
  float rew;
  bool done;
  point_step<kObjMode>(p, tb, q, v, &t, act[(size_t)i * a_stride],
                       act[(size_t)i * a_stride + 1], &rew, &done, &oc, oq, ov,
                       nullptr);
  if (!live || oc.g.lane != 0) return;
  float* qo = qpos_out + (size_t)i * nq;
  float* vo = qvel_out + (size_t)i * nq;
  for (int k = 0; k < 3; ++k) {
    qo[k] = q[k];
    vo[k] = v[k];
  }
  store_objects(tab, op.nd, oq, ov, qo, vo);
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
}

template <bool kSharedRows>
__global__ void point_obj_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, const float* __restrict__ walls, int n_walls,
    const float* __restrict__ goals, int n_goals, PointParams p,
    const float* __restrict__ obj_table, ObjParams op, float* rows, int n,
    int num_steps, uint32_t seed) {
  extern __shared__ float smem[];
  Tables tb;
  const float* tab;
  const int e = stage_obj_block(smem, walls, n_walls, goals, n_goals,
                                obj_table, op, n, &tb, &tab);
  if (e < 0) return;
  const bool live = e < n;
  const int i = live ? e : n - 1;
  const int nq = 3 + op.nd;
  const float* qrow = qpos + (size_t)i * q_stride;
  const float* vrow = qvel + (size_t)i * v_stride;
  float q[3] = {qrow[0], qrow[1], qrow[2]};
  float v[3] = {vrow[0], vrow[1], vrow[2]};
  float oq[mmt_obj::kDofs], ov[mmt_obj::kDofs];
  load_objects(tab, op.nd, qrow, vrow, oq, ov);
  int t = t_in[i];
  const ObjCtx oc{op, tab,
                  mmt_obj::make_group<kSharedRows>(
                      op, smem, rows, threadIdx.x / mmt_obj::kLanes),
                  nullptr};
  float rew_sum = 0.f;
  int eps = 0;
  for (int s = 0; s < num_steps; ++s) {
    // counter (env, step, block, 0): actions, then the reset draws; the
    // world dofs draw nothing.  Every lane of the group draws the same.
    const uint4 b0 = mmt::philox_block((uint32_t)i, (uint32_t)s, 0u, seed);
    const uint4 b1 = mmt::philox_block((uint32_t)i, (uint32_t)s, 1u, seed);
    float rew;
    bool term;
    point_step<kObjMode>(p, tb, q, v, &t, mmt::uniform24(b0.x, -1.f, 1.f),
                         mmt::uniform24(b0.y, -0.25f, 0.25f), &rew, &term,
                         &oc, oq, ov, nullptr);
    const bool done = term || t >= p.episode_limit;
    const float qr[3] = {mmt::uniform24(b0.z, -0.1f, 0.1f),
                         mmt::uniform24(b0.w, -0.1f, 0.1f),
                         mmt::uniform24(b1.x, -0.1f, 0.1f)};
    const float vr[3] = {mmt::uniform24(b1.y, 0.f, 0.1f),
                         mmt::uniform24(b1.z, 0.f, 0.1f),
                         mmt::uniform24(b1.w, 0.f, 0.1f)};
    for (int k = 0; k < 3; ++k) {
      q[k] = done ? qr[k] : q[k];
      v[k] = done ? vr[k] : v[k];
    }
#pragma unroll
    for (int k = 0; k < mmt_obj::kDofs; ++k) {
      oq[k] = done ? 0.f : oq[k];
      ov[k] = done ? 0.f : ov[k];
    }
    t = done ? 0 : t;
    rew_sum = rew_sum + rew;
    eps = eps + (done ? 1 : 0);
  }
  if (!live || oc.g.lane != 0) return;
  float* qo = qpos_out + (size_t)i * nq;
  float* vo = qvel_out + (size_t)i * nq;
  for (int k = 0; k < 3; ++k) {
    qo[k] = q[k];
    vo[k] = v[k];
  }
  store_objects(tab, op.nd, oq, ov, qo, vo);
  t_out[i] = t;
  reward_sum[i] = rew_sum;
  episodes[i] = eps;
}

// Load an env's world dofs (qpos columns 3 .. 3 + n_world).
__device__ void load_world(int n_world, const float* qrow, const float* vrow,
                           float* wq, float* wv) {
  for (int k = 0; k < kQuasiMaxWorld; ++k) {
    wq[k] = k < n_world ? qrow[3 + k] : 0.f;
    wv[k] = k < n_world ? vrow[3 + k] : 0.f;
  }
}

__global__ void point_quasi_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    const float* __restrict__ walls, int n_walls,
    const float* __restrict__ goals, int n_goals, PointParams p,
    const float* __restrict__ quasi_table, QuasiParams qp, int n) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, walls, n_walls, goals, n_goals);
  const float* tab = stage_objects(
      smem + n_walls * kWallCols + n_goals * kGoalCols, quasi_table,
      qp.n_table);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nq = 3 + qp.n_world;
  const float* qrow = qpos + (size_t)i * q_stride;
  const float* vrow = qvel + (size_t)i * v_stride;
  float q[3] = {qrow[0], qrow[1], qrow[2]};
  float v[3] = {vrow[0], vrow[1], vrow[2]};
  float wq[kQuasiMaxWorld], wv[kQuasiMaxWorld];
  load_world(qp.n_world, qrow, vrow, wq, wv);
  int t = t_in[i];
  const QuasiCtx qc{qp, tab};
  float rew;
  bool done;
  point_step<kQuasiMode>(p, tb, q, v, &t, act[(size_t)i * a_stride],
                         act[(size_t)i * a_stride + 1], &rew, &done, nullptr,
                         wq, wv, &qc);
  float* qo = qpos_out + (size_t)i * nq;
  float* vo = qvel_out + (size_t)i * nq;
  for (int k = 0; k < 3; ++k) {
    qo[k] = q[k];
    vo[k] = v[k];
  }
  for (int k = 0; k < qp.n_world; ++k) {
    qo[3 + k] = wq[k];
    vo[3 + k] = wv[k];
  }
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
}

__global__ void point_quasi_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, const float* __restrict__ walls, int n_walls,
    const float* __restrict__ goals, int n_goals, PointParams p,
    const float* __restrict__ quasi_table, QuasiParams qp, int n,
    int num_steps, uint32_t seed) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, walls, n_walls, goals, n_goals);
  const float* tab = stage_objects(
      smem + n_walls * kWallCols + n_goals * kGoalCols, quasi_table,
      qp.n_table);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nq = 3 + qp.n_world;
  const float* qrow = qpos + (size_t)i * q_stride;
  const float* vrow = qvel + (size_t)i * v_stride;
  float q[3] = {qrow[0], qrow[1], qrow[2]};
  float v[3] = {vrow[0], vrow[1], vrow[2]};
  float wq[kQuasiMaxWorld], wv[kQuasiMaxWorld];
  load_world(qp.n_world, qrow, vrow, wq, wv);
  int t = t_in[i];
  const QuasiCtx qc{qp, tab};
  float rew_sum = 0.f;
  int eps = 0;
  for (int s = 0; s < num_steps; ++s) {
    // counter (env, step, block, 0): actions, then the reset draws; the
    // world dofs draw nothing and reset to qpos0 (0), at rest
    const uint4 b0 = mmt::philox_block((uint32_t)i, (uint32_t)s, 0u, seed);
    const uint4 b1 = mmt::philox_block((uint32_t)i, (uint32_t)s, 1u, seed);
    float rew;
    bool term;
    point_step<kQuasiMode>(p, tb, q, v, &t, mmt::uniform24(b0.x, -1.f, 1.f),
                           mmt::uniform24(b0.y, -0.25f, 0.25f), &rew, &term,
                           nullptr, wq, wv, &qc);
    const bool done = term || t >= p.episode_limit;
    const float qr[3] = {mmt::uniform24(b0.z, -0.1f, 0.1f),
                         mmt::uniform24(b0.w, -0.1f, 0.1f),
                         mmt::uniform24(b1.x, -0.1f, 0.1f)};
    const float vr[3] = {mmt::uniform24(b1.y, 0.f, 0.1f),
                         mmt::uniform24(b1.z, 0.f, 0.1f),
                         mmt::uniform24(b1.w, 0.f, 0.1f)};
    for (int k = 0; k < 3; ++k) {
      q[k] = done ? qr[k] : q[k];
      v[k] = done ? vr[k] : v[k];
    }
    for (int k = 0; k < kQuasiMaxWorld; ++k) {
      wq[k] = done ? 0.f : wq[k];
      wv[k] = done ? 0.f : wv[k];
    }
    t = done ? 0 : t;
    rew_sum = rew_sum + rew;
    eps = eps + (done ? 1 : 0);
  }
  float* qo = qpos_out + (size_t)i * nq;
  float* vo = qvel_out + (size_t)i * nq;
  for (int k = 0; k < 3; ++k) {
    qo[k] = q[k];
    vo[k] = v[k];
  }
  for (int k = 0; k < qp.n_world; ++k) {
    qo[3 + k] = wq[k];
    vo[3 + k] = wv[k];
  }
  t_out[i] = t;
  reward_sum[i] = rew_sum;
  episodes[i] = eps;
}

}  // namespace

// C entry points: each launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.
extern "C" int mmt_point_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term,
    const float* walls, int n_walls, const float* goals, int n_goals,
    PointParams p, int n, void* stream) {
  if (n > 0) {
    point_step_kernel<<<(n + kBlock - 1) / kBlock, kBlock,
                        table_bytes(n_walls, n_goals),
                        (cudaStream_t)stream>>>(
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
        t_out, reward, term, walls, n_walls, goals, n_goals, p, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int mmt_point_rollout(
    const float* qpos, const float* qvel, const int* t, int q_stride,
    int v_stride, float* qpos_out, float* qvel_out, int* t_out,
    float* reward_sum, int* episodes, const float* walls, int n_walls,
    const float* goals, int n_goals, PointParams p, int n, int num_steps,
    unsigned int seed, void* stream) {
  if (n > 0) {
    point_rollout_kernel<<<(n + kBlock - 1) / kBlock, kBlock,
                           table_bytes(n_walls, n_goals),
                           (cudaStream_t)stream>>>(
        qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
        reward_sum, episodes, walls, n_walls, goals, n_goals, p, n, num_steps,
        seed);
  }
  return (int)cudaGetLastError();
}

// The object kernels' launch: op's layout (lane_env.obj_geometry) checked
// against the tables, the row buffer and the card, and the dynamic shared
// memory above 48 KB allowed; the shared bytes, or 0 with *rc the error.
// rows: the envs' row stores where !op.shared_rows, one for each group of
// each of the launch's blocks.
template <typename K>
size_t obj_launch_bytes(K kernel, const ObjParams& op, const float* rows,
                        int n_walls, int n_goals, int* rc) {
  const size_t bytes =
      sizeof(float) *
      ((size_t)op.off_groups +
       (op.shared_rows ? (size_t)op.groups * (size_t)op.group_floats : 0));
  *rc = (int)cudaSuccess;
  if (op.groups < 1 || op.groups * mmt_obj::kLanes > mmt_obj::kMaxThreads ||
      op.groups * mmt_obj::kLanes % 32 != 0 ||
      op.off_items < n_walls * kWallCols + n_goals * kGoalCols + op.n_table ||
      op.off_groups < op.off_items + 1 +
                          2 * ((op.n_balls > 0 ? op.n_walls + 3 : 0) +
                               op.n_blocks * (op.n_walls + 10)) ||
      op.row_stride < op.max_rows ||
      op.group_floats <
          (op.nd + mmt_obj::kRowFixed) * op.row_stride + op.trace_words ||
      (!op.shared_rows && rows == nullptr)) {
    *rc = (int)cudaErrorInvalidValue;
    return 0;
  }
  if (bytes > 48 * 1024)
    *rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return bytes;
}

extern "C" int mmt_point_obj_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term,
    const float* walls, int n_walls, const float* goals, int n_goals,
    PointParams p, const float* obj_table, ObjParams op, float* rows,
    unsigned int* trace, int n, void* stream) {
  auto* kernel = op.shared_rows ? point_obj_step_kernel<true>
                                 : point_obj_step_kernel<false>;
  int rc;
  const size_t bytes =
      obj_launch_bytes(kernel, op, rows, n_walls, n_goals, &rc);
  if (rc != (int)cudaSuccess) return rc;
  if (n > 0) {
    kernel<<<(n + op.groups - 1) / op.groups, op.groups * mmt_obj::kLanes,
             bytes, (cudaStream_t)stream>>>(
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
        t_out, reward, term, walls, n_walls, goals, n_goals, p, obj_table, op,
        rows, trace, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int mmt_point_obj_rollout(
    const float* qpos, const float* qvel, const int* t, int q_stride,
    int v_stride, float* qpos_out, float* qvel_out, int* t_out,
    float* reward_sum, int* episodes, const float* walls, int n_walls,
    const float* goals, int n_goals, PointParams p, const float* obj_table,
    ObjParams op, float* rows, int n, int num_steps, unsigned int seed,
    void* stream) {
  auto* kernel = op.shared_rows ? point_obj_rollout_kernel<true>
                                 : point_obj_rollout_kernel<false>;
  int rc;
  const size_t bytes =
      obj_launch_bytes(kernel, op, rows, n_walls, n_goals, &rc);
  if (rc != (int)cudaSuccess) return rc;
  if (n > 0) {
    kernel<<<(n + op.groups - 1) / op.groups, op.groups * mmt_obj::kLanes,
             bytes, (cudaStream_t)stream>>>(
        qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
        reward_sum, episodes, walls, n_walls, goals, n_goals, p, obj_table,
        op, rows, n, num_steps, seed);
  }
  return (int)cudaGetLastError();
}

// Warps an SM holds at once of the object step (rollout = 0) or rollout
// kernel at op's launch, registers and shared memory counted (CUDA's
// occupancy calculator); -1 on an error.
extern "C" int mmt_point_obj_warps_per_sm(ObjParams op, int n_walls,
                                          int n_goals, int rollout) {
  int rc, blocks = -1;
  const float* rows = reinterpret_cast<const float*>(&op);  // not read
  if (rollout) {
    auto* kernel = op.shared_rows ? point_obj_rollout_kernel<true>
                                   : point_obj_rollout_kernel<false>;
    const size_t bytes =
        obj_launch_bytes(kernel, op, rows, n_walls, n_goals, &rc);
    if (rc == (int)cudaSuccess)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, op.groups * mmt_obj::kLanes, bytes);
  } else {
    auto* kernel = op.shared_rows ? point_obj_step_kernel<true>
                                   : point_obj_step_kernel<false>;
    const size_t bytes =
        obj_launch_bytes(kernel, op, rows, n_walls, n_goals, &rc);
    if (rc == (int)cudaSuccess)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, op.groups * mmt_obj::kLanes, bytes);
  }
  return rc == (int)cudaSuccess ? blocks * op.groups * mmt_obj::kLanes / 32
                                : -1;
}

extern "C" int mmt_point_quasi_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term,
    const float* walls, int n_walls, const float* goals, int n_goals,
    PointParams p, const float* quasi_table, QuasiParams qp, int n,
    void* stream) {
  if (qp.n_world > kQuasiMaxWorld) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    point_quasi_step_kernel<<<(n + kBlock - 1) / kBlock, kBlock,
                              table_bytes(n_walls, n_goals) +
                                  sizeof(float) * (size_t)qp.n_table,
                              (cudaStream_t)stream>>>(
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
        t_out, reward, term, walls, n_walls, goals, n_goals, p, quasi_table,
        qp, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int mmt_point_quasi_rollout(
    const float* qpos, const float* qvel, const int* t, int q_stride,
    int v_stride, float* qpos_out, float* qvel_out, int* t_out,
    float* reward_sum, int* episodes, const float* walls, int n_walls,
    const float* goals, int n_goals, PointParams p, const float* quasi_table,
    QuasiParams qp, int n, int num_steps, unsigned int seed, void* stream) {
  if (qp.n_world > kQuasiMaxWorld) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    point_quasi_rollout_kernel<<<(n + kBlock - 1) / kBlock, kBlock,
                                 table_bytes(n_walls, n_goals) +
                                     sizeof(float) * (size_t)qp.n_table,
                                 (cudaStream_t)stream>>>(
        qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
        reward_sum, episodes, walls, n_walls, goals, n_goals, p, quasi_table,
        qp, n, num_steps, seed);
  }
  return (int)cudaGetLastError();
}
