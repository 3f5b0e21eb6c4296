// Point object worlds: the reduced object solve inside the Point step and
// rollout kernels (csrc/point_lane.cu, point_obj_step_kernel and
// point_obj_rollout_kernel).
//
// Replaces the object part of the TPU Point kernels:
//   object_step         <- mujoco_maze_tpu/ops/object_lanes.py
//                          object_step_lanes :1009 (RK4, robot kinematic)
//   forward             <- object_forward_lanes :983 and the row builders
//                          _imp ... _arrow_block_rows :194-880
//   solve               <- _solve_newton_lanes :913, _chol_solve :882
//   (the heads' anchor)  <- point_pallas.py _first_object_pos :370
// as ops/point_pallas.py _step_math :419-430 runs them, between the
// kinematics and the residual.  The plain version is
// mujoco_maze_tpu_torch/ops/object_lanes.py, row for row.
//
// Design.  A group of kLanes = 8 lanes steps one env, four envs a warp;
// a block holds ObjParams::groups envs in whole warps, a full block of
// kMaxThreads threads (ops/lane_env.py obj_geometry).  The warp's four
// groups run in lockstep: every loop that holds a warp operation takes
// the same trips in all of them (the line search's passes, the
// compaction's chunks), and every sync, shuffle and ballot takes the whole
// warp.  The robot's part of the step runs on every lane of the group,
// each lane the same operations on the same values, so no broadcast is
// needed.
//   A forward evaluation walks the world's candidate contacts: the
//   items of a list the block builds once from the world table
//   (build_items; the ball's: each wall, floor, robot, arrow; each
//   block's: robot sphere, arrow (its two SAT points and four z-winner
//   corners), each reachable wall ([its z row,] the two face points),
//   each earlier block, the ball, floor, slide limits), each with its
//   first candidate row.  Lane k takes items k, k + kLanes, ...; an
//   item writes its ACTIVE rows (rinv > 0) into the env's row store at
//   their candidate row and sets their bits in the env's active mask.
//   An inactive row adds exactly 0 to the gradient, to H and to the line
//   search's derivative, so the store is then compacted in candidate
//   order (the mask's bits, a prefix count per chunk of kLanes rows) and
//   the Newton solve runs over the active rows alone, in row order.
//   The row store (nd + kRowFixed fields of row_stride floats: J's nd
//   columns, aref, rinv, J x - aref, J p; field f of row r at
//   f * row_stride + r, an odd stride so that the lanes reading the
//   fields of one row fall on different banks) and the mask are sized to
//   the world's candidate rows R and object dofs nd (max_rows 76-676:
//   4.4 KB an env on PointPush-v0, 27 KB on PointPushMaze-v0).  They live
//   in dynamic shared memory, beside the staged world table and the item
//   list, where a full block's fit (ObjParams::shared_rows; R <= 180 in
//   the 27 worlds), and else in a global buffer of the same layout, one
//   store for each group of each block (make_group): the solve reads only
//   the active rows, compacted to the front, which stay in L1.  The code
//   is the same either way; only the store's address differs (the kernels
//   are built for each, so that shared addresses stay 32-bit).
//   A Newton step: each lane computes J x - aref of its rows; each of
//   the 27 accumulators (g's 6, H's 21 upper entries) lives on a lane
//   and sums its terms over the active rows in row order; the lanes
//   shuffle them to every lane, which factors H and solves for the step
//   p (6 x 6, the same operations on each lane); each lane computes J p
//   of its rows.  The bisection line search evaluates its derivative at
//   64 values of t at once, eight a lane: the decision tree of the next
//   six bisection steps (the first pass: t = 2, which settles hi, and
//   the next five steps below hi = 2 and below hi = 4), each value summed
//   over the rows in row order; a ballot of the signs then walks the
//   tree.  So ls_iters = 10 takes two passes over the rows, not eleven.
//   A forward evaluation without active rows has a solve that depends on
//   the world alone (the masses, gravity, the iteration counts): the
//   wrapper computes it once with the plain version and passes it as
//   ObjParams::x_free, which a warp whose four groups have no active row
//   takes (forward).
// The bounds of the one build are the maxima of the 27 worlds: 6 object
// dofs, 3 blocks, 1 ball.  The solve is written for 6 dofs: a world with
// fewer pads its dofs with unit mass, no gravity and zero Jacobian
// columns, which leaves the real dofs' results unchanged to the bit (the
// padded Cholesky rows are exact zeros and ones; the store keeps nd
// columns and reads the others as 0).  Runtime dof indices are read and
// written with unrolled selects (pick/put), so the small arrays stay in
// registers.
//
// What bounds it on an H100.  A forward evaluation costs the geometry of
// every candidate contact (~40-250 fp32 operations each) plus, per active
// row, ~60 operations a Newton step and ~4 a line-search step; the data
// moved per env-step is a few hundred bytes.  So it is bound by fp32
// work and, above all, by each env's chain of dependent steps: 4 forward
// evaluations, 6 Newton steps each, each a factor of H (24 IEEE
// divisions and square roots in a row) and its passes over the rows.
// The group cuts the passes over the rows from 13 to 4 a Newton step
// (through shared memory or L1, not L2), and four envs a warp share each
// instruction of the serial part, so that 4096 envs fit one wave at
// 8 warps an SM (the one-thread-per-env version filled 32 of 132 SMs with
// 4 warps each).
//
// Arithmetic.  This file and the plain version do the same float32
// operations in the same order, so on the card they agree to the bit:
// constants are folded in Python double and rounded once (passed in the
// table and in ObjParams); each division by a constant is a product with
// its float32 reciprocal (PyTorch's CUDA division by a Python scalar is
// such a product); the library is built without fast math and with
// -fmad=false; and every sum over rows runs over the active rows in row
// order, here as one lane's chain of adds, there over the rows gathered
// in row order (an inactive row adds exactly 0 there).  No sum is split
// across lanes.  The bisection's points are exact binary fractions, so
// the line search computes them in closed form (node_frac, walk).  Knife
// edges (the jar0 < 0 and jart < 0 switches of the solve, the SAT axis
// pick, the incident-edge clip) then fall the same way in both.

#pragma once

#include <math.h>
#include <stdint.h>

// The scalars of one object world (lane_env.ObjParams, field for field),
// with the launch's shared-memory layout (lane_env.obj_geometry).
struct ObjParams {
  int nd, n_walls, n_balls, n_blocks, newton_iters, ls_iters, max_rows;
  int off_walls, off_ball, off_blocks, block_stride, n_table, trace_words;
  int head_obj;
  int groups;        // envs a block
  int row_stride;    // floats between two fields of the row store
  int group_floats;  // one env's row store and active mask
  int off_items;     // the item list, in floats from the start of smem
  int off_groups;    // the first env's row store where shared_rows, else
                     // the end of the block's shared memory
  int shared_rows;   // 1: the envs' row stores in shared memory; 0: in the
                     // launch's global buffer, env e's at e * group_floats
  float h, ah_half, bw16, bw13;   // RK4: dt, dt / 2, weights
  float mu, sphere_r, sphere_z, arrow_off, hl, hw, hz_arrow, az_c, floor_pen;
  float inv101;                           // float32 1 / 1.01
  float x_free[6];   // the solve without active rows (mmt_obj::kDofs)
};

namespace mmt_obj {

constexpr int kDofs = 6;        // object dofs of the build (padded)
constexpr int kRowFixed = 4;    // a row's floats after its nd J columns:
                                // aref, rinv, J x - aref, J p
constexpr int kLanes = 8;       // lanes that step one env
constexpr int kMaxThreads = 256;                     // threads a block
constexpr uint32_t kWarp = 0xffffffffu;  // the warp's groups in lockstep
constexpr int kAcc = kDofs + kDofs * (kDofs + 1) / 2;  // g and H's upper
constexpr int kAccLane = (kAcc + kLanes - 1) / kLanes;
constexpr int kSlots = 64 / kLanes;  // line-search values of t a lane
static_assert(kLanes == 32 || (kLanes < 32 && 32 % kLanes == 0),
              "a group is a warp or a power-of-two part of one");
// the table's header (point_kernel.object_table)
constexpr int kHeadMass = 0, kHeadA0 = 6, kHeadIdx = 12, kHeadBase = 18,
              kHeadDof = 21;
// a ball's record
constexpr int kBallImpWall = 7, kBallImpFloor = 13, kBallImpRobot = 19;
// a block's record
constexpr int kBlkDof = 6, kBlkOvZ = 9, kBlkImpRobot = 10, kBlkImpWall = 16,
              kBlkImpBall = 22, kBlkImpLim = 28, kBlkImpPair = 34,
              kBlkLo = 52, kBlkHi = 55, kBlkLimited = 58, kBlkWalls = 61;
constexpr int kWallFloats = 6;

// a[d] for a runtime d in [0, kDofs), 0 otherwise, without an indexed
// load (the array stays in registers)
__device__ __forceinline__ float pick(const float a[kDofs], int d) {
  float r = 0.f;
#pragma unroll
  for (int s = 0; s < kDofs; ++s) r = (s == d) ? a[s] : r;
  return r;
}

__device__ __forceinline__ void put(float a[kDofs], int d, float val) {
#pragma unroll
  for (int s = 0; s < kDofs; ++s)
    if (s == d) a[s] = val;
}

__device__ __forceinline__ void zero(float a[kDofs]) {
#pragma unroll
  for (int s = 0; s < kDofs; ++s) a[s] = 0.f;
}

__device__ __forceinline__ float sign1(float x) {  // sign, with 0 -> 1
  return x == 0.f ? 1.f : (x > 0.f ? 1.f : -1.f);
}

// d(pen) of a contact class c = (dmin, dd, 1 / width, 1 / kden, b,
// 1 / rscale) (object_lanes.Imp)
__device__ __forceinline__ float imp_d(float pen, const float* c) {
  const float x = fminf(fmaxf(pen * c[2], 0.f), 1.f);
  const float y = x < 0.5f ? 2.f * x * x : 1.f - 2.f * (1.f - x) * (1.f - x);
  return c[0] + y * c[1];
}

// mju_makeFrame tangents of the normal n
__device__ __forceinline__ void make_frame(float nx, float ny, float nz,
                                           float t1[3], float t2[3]) {
  const bool near_y = fabsf(ny) > 0.99995f;
  const float ax = -nx * ny, ay = 1.f - ny * ny, az = -nz * ny;
  const float nrm = sqrtf(ax * ax + ay * ay + az * az + 1e-30f);
  t1[0] = near_y ? 0.f : ax / nrm;
  t1[1] = near_y ? 0.f : ay / nrm;
  t1[2] = near_y ? 1.f : az / nrm;
  t2[0] = ny * t1[2] - nz * t1[1];
  t2[1] = nz * t1[0] - nx * t1[2];
  t2[2] = nx * t1[1] - ny * t1[0];
}

// Jacobian (x, y, rot) of direction d at (px, py) of a slide-slide-hinge
// body whose hinge passes through (ox, oy)
__device__ __forceinline__ void jac3(const float d[3], float px, float py,
                                     float ox, float oy, float out[3]) {
  const float rx = px - ox, ry = py - oy;
  out[0] = d[0];
  out[1] = d[1];
  out[2] = -ry * d[0] + rx * d[1];
}

// the robot's part of a direction's J v at (px, py): + for rows
// (robot - object), the caller negates for (object - robot)
__device__ __forceinline__ float rob_dot(const float d[3], float px, float py,
                                         float x, float y, float vx, float vy,
                                         float vth) {
  float j[3];
  jac3(d, px, py, x, y, j);
  return j[0] * vx + j[1] * vy + j[2] * vth;
}

struct SphereBox {
  float pen, nx, ny, nz, px, py;
};

// sphere at (cx, cy, cz) vs a box: the shallow closest-point case, else
// the nearest of the six faces
__device__ SphereBox sphere_box(float cx, float cy, float cz, float bx,
                                float by, float bz, float hx, float hy,
                                float hz, float r) {
  const float lox = bx - hx, hix = bx + hx;
  const float loy = by - hy, hiy = by + hy;
  const float loz = bz - hz, hiz = bz + hz;
  const float qx = fminf(fmaxf(cx, lox), hix);
  const float qy = fminf(fmaxf(cy, loy), hiy);
  const float qz = fminf(fmaxf(cz, loz), hiz);
  const float dx = cx - qx, dy = cy - qy, dz = cz - qz;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const bool outside = d2 > 1e-24f;
  const float dist = sqrtf(fmaxf(d2, 1e-24f));
  const float inv = 1.f / dist;
  const float nox = dx * inv, noy = dy * inv, noz = dz * inv;
  const float t_out = r + (dist - r) * 0.5f;
  const float d0 = cx - lox, d1 = hix - cx;
  const float d2y = cy - loy, d3y = hiy - cy;
  const float d4 = cz - loz, d5 = hiz - cz;
  const float fd = fminf(fminf(fminf(d0, d1), fminf(d2y, d3y)), fminf(d4, d5));
  const bool e0 = d0 == fd, e1 = d1 == fd, e2 = d2y == fd, e3 = d3y == fd;
  const float nin_x = e0 ? -1.f : (e1 ? 1.f : 0.f);
  const float nin_y = (e0 || e1) ? 0.f : (e2 ? -1.f : (e3 ? 1.f : 0.f));
  const float nin_z = (e0 || e1 || e2 || e3) ? 0.f : (d4 == fd ? -1.f : 1.f);
  const float pen_in = fd + r;
  const float t_in = r - pen_in * 0.5f;
  SphereBox o;
  o.pen = outside ? r - dist : pen_in;
  o.nx = outside ? nox : nin_x;
  o.ny = outside ? noy : nin_y;
  o.nz = outside ? noz : nin_z;
  o.px = outside ? cx - nox * t_out : cx - nin_x * t_in;
  o.py = outside ? cy - noy * t_out : cy - nin_y * t_in;
  return o;
}

// Where one item writes its rows: the env's row store, its active mask,
// and the item's next candidate row (the row order of the plain version).
struct Sink {
  float* store;     // field f of candidate row c at store[f * stride + c]
  int stride;
  int nd;           // the world's object dofs: J's columns kept
  uint32_t* mask;   // bit c: candidate row c is active
  int cand;
};

__device__ __forceinline__ void push_row(Sink& s, const float J[kDofs],
                                         float aref, float rinv) {
  float* r = s.store + s.cand;
#pragma unroll
  for (int f = 0; f < kDofs; ++f)
    if (f < s.nd) r[f * s.stride] = J[f];   // the padded columns are 0
  r[s.nd * s.stride] = aref;
  r[(s.nd + 1) * s.stride] = rinv;
  atomicOr(&s.mask[s.cand >> 5], 1u << (s.cand & 31));
  ++s.cand;
}

// the 4 pyramid rows of one contact (object_lanes._contact): jn, jt1, jt2
// the object columns of the normal and tangent Jacobians, vb* the robot's
// part of each direction's J v, v the object velocities
__device__ void add_contact(Sink& s, float mu, const float jn[kDofs],
                            const float jt1[kDofs], const float jt2[kDofs],
                            float vbn, float vbt1, float vbt2,
                            const float v[kDofs], float pen, bool active,
                            float zmult, const float* c) {
  if (!active) {
    s.cand += 4;
    return;
  }
  const float d = imp_d(pen, c);
  const float k = d * c[3];
  float vn = vbn, vt1 = vbt1, vt2 = vbt2;
#pragma unroll
  for (int i = 0; i < kDofs; ++i) {
    vn = vn + jn[i] * v[i];
    vt1 = vt1 + jt1[i] * v[i];
    vt2 = vt2 + jt2[i] * v[i];
  }
  const float kp = k * pen;
  const float rinv = (d / (1.f - d)) * c[5] * zmult;
  float J[kDofs];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float sm = ((r & 1) ? 1.f : -1.f) * mu;
    const float* jt = r < 2 ? jt1 : jt2;
    const float vt = r < 2 ? vt1 : vt2;
#pragma unroll
    for (int i = 0; i < kDofs; ++i) J[i] = jn[i] + sm * jt[i];
    push_row(s, J, -c[4] * (vn + sm * vt) + kp, rinv);
  }
}

// one frictionless unilateral row, a slide limit (object_lanes._limit)
__device__ void add_limit(Sink& s, int dof, float sgn, float pen,
                          const float v[kDofs], const float* c) {
  if (!(pen > 0.f)) {
    ++s.cand;
    return;
  }
  const float d = imp_d(pen, c);
  const float k = d * c[3];
  float J[kDofs];
  zero(J);
  put(J, dof, sgn);
  push_row(s, J, -c[4] * (sgn * pick(v, dof)) + k * pen,
           (d / (1.f - d)) * c[5]);
}

// the object columns of a ball's direction d at (px, py)
__device__ __forceinline__ void ball_jac(float j[kDofs], int o, const float d[3],
                                         float px, float py, float cx,
                                         float cy) {
  float jj[3];
  jac3(d, px, py, cx, cy, jj);
  zero(j);
  put(j, o, jj[0]);
  put(j, o + 1, jj[1]);
  put(j, o + 2, jj[2]);
}

// a block's columns of direction sgn * d (dofs -1 where absent)
__device__ __forceinline__ void block_jac(float j[kDofs], const int dof[3],
                                          const float d[3], float sgn) {
  zero(j);
#pragma unroll
  for (int a = 0; a < 3; ++a) put(j, dof[a], sgn > 0.f ? d[a] : -d[a]);
}

struct Robot {  // the robot's pose and velocity at an RK4 stage
  float x, y, th, ct, st, vx, vy, vth;
};

__device__ __forceinline__ void block_center(const float* bk,
                                             const float q[kDofs],
                                             float c[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int d = (int)bk[kBlkDof + a];
    c[a] = bk[a] + (d >= 0 ? pick(q, d) : 0.f);
  }
}

// The items of a forward evaluation (object_lanes._ball_rows, _block_rows,
// in their order), coded as kind | block << 4 | argument << 8.
enum ItemKind : int {
  kBallWall,   // argument: the wall
  kBallFloor,
  kBallRobot,
  kBallArrow,
  kBlkRobot,
  kBlkArrow,   // 24 rows: the two SAT points, the four z-winner corners
  kBlkWall,    // argument: the wall; [its z row,] the two face points
  kBlkPair,    // argument: the earlier block
  kBlkBall,
  kBlkFloor,
  kBlkLimit,   // argument: the axis; its lower and upper limit rows
};

// The item list of the world (shared memory, once a block, by the
// block's first warp): items[0] the count, then per item its code and its
// first candidate row.  Candidate rows count active and inactive alike,
// so they depend on the world alone.  The wrapper sizes the list for
// n_walls + 3 items a ball and n_walls + 10 a block (lane_env.obj_items).
__device__ void build_items(const ObjParams& p, const float* tab,
                            int* items) {
  const int lane = threadIdx.x & 31;
  int* it = items + 1;
  int n = 0, cand = 0;
  auto one = [&](int code, int rows) {
    if (lane == 0) {
      it[2 * n] = code;
      it[2 * n + 1] = cand;
    }
    ++n;
    cand += rows;
  };
  if (p.n_balls > 0) {
    for (int w = lane; w < p.n_walls; w += 32) {
      it[2 * (n + w)] = kBallWall | (w << 8);
      it[2 * (n + w) + 1] = cand + 4 * w;
    }
    n += p.n_walls;
    cand += 4 * p.n_walls;
    one(kBallFloor, 4);
    one(kBallRobot, 4);
    one(kBallArrow, 4);
  }
  for (int k = 0; k < p.n_blocks; ++k) {
    const float* bk = tab + p.off_blocks + k * p.block_stride;
    const bool zslide = (int)bk[kBlkDof + 2] >= 0;
    one(kBlkRobot | (k << 4), 4);
    one(kBlkArrow | (k << 4), 24);
    const int wrows = zslide ? 12 : 8;
    for (int w0 = 0; w0 < p.n_walls; w0 += 32) {
      const int w = w0 + lane;
      const bool reach = w < p.n_walls && bk[kBlkWalls + w] != 0.f;
      const uint32_t bits = __ballot_sync(0xffffffffu, reach);
      if (reach) {
        const int j = __popc(bits & ((1u << lane) - 1u));
        it[2 * (n + j)] = kBlkWall | (k << 4) | (w << 8);
        it[2 * (n + j) + 1] = cand + j * wrows;
      }
      n += __popc(bits);
      cand += __popc(bits) * wrows;
    }
    for (int k2 = 0; k2 < k; ++k2) one(kBlkPair | (k << 4) | (k2 << 8), 8);
    if (p.n_balls > 0) one(kBlkBall | (k << 4), 4);
    if (zslide) one(kBlkFloor | (k << 4), 4);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if ((int)bk[kBlkDof + a] >= 0 && bk[kBlkLimited + a] != 0.f)
        one(kBlkLimit | (k << 4) | (a << 8), 2);
  }
  if (lane == 0) items[0] = n;
}

__device__ __forceinline__ float pick4(const float a[4], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

// arrow box vs one block (object_lanes._arrow_block_rows): 5-axis SAT
// and the incident-edge clip, then the z-winner corner rows
__device__ void arrow_block_rows(Sink& s, const ObjParams& p, const float* bk,
                                 const int dof[3], const float c[3],
                                 const Robot& rb, const float v[kDofs]) {
  const float* cr = bk + kBlkImpRobot;
  const float cx = c[0], cy = c[1], cz = c[2];
  const float ux = rb.ct, uy = rb.st, wxv = -rb.st, wyv = rb.ct;
  const float acx = rb.x + ux * p.arrow_off, acy = rb.y + uy * p.arrow_off;
  const float hl = p.hl, hw = p.hw;
  const float bhx = bk[3], bhy = bk[4];
  const float ov_z = bk[kBlkOvZ] - fabsf(p.az_c - cz);
  const float dx_ = acx - cx, dy_ = acy - cy;
  const float ov_wx = bhx + hl * fabsf(ux) + hw * fabsf(wxv) - fabsf(dx_);
  const float ov_wy = bhy + hl * fabsf(uy) + hw * fabsf(wyv) - fabsf(dy_);
  const float du = dx_ * ux + dy_ * uy;
  const float dv = dx_ * wxv + dy_ * wyv;
  const float ov_u = hl + bhx * fabsf(ux) + bhy * fabsf(uy) - fabsf(du);
  const float ov_v = hw + bhx * fabsf(wxv) + bhy * fabsf(wyv) - fabsf(dv);
  const bool overlap = ov_wx > 0.f && ov_wy > 0.f && ov_u > 0.f &&
                       ov_v > 0.f && ov_z > 0.f;
  if (!overlap) {  // every row of this block's arrow is inactive
    s.cand += 4 * 6;
    return;
  }
  const float min_all = fminf(fminf(ov_wx, ov_wy), fminf(ov_u, ov_v));
  const bool z_wins = ov_z < min_all;
  const bool is_wx = ov_wx == min_all;
  const bool is_wy = !is_wx && ov_wy == min_all;
  const bool is_u = !is_wx && !is_wy && ov_u == min_all;
  const bool is_v = !is_wx && !is_wy && !is_u;
  const float sgn_u = sign1(du), sgn_v = sign1(dv);
  const float nx = (is_wx ? sign1(dx_) : 0.f) + 0.f +
                   (is_u ? ux * sgn_u : 0.f) + (is_v ? wxv * sgn_v : 0.f);
  const float ny = (is_wy ? sign1(dy_) : 0.f) + (is_u ? uy * sgn_u : 0.f) +
                   (is_v ? wyv * sgn_v : 0.f);
  const bool wall = is_wx || is_wy;

  // arrow corners (+,+), (+,-), (-,+), (-,-) over (u, v)
  float cxs[4], cys[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float su = k < 2 ? 1.f : -1.f, sv = (k & 1) ? -1.f : 1.f;
    cxs[k] = acx + su * ux * hl + sv * wxv * hw;
    cys[k] = acy + su * uy * hl + sv * wyv * hw;
  }
  const float face_off = cx * nx + cy * ny + bhx * fabsf(nx) + bhy * fabsf(ny);
  const float half_along =
      hl * fabsf(nx * ux + ny * uy) + hw * fabsf(nx * wxv + ny * wyv);
  const float a_face_off = acx * nx + acy * ny - half_along;
  float pens[4], ptx[4], pty[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wcx = cx + (k < 2 ? bhx : -bhx);
    const float wcy = cy + ((k & 1) ? -bhy : bhy);
    const float corner_pen = face_off - (cxs[k] * nx + cys[k] * ny);
    const float wall_pen = (wcx * nx + wcy * ny) - a_face_off;
    pens[k] = wall ? corner_pen : wall_pen;
    ptx[k] = wall ? cxs[k] : wcx;
    pty[k] = wall ? cys[k] : wcy;
  }
  // the incident edge: two corner indices of four
  const float cu = nx * ux + ny * uy, cv = nx * wxv + ny * wyv;
  const float su_i = -sign1(cu), sv_i = -sign1(cv);
  const bool use_u = fabsf(cu) >= fabsf(cv);
  const int sel_wall_a = use_u ? (su_i > 0.f ? 0 : 2) : (sv_i > 0.f ? 0 : 1);
  const int sel_wall_b = use_u ? (su_i > 0.f ? 1 : 3) : (sv_i > 0.f ? 2 : 3);
  const float sxn = sign1(nx), syn = sign1(ny);
  const bool use_x = fabsf(nx) >= fabsf(ny);
  const int sel_arr_a = use_x ? (sxn > 0.f ? 0 : 2) : (syn > 0.f ? 0 : 1);
  const int sel_arr_b = use_x ? (sxn > 0.f ? 1 : 3) : (syn > 0.f ? 2 : 3);
  const int sel_a = wall ? sel_wall_a : sel_arr_a;
  const int sel_b = wall ? sel_wall_b : sel_arr_b;
  const float pen_a = pick4(pens, sel_a), pen_b = pick4(pens, sel_b);
  const float pax = pick4(ptx, sel_a), pay = pick4(pty, sel_a);
  const float pbx = pick4(ptx, sel_b), pby = pick4(pty, sel_b);
  // tangential clip against the reference face's extent
  const float tx = -ny, ty = nx;
  const float ref_cx = wall ? cx : acx, ref_cy = wall ? cy : acy;
  const float ref_ht =
      wall ? bhx * fabsf(tx) + bhy * fabsf(ty)
           : hl * fabsf(tx * ux + ty * uy) + hw * fabsf(tx * wxv + ty * wyv);
  const float s_a = (pax - ref_cx) * tx + (pay - ref_cy) * ty;
  const float s_b = (pbx - ref_cx) * tx + (pby - ref_cy) * ty;
  const float s_a_cl = fminf(fmaxf(s_a, -ref_ht), ref_ht);
  const float s_b_cl = fminf(fmaxf(s_b, -ref_ht), ref_ht);
  const float edge_s = (pbx - pax) * tx + (pby - pay) * ty;
  const float slope = fabsf(edge_s) > 1e-9f ? (pen_b - pen_a) / edge_s : 0.f;
  const float pen_a_cl = pen_a + (s_a_cl - s_a) * slope;
  const float pen_b_cl = pen_b + (s_b_cl - s_b) * slope;
  // which points are kept
  const bool was_cl_a = fabsf(s_a_cl - s_a) > 1e-12f;
  const bool was_cl_b = fabsf(s_b_cl - s_b) > 1e-12f;
  const float h_ref = wall ? bhx * fabsf(nx) + bhy * fabsf(ny) : half_along;
  const float c1 = 0.02f * h_ref;
  const float c2 = c1 * p.inv101;
  const float depmax = fmaxf(pen_a_cl > 0.f ? pen_a_cl : -INFINITY,
                             pen_b_cl > 0.f ? pen_b_cl : -INFINITY);
  const float thresh = depmax <= c1 ? 0.f : c2;
  const bool clip_a = pen_a_cl > 0.f && (depmax - pen_a_cl) <= 2.f * h_ref;
  const bool clip_b = pen_b_cl > 0.f && (depmax - pen_b_cl) <= 2.f * h_ref;
  const bool keep_a = (was_cl_a && clip_a) || (!was_cl_a && pen_a_cl > thresh);
  const bool keep_b = (was_cl_b && clip_b) || (!was_cl_b && pen_b_cl > thresh);
  const float pos_sgn = wall ? 0.5f : -0.5f;
  const float pax_f = pax + (s_a_cl - s_a) * tx + nx * pen_a_cl * pos_sgn;
  const float pay_f = pay + (s_a_cl - s_a) * ty + ny * pen_a_cl * pos_sgn;
  const float pbx_f = pbx + (s_b_cl - s_b) * tx + nx * pen_b_cl * pos_sgn;
  const float pby_f = pby + (s_b_cl - s_b) * ty + ny * pen_b_cl * pos_sgn;

  float jn[kDofs], jt1[kDofs], jt2[kDofs], t1[3], t2[3];
  const float n3[3] = {nx, ny, 0.f};
  make_frame(nx, ny, 0.f, t1, t2);
  block_jac(jn, dof, n3, -1.f);
  block_jac(jt1, dof, t1, -1.f);
  block_jac(jt2, dof, t2, -1.f);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float pen = e ? pen_b_cl : pen_a_cl;
    const float px = e ? pbx_f : pax_f, py = e ? pby_f : pay_f;
    const bool keep = e ? keep_b : keep_a;
    add_contact(s, p.mu, jn, jt1, jt2,
                rob_dot(n3, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                rob_dot(t1, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                rob_dot(t2, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth), v, pen,
                keep && !z_wins, 2.f, cr);
  }
  // the z-winner rows at the arrow's footprint corners inside the block
  const float nz_sgn = p.az_c <= cz ? -1.f : 1.f;
  const float zn3[3] = {0.f, 0.f, nz_sgn}, zt1[3] = {0.f, 1.f, 0.f},
              zt2[3] = {-nz_sgn, 0.f, 0.f};
  block_jac(jn, dof, zn3, -1.f);
  block_jac(jt1, dof, zt1, -1.f);
  block_jac(jt2, dof, zt2, -1.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in_foot = fabsf(cxs[k] - cx) <= bhx && fabsf(cys[k] - cy) <= bhy;
    add_contact(s, p.mu, jn, jt1, jt2,
                rob_dot(zn3, cxs[k], cys[k], rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                rob_dot(zt1, cxs[k], cys[k], rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                rob_dot(zt2, cxs[k], cys[k], rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                v, ov_z, z_wins && in_foot, 1.f, cr);
  }
}

// parallel-face AABB vs AABB in xy (object_lanes._aabb_face_contacts)
struct FaceContact {
  bool active;
  float nx, ny, pen;
};

__device__ __forceinline__ FaceContact face_contact(
    float cx, float cy, float cz, float hx, float hy, float hz, float wx,
    float wy, float wz, float whx, float why, float whz) {
  const float dx_ = cx - wx, dy_ = cy - wy;
  const float ox = whx + hx - fabsf(dx_);
  const float oy = why + hy - fabsf(dy_);
  const float oz = whz + hz - fabsf(cz - wz);
  const bool use_x = ox <= oy;
  FaceContact f;
  f.pen = use_x ? ox : oy;
  const float sgn = use_x ? sign1(dx_) : sign1(dy_);
  f.nx = use_x ? sgn : 0.f * sgn;
  f.ny = use_x ? 0.f * sgn : sgn;
  const float half_t = use_x ? hy : hx, ctr_t = use_x ? cy : cx;
  const float w_t = use_x ? why : whx, wc_t = use_x ? wy : wx;
  const float t_lo = fmaxf(ctr_t - half_t, wc_t - w_t);
  const float t_hi = fminf(ctr_t + half_t, wc_t + w_t);
  f.active = f.pen > 0.f && oz > 0.f && t_hi > t_lo;
  return f;
}

// the rows of the ball's item (object_lanes._ball_rows, one part)
__device__ void ball_item(Sink& s, const ObjParams& p, const float* tab,
                          int kind, int w, const Robot& rb,
                          const float q[kDofs], const float v[kDofs]) {
  const float* b = tab + p.off_ball;
  const int o = (int)b[3];
  const float cx = b[0] + pick(q, o), cy = b[1] + pick(q, o + 1);
  const float r = b[2];
  float jn[kDofs], jt1[kDofs], jt2[kDofs], t1[3], t2[3];
  if (kind == kBallWall) {  // vs a wall box
    const float* wb = tab + p.off_walls + kWallFloats * w;
    const SphereBox c = sphere_box(cx, cy, r, wb[0], wb[1], wb[2], wb[3],
                                   wb[4], wb[5], r);
    if (!(c.pen > 0.f)) {
      s.cand += 4;
      return;
    }
    const float n3[3] = {c.nx, c.ny, c.nz};
    make_frame(c.nx, c.ny, c.nz, t1, t2);
    ball_jac(jn, o, n3, c.px, c.py, cx, cy);
    ball_jac(jt1, o, t1, c.px, c.py, cx, cy);
    ball_jac(jt2, o, t2, c.px, c.py, cx, cy);
    add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, c.pen, true, 1.f,
                b + kBallImpWall);
  } else if (kind == kBallFloor) {  // floor friction, always active
    const float fn[3] = {0.f, 0.f, 1.f}, f1[3] = {0.f, 1.f, 0.f},
                f2[3] = {-1.f, 0.f, 0.f};
    ball_jac(jn, o, fn, cx, cy, cx, cy);
    ball_jac(jt1, o, f1, cx, cy, cx, cy);
    ball_jac(jt2, o, f2, cx, cy, cx, cy);
    add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, p.floor_pen, true,
                1.f, b + kBallImpFloor);
  } else if (kind == kBallRobot) {
    // robot body sphere vs ball (3D tilted normal); row = ball - robot
    const float dxr = cx - rb.x, dyr = cy - rb.y, dzr = b[4];
    const float dist3 = sqrtf(dxr * dxr + dyr * dyr + dzr * dzr + 1e-30f);
    const float inv3 = 1.f / dist3;
    const float n3[3] = {dxr * inv3, dyr * inv3, dzr * inv3};
    const float pen = b[5] - dist3;
    if (!(pen > 0.f)) {
      s.cand += 4;
      return;
    }
    const float t_mid = p.sphere_r + (dist3 - b[5]) * 0.5f;
    const float px = rb.x + n3[0] * t_mid, py = rb.y + n3[1] * t_mid;
    make_frame(n3[0], n3[1], n3[2], t1, t2);
    ball_jac(jn, o, n3, px, py, cx, cy);
    ball_jac(jt1, o, t1, px, py, cx, cy);
    ball_jac(jt2, o, t2, px, py, cx, cy);
    add_contact(s, p.mu, jn, jt1, jt2,
                -rob_dot(n3, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                -rob_dot(t1, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                -rob_dot(t2, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth), v,
                pen, true, 1.f, b + kBallImpRobot);
  } else {
    // arrow box vs ball (sphere vs rotated box, in the arrow's frame)
    const float ct = rb.ct, st = rb.st;
    const float acx = rb.x + ct * p.arrow_off, acy = rb.y + st * p.arrow_off;
    const float relx = cx - acx, rely = cy - acy;
    const float bxa = relx * ct + rely * st;
    const float bya = -relx * st + rely * ct;
    const float bza = b[6];
    const float ddx = bxa - fminf(fmaxf(bxa, -p.hl), p.hl);
    const float ddy = bya - fminf(fmaxf(bya, -p.hw), p.hw);
    const float ddz = bza - fminf(fmaxf(bza, -p.hz_arrow), p.hz_arrow);
    const float dl = sqrtf(fmaxf(ddx * ddx + ddy * ddy + ddz * ddz, 1e-30f));
    const float pen = r - dl;
    if (!(pen > 0.f)) {
      s.cand += 4;
      return;
    }
    const float nfx = ddx / dl, nfy = ddy / dl, nfz = ddz / dl;
    const float n3[3] = {nfx * ct - nfy * st, nfx * st + nfy * ct, nfz};
    const float t_ab = r + (dl - r) * 0.5f;
    const float px = cx - n3[0] * t_ab, py = cy - n3[1] * t_ab;
    make_frame(n3[0], n3[1], n3[2], t1, t2);
    ball_jac(jn, o, n3, px, py, cx, cy);
    ball_jac(jt1, o, t1, px, py, cx, cy);
    ball_jac(jt2, o, t2, px, py, cx, cy);
    add_contact(s, p.mu, jn, jt1, jt2,
                -rob_dot(n3, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                -rob_dot(t1, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                -rob_dot(t2, px, py, rb.x, rb.y, rb.vx, rb.vy, rb.vth), v,
                pen, true, 1.f, b + kBallImpRobot);
  }
}

// the rows of block k's item (object_lanes._block_rows, one part)
__device__ void block_item(Sink& s, const ObjParams& p, const float* tab,
                           int kind, int k, int arg, const Robot& rb,
                           const float q[kDofs], const float v[kDofs]) {
  const float* bk = tab + p.off_blocks + k * p.block_stride;
  const int dof[3] = {(int)bk[kBlkDof], (int)bk[kBlkDof + 1],
                      (int)bk[kBlkDof + 2]};
  float c[3];
  block_center(bk, q, c);
  const float cx = c[0], cy = c[1], cz = c[2];
  const float hx = bk[3], hy = bk[4], hz = bk[5];
  float jn[kDofs], jt1[kDofs], jt2[kDofs], t1[3], t2[3];

  if (kind == kBlkRobot) {  // robot body sphere vs block (row = robot - block)
    const SphereBox sb = sphere_box(rb.x, rb.y, p.sphere_z, cx, cy, cz, hx,
                                    hy, hz, p.sphere_r);
    if (!(sb.pen > 0.f)) {
      s.cand += 4;
      return;
    }
    const float n3[3] = {sb.nx, sb.ny, sb.nz};
    make_frame(sb.nx, sb.ny, sb.nz, t1, t2);
    block_jac(jn, dof, n3, -1.f);
    block_jac(jt1, dof, t1, -1.f);
    block_jac(jt2, dof, t2, -1.f);
    add_contact(s, p.mu, jn, jt1, jt2,
                rob_dot(n3, sb.px, sb.py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                rob_dot(t1, sb.px, sb.py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                rob_dot(t2, sb.px, sb.py, rb.x, rb.y, rb.vx, rb.vy, rb.vth),
                v, sb.pen, true, 1.f, bk + kBlkImpRobot);
  } else if (kind == kBlkArrow) {
    arrow_block_rows(s, p, bk, dof, c, rb, v);
  } else if (kind == kBlkWall) {
    // vs a wall within reach: [its z row,] the two face points
    const float* cw = bk + kBlkImpWall;
    const float* wb = tab + p.off_walls + kWallFloats * arg;
    FaceContact f = face_contact(cx, cy, cz, hx, hy, hz, wb[0], wb[1], wb[2],
                                 wb[3], wb[4], wb[5]);
    if (dof[2] >= 0) {
      // 3-axis SAT: where the z overlap is the least, a +-z row of
      // multiplicity 4 replaces the xy rows
      const float ox = wb[3] + hx - fabsf(cx - wb[0]);
      const float oy = wb[4] + hy - fabsf(cy - wb[1]);
      const float dz_ = cz - wb[2];
      const float oz = wb[5] + hz - fabsf(dz_);
      const bool overlap = ox > 0.f && oy > 0.f && oz > 0.f;
      const bool z_wins = oz <= ox && oz <= oy;
      f.active = f.active && !z_wins;
      if (overlap && z_wins) {
        const float zn3[3] = {0.f, 0.f, sign1(dz_)};
        make_frame(0.f, 0.f, zn3[2], t1, t2);
        block_jac(jn, dof, zn3, 1.f);
        block_jac(jt1, dof, t1, 1.f);
        block_jac(jt2, dof, t2, 1.f);
        add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, oz, true, 4.f,
                    cw);
      } else {
        s.cand += 4;
      }
    }
    if (f.active) {
      const float n3[3] = {f.nx, f.ny, 0.f};
      make_frame(f.nx, f.ny, 0.f, t1, t2);
      block_jac(jn, dof, n3, 1.f);
      block_jac(jt1, dof, t1, 1.f);
      block_jac(jt2, dof, t2, 1.f);
      for (int e = 0; e < 2; ++e)
        add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, f.pen, true, 2.f,
                    cw);
    } else {
      s.cand += 8;
    }
  } else if (kind == kBlkPair) {
    // vs an earlier block (two-sided Jacobian), two face points
    const float* bp = tab + p.off_blocks + arg * p.block_stride;
    const int dof2[3] = {(int)bp[kBlkDof], (int)bp[kBlkDof + 1],
                         (int)bp[kBlkDof + 2]};
    float c2[3];
    block_center(bp, q, c2);
    const FaceContact f = face_contact(cx, cy, cz, hx, hy, hz, c2[0], c2[1],
                                       c2[2], bp[3], bp[4], bp[5]);
    if (!f.active) {
      s.cand += 8;
      return;
    }
    const float n3[3] = {f.nx, f.ny, 0.f};
    make_frame(f.nx, f.ny, 0.f, t1, t2);
    block_jac(jn, dof, n3, 1.f);
    block_jac(jt1, dof, t1, 1.f);
    block_jac(jt2, dof, t2, 1.f);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      put(jn, dof2[a], -n3[a]);
      put(jt1, dof2[a], -t1[a]);
      put(jt2, dof2[a], -t2[a]);
    }
    for (int e = 0; e < 2; ++e)
      add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, f.pen, true, 2.f,
                  bk + kBlkImpPair + 6 * arg);
  } else if (kind == kBlkBall) {
    // the ball vs block (sphere-box; row = ball - block)
    const float* b = tab + p.off_ball;
    const int o = (int)b[3];
    const float bcx = b[0] + pick(q, o), bcy = b[1] + pick(q, o + 1);
    const SphereBox sb = sphere_box(bcx, bcy, b[2], cx, cy, cz, hx, hy, hz,
                                    b[2]);
    if (!(sb.pen > 0.f)) {
      s.cand += 4;
      return;
    }
    const float n3[3] = {sb.nx, sb.ny, sb.nz};
    make_frame(sb.nx, sb.ny, sb.nz, t1, t2);
    const float* ds[3] = {n3, t1, t2};
    float* js[3] = {jn, jt1, jt2};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float jj[3];
      block_jac(js[m], dof, ds[m], -1.f);
      jac3(ds[m], sb.px, sb.py, bcx, bcy, jj);
      put(js[m], o, jj[0]);
      put(js[m], o + 1, jj[1]);
      put(js[m], o + 2, jj[2]);
    }
    add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, sb.pen, true, 1.f,
                bk + kBlkImpBall);
  } else if (kind == kBlkFloor) {
    // a falling block: the z = 0 floor plane
    const float pen_f = -(cz - hz);
    if (!(pen_f > 0.f)) {
      s.cand += 4;
      return;
    }
    const float n3[3] = {0.f, 0.f, 1.f};
    make_frame(0.f, 0.f, 1.f, t1, t2);
    block_jac(jn, dof, n3, 1.f);
    block_jac(jt1, dof, t1, 1.f);
    block_jac(jt2, dof, t2, 1.f);
    add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, pen_f, true, 1.f,
                bk + kBlkImpWall);
  } else {  // the slide limits of axis arg
    const int d = arg == 0 ? dof[0] : (arg == 1 ? dof[1] : dof[2]);
    const float qd = pick(q, d);
    add_limit(s, d, 1.f, bk[kBlkLo + arg] - qd, v, bk + kBlkImpLim);
    add_limit(s, d, -1.f, qd - bk[kBlkHi + arg], v, bk + kBlkImpLim);
  }
}

// One env's group: its lanes, its row store and active mask (shared
// memory, or the launch's global buffer) and the block's item list.  The
// groups of
// a warp run in lockstep: every loop that holds a warp operation runs
// the same trips in all of them, and every sync, shuffle and ballot
// takes the whole warp (blocks are whole warps; a group past the batch
// steps a copy of the last env and writes nothing but its own store).
struct Group {
  float* store;        // (nd + kRowFixed) x row_stride floats
  uint32_t* mask;      // trace_words words
  const int* items;    // build_items's list
  int lane;            // 0 .. kLanes - 1
  int base;            // the group's first lane in its warp
};

// group g of the block, its row store in shared memory (kSharedRows,
// where p.shared_rows) or in rows, the launch's global row stores, one for
// each group of each block.  Built for shared memory, the store is
// addressed as such; else p.shared_rows (0) picks at run time, which
// leaves the compiler's generic addressing: on PointPushMaze-v0 it
// measured faster than the compiler's global-space code (PERF.md).
template <bool kSharedRows>
__device__ __forceinline__ Group make_group(const ObjParams& p, float* smem,
                                            float* rows, int g) {
  Group r;
  r.store = kSharedRows || p.shared_rows
                ? smem + p.off_groups + g * p.group_floats
                : rows + ((size_t)blockIdx.x * p.groups + g) * p.group_floats;
  r.mask = reinterpret_cast<uint32_t*>(
      r.store + (p.nd + kRowFixed) * p.row_stride);
  r.items = reinterpret_cast<const int*>(smem + p.off_items);
  r.lane = threadIdx.x % kLanes;
  r.base = (threadIdx.x & 31) - r.lane;
  return r;
}

__device__ __forceinline__ void sync() { __syncwarp(kWarp); }

// the group's bits of a ballot of the warp, lane k at bit k
__device__ __forceinline__ uint32_t group_ballot(const Group& g, bool pred) {
  const uint32_t b = __ballot_sync(kWarp, pred);
  return kLanes == 32 ? b : (b >> g.base) & ((1u << kLanes) - 1u);
}

// lane src of the group's value v
__device__ __forceinline__ float group_shfl(float v, int src) {
  return __shfl_sync(kWarp, v, src, kLanes);
}

// Move the active rows of the store to its front, in candidate order;
// returns their count.  Chunk by chunk of kLanes candidates: a chunk's
// active rows go to the positions after the earlier chunks' ones, which
// lie at or before their own; every read of a chunk comes before any
// write of it.  The fields moved: J's nd columns, aref, rinv.
__device__ int compact(const ObjParams& p, const Group& g) {
  const int S = p.row_stride, nf = p.nd + 2;
  int base = 0;
  for (int c0 = 0; c0 < p.max_rows; c0 += kLanes) {
    const uint32_t word = g.mask[c0 >> 5];
    const uint32_t bits =
        kLanes == 32 ? word : (word >> (c0 & 31)) & ((1u << kLanes) - 1u);
    if (!__any_sync(kWarp, bits != 0u)) continue;
    const int c = c0 + g.lane;
    const bool on = (bits >> g.lane) & 1u;
    const int pos = base + __popc(bits & ((1u << g.lane) - 1u));
    base += __popc(bits);
    float f[kDofs + 2];
#pragma unroll
    for (int k = 0; k < kDofs + 2; ++k)
      f[k] = on && k < nf ? g.store[k * S + c] : 0.f;
    sync();
    if (on) {
#pragma unroll
      for (int k = 0; k < kDofs + 2; ++k)
        if (k < nf) g.store[k * S + pos] = f[k];
    }
    sync();
  }
  return base;
}

// x = H^-1 g for an SPD H (only the upper triangle H[i][j], j >= i, read)
__device__ __forceinline__ void chol_solve(const float H[kDofs][kDofs],
                                           const float g[kDofs],
                                           float x[kDofs]) {
  float L[kDofs][kDofs];
#pragma unroll
  for (int j = 0; j < kDofs; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-30f));
    const float inv = 1.f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < kDofs; ++i) {
      float t = H[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  float y[kDofs];
#pragma unroll
  for (int i = 0; i < kDofs; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = kDofs - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < kDofs; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// accumulator a's entries: g[a] for a < kDofs, else H[i][j] (j >= i, in
// row-major order of the upper triangle)
__device__ __forceinline__ void acc_entry(int a, int* i, int* j) {
  if (a < kDofs) {
    *i = a;
    *j = a;
    return;
  }
  int h = a - kDofs, r = 0;
  while (h >= kDofs - r) {
    h -= kDofs - r;
    ++r;
  }
  *i = r;
  *j = r + h;
}

// The bisection's values are exact binary fractions: from [0, 2] or
// [0, 4], ls_iters halvings (10 in every world) leave each lo, hi and mid
// a multiple of 2^-(ls_iters - 1) below 4, which float32 holds exactly,
// and every sum and halving of them is exact.  So the mid at any node of
// its decision tree, and the interval after any path, are computed here
// in closed form from the tree's interval; they are the values the
// one-thread halving reaches, to the bit (the plain version halves).
// Node s (heap order, the root 1, left where the derivative is >= 0)
// lies at (2 j + 1) / 2^(d + 1) of the interval, d its depth, j = s - 2^d.
__device__ __forceinline__ float node_frac(int s) {
  const int d = 31 - __clz(s);
  return (float)(2 * (s - (1 << d)) + 1) * __int_as_float((126 - d) << 23);
}

// `levels` bisection steps on [lo, hi], their decisions the bits
// node + off of neg (the derivative < 0 at that node's t)
__device__ __forceinline__ void walk(uint64_t neg, int off, int levels,
                                     float& lo, float& hi) {
  int node = 1;
  for (int l = 0; l < levels; ++l)
    node = 2 * node + (int)((neg >> (node + off)) & 1ull);
  const float w = (hi - lo) * __int_as_float((127 - levels) << 23);
  lo = lo + w * (float)(node - (1 << levels));
  hi = lo + w;
}

// The row store's fields: J's nd columns, then kRowFixed more.
struct Fields {
  int S, nd, aref, rinv, jar0, jp;   // the stride; the fields' offsets
};

__device__ __forceinline__ Fields fields(const ObjParams& p) {
  const int S = p.row_stride;
  return Fields{S, p.nd, p.nd * S, (p.nd + 1) * S, (p.nd + 2) * S,
                (p.nd + 3) * S};
}

// J[i] of row r: column i of the store, 0 past the world's nd
__device__ __forceinline__ float jcol(const float* st, const Fields& f, int i,
                                      int r) {
  return i < f.nd ? st[i * f.S + r] : 0.f;
}

// The line search's derivative at each of this lane's kSlots values of t
// (slot lane + kLanes * m), each summed over the group's count active
// rows in row order; the bits of the 64 slots where it is < 0.
__device__ uint64_t phi_signs(const Group& g, const Fields& f, int count,
                              float pMx, float pMp, const float t[kSlots]) {
  const float* st = g.store;
  float acc[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) acc[m] = 0.f;
#pragma unroll 4
  for (int r = 0; r < count; ++r) {
    const float jp = st[f.jp + r];
    const float j0 = st[f.jar0 + r];
    const float w = st[f.rinv + r];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const float jart = j0 + t[m] * jp;
      if (jart < 0.f) acc[m] = acc[m] + jp * (w * jart);
    }
  }
  uint64_t neg = 0;
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const float phi = pMx + t[m] * pMp + acc[m];
    neg |= (uint64_t)group_ballot(g, phi < 0.f) << (kLanes * m);
  }
  return neg;
}

// the step t of the bisection on the monotone derivative (the one-thread
// order: lo = 0, hi = 2, or 4 where the derivative at 2 is < 0, then
// ls_iters halvings), 64 derivative values a pass; the warp's groups
// take the same passes
__device__ float line_search(const ObjParams& p, const Group& g,
                             const Fields& f, int count, float pMx,
                             float pMp) {
  float t[kSlots], frac[kSlots];
  // pass 1: t = 2 (slot 0), the next five steps below hi = 2 (slots
  // 1-31) and, past the known first step (mid 2), below hi = 4 (33-63)
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int s = g.lane + kLanes * m;
    frac[m] = node_frac(s == 0 ? 1 : s);
    t[m] = s == 0 ? 2.f
                  : (s < 32 ? 2.f * frac[m]
                            : 2.f + 2.f * node_frac(s == 32 ? 1 : s - 32));
  }
  uint64_t neg = phi_signs(g, f, count, pMx, pMp, t);
  float lo = 0.f, hi = 2.f;
  int rem = p.ls_iters;
  if (neg & 1ull) {
    hi = 4.f;
    if (rem > 0) {
      lo = 2.f;   // the first step's mid, 2: < 0
      --rem;
      const int lv = rem < 5 ? rem : 5;
      walk(neg, 32, lv, lo, hi);
      rem -= lv;
    }
  } else {
    const int lv = rem < 5 ? rem : 5;
    walk(neg, 0, lv, lo, hi);
    rem -= lv;
  }
  while (__any_sync(kWarp, rem > 0)) {  // six steps a pass (slots 1-63)
#pragma unroll
    for (int m = 0; m < kSlots; ++m) t[m] = lo + (hi - lo) * frac[m];
    neg = phi_signs(g, f, count, pMx, pMp, t);
    const int lv = rem < 6 ? rem : 6;
    if (lv > 0) walk(neg, 0, lv, lo, hi);
    rem -= lv;
  }
  return 0.5f * (lo + hi);
}

// primal Newton over the count active rows at the front of the store
// (object_lanes._solve_newton); x on every lane of the group
__device__ __forceinline__ void solve(const ObjParams& p, const float* tab,
                                      const Group& g, int count,
                                      float x[kDofs]) {
  const float* M = tab + kHeadMass;
  const float* a0 = tab + kHeadA0;
  const Fields f = fields(p);
  float* st = g.store;
  // this lane's accumulators: entries (ai, aj), g where ai == aj < kDofs
  // and the accumulator is g's
  int ai[kAccLane], aj[kAccLane];
  bool is_g[kAccLane], live[kAccLane];
#pragma unroll
  for (int m = 0; m < kAccLane; ++m) {
    const int a = g.lane + kLanes * m;
    live[m] = a < kAcc;
    is_g[m] = a < kDofs;
    acc_entry(live[m] ? a : 0, &ai[m], &aj[m]);
  }
  zero(x);
  for (int it = 0; it < p.newton_iters; ++it) {
    sync();
    for (int r = g.lane; r < count; r += kLanes) {
      float jar0 = jcol(st, f, 0, r) * x[0];
#pragma unroll
      for (int i = 1; i < kDofs; ++i) jar0 = jar0 + jcol(st, f, i, r) * x[i];
      st[f.jar0 + r] = jar0 - st[f.aref + r];
    }
    sync();
    float acc[kAccLane];
#pragma unroll
    for (int m = 0; m < kAccLane; ++m) acc[m] = 0.f;
#pragma unroll 4
    for (int r = 0; r < count; ++r) {
      const float jar0 = st[f.jar0 + r];
      if (jar0 < 0.f) {
        const float w = st[f.rinv + r];
#pragma unroll
        for (int m = 0; m < kAccLane; ++m) {
          if (!live[m]) continue;
          const float Ji = jcol(st, f, ai[m], r);
          const float Jj = jcol(st, f, aj[m], r);
          const float wj = w * jar0;
          const float jw = Ji * w;
          acc[m] = acc[m] + (is_g[m] ? Ji * wj : jw * Jj);
        }
      }
    }
    // every lane takes the 27 sums (accumulator a on lane a % kLanes)
    float gv[kDofs], H[kDofs][kDofs];
#pragma unroll
    for (int i = 0; i < kDofs; ++i)
      gv[i] = group_shfl(acc[i / kLanes], i % kLanes);
#pragma unroll
    for (int i = 0, a = kDofs; i < kDofs; ++i) {
#pragma unroll
      for (int j = i; j < kDofs; ++j, ++a)
        H[i][j] = group_shfl(acc[a / kLanes], a % kLanes);
    }
    float grad[kDofs], sol[kDofs], pd[kDofs];
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      grad[i] = M[i] * (x[i] - a0[i]) + gv[i];
      H[i][i] = H[i][i] + M[i];
    }
    chol_solve(H, grad, sol);
    float pMx = 0.f, pMp = 0.f;
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      pd[i] = -sol[i];
      pMx = pMx + pd[i] * M[i] * (x[i] - a0[i]);
      pMp = pMp + pd[i] * M[i] * pd[i];
    }
    for (int r = g.lane; r < count; r += kLanes) {
      float jp = jcol(st, f, 0, r) * pd[0];
#pragma unroll
      for (int i = 1; i < kDofs; ++i) jp = jp + jcol(st, f, i, r) * pd[i];
      st[f.jp + r] = jp;
    }
    sync();
    const float t = line_search(p, g, f, count, pMx, pMp);
#pragma unroll
    for (int i = 0; i < kDofs; ++i) x[i] = x[i] + t * pd[i];
  }
}

// the object accelerations of one forward evaluation; trace (nullable):
// this evaluation's trace_words words of active candidates
__device__ __forceinline__ void forward(const ObjParams& p, const float* tab,
                                        const Group& g, uint32_t* trace,
                                        const Robot& rb, const float q[kDofs],
                                        const float v[kDofs],
                                        float acc[kDofs]) {
  sync();   // the last evaluation's solve has read the store
  for (int w = g.lane; w < p.trace_words; w += kLanes) g.mask[w] = 0u;
  sync();
  const int n_items = g.items[0];
  for (int i = g.lane; i < n_items; i += kLanes) {
    const int code = g.items[1 + 2 * i];
    Sink s{g.store, p.row_stride, p.nd, g.mask, g.items[2 + 2 * i]};
    const int kind = code & 15;
    if (kind <= kBallArrow)
      ball_item(s, p, tab, kind, code >> 8, rb, q, v);
    else
      block_item(s, p, tab, kind, (code >> 4) & 15, code >> 8, rb, q, v);
  }
  sync();
  if (trace)
    for (int w = g.lane; w < p.trace_words; w += kLanes) trace[w] = g.mask[w];
  const int count = compact(p, g);
  // without active rows the solve depends on the world alone: the
  // wrapper's x_free; the warp's groups solve together where any must
  if (__all_sync(kWarp, count == 0)) {
#pragma unroll
    for (int i = 0; i < kDofs; ++i) acc[i] = p.x_free[i];
    return;
  }
  solve(p, tab, g, count, acc);
}

// One RK4 env step of the object dofs (object_lanes.object_step_lanes):
// the robot's pose advances at its velocity through the stages.  q, v:
// the object dofs in the solve's order, stepped in place on every lane of
// the group.  trace (nullable): this env's 4 x trace_words words.
__device__ void object_step(const ObjParams& p, const float* tab,
                            const Group& g, uint32_t* trace, float x,
                            float y, float th, float vx, float vy, float vth,
                            float q[kDofs], float v[kDofs]) {
  float acc[kDofs], vs[kDofs], sq[kDofs], sv[kDofs], qi[kDofs], vi[kDofs];
  // the four stages in one loop, so that one copy of forward is built:
  // stage e > 0 starts from the last one's velocities and accelerations
  // at dt / 2, dt / 2, dt; weights 1/6, 1/3, 1/3, 1/6
#pragma unroll 1
  for (int e = 0; e < 4; ++e) {
    const float ah = e == 3 ? p.h : p.ah_half;
    const float bw = (e == 0 || e == 3) ? p.bw16 : p.bw13;
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      qi[i] = e == 0 ? q[i] : q[i] + ah * vs[i];
      vi[i] = e == 0 ? v[i] : v[i] + ah * acc[i];
    }
    const float ths = e == 0 ? th : th + ah * vth;
    const Robot rs{e == 0 ? x : x + ah * vx, e == 0 ? y : y + ah * vy, ths,
                   cosf(ths), sinf(ths), vx, vy, vth};
    forward(p, tab, g, trace ? trace + e * p.trace_words : nullptr, rs, qi,
            vi, acc);
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      sq[i] = e == 0 ? bw * v[i] : sq[i] + bw * vi[i];
      sv[i] = e == 0 ? bw * acc[i] : sv[i] + bw * acc[i];
      vs[i] = vi[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kDofs; ++i) {
    q[i] = q[i] + p.h * sq[i];
    v[i] = v[i] + p.h * sv[i];
  }
}

}  // namespace mmt_obj
