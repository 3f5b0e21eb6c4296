// Point object worlds: the reduced object solve inside the Point step and
// rollout kernels (csrc/point_lane.cu, point_obj_step_kernel and
// point_obj_rollout_kernel).
//
// Replaces the object part of the TPU Point kernels:
//   object_step         <- mujoco_maze_tpu/ops/object_lanes.py
//                          object_step_lanes :1009 (RK4, robot kinematic)
//   object_forward      <- object_forward_lanes :983 and the row builders
//                          _imp ... _arrow_block_rows :194-880
//   solve               <- _solve_newton_lanes :913, _chol_solve :882
//   (the heads' anchor)  <- point_pallas.py _first_object_pos :370
// as ops/point_pallas.py _step_math :419-430 runs them, between the
// kinematics and the residual.  The plain version is
// mujoco_maze_tpu_torch/ops/object_lanes.py, row for row.
//
// Design.  One thread is one env, as in the plain-maze kernels.  A forward
// evaluation walks the world's candidate contacts in a fixed order (the
// ball's: walls, floor, robot, arrow; each block's: robot sphere, arrow a
// and b, the four z-winner corners, per reachable wall [its z row,] the
// two face points, earlier blocks, the ball, floor, slide limits) and
// keeps only the ACTIVE rows (rinv > 0): an inactive row adds exactly 0 to
// the gradient, to H and to the line search's derivative, so the Newton
// solve runs over the active rows alone.  They go to a per-env list in a
// scratch buffer that the wrapper allocates, max_rows (the world's
// candidate count R, 76-676) rows of kRowFields floats, laid out
// [row][field][env] so that a warp's threads touch neighbouring words;
// it cannot overflow.  Every world table (wall boxes, the ball, the
// blocks with their contact constants and reach flags) comes at run time
// in one float table, staged into shared memory; the bounds of the one
// build are the maxima of the 27 worlds: 6 object dofs, 3 blocks, 1 ball.
// The solve is written for 6 dofs: a world with fewer pads its dofs with
// unit mass, no gravity and zero Jacobian columns, which leaves the real
// dofs' results unchanged to the bit (the padded Cholesky rows are exact
// zeros and ones).  Runtime dof indices are read and written with
// unrolled selects (pick/put), so the small arrays stay in registers.
//
// What bounds it on an H100.  A forward evaluation costs the geometry of
// every candidate contact (~40-250 fp32 operations each) plus, per active
// row, ~60 operations a Newton step and ~4 a line-search step; the data
// moved per env-step is a few hundred bytes.  So it is bound by fp32
// work on one thread per env: at 4096 envs, 32 blocks of 128 threads
// fill a quarter of the SMs, each thread a long serial chain.
//
// Arithmetic.  This file and the plain version do the same float32
// operations in the same order, so on the card they agree to the bit:
// constants are folded in Python double and rounded once (passed in the
// table and in ObjParams); each division by a constant is a product with
// its float32 reciprocal (PyTorch's CUDA division by a Python scalar is
// such a product); the library is built without fast math and with
// -fmad=false; and every sum over rows runs over the active rows in row
// order, here over the list, there over the rows gathered in row order
// (an inactive row adds exactly 0 there).  Knife edges (the jar0 < 0 and
// jart < 0 switches of the solve, the SAT axis pick, the incident-edge
// clip) then fall the same way in both.

#pragma once

#include <math.h>
#include <stdint.h>

// The scalars of one object world (lane_env.ObjParams, field for field).
struct ObjParams {
  int nd, n_walls, n_balls, n_blocks, newton_iters, ls_iters, max_rows;
  int off_walls, off_ball, off_blocks, block_stride, n_table, trace_words;
  int head_obj;
  float h, ah_half, bw16, bw13;   // RK4: dt, dt / 2, weights
  float mu, sphere_r, sphere_z, arrow_off, hl, hw, hz_arrow, az_c, floor_pen;
  float inv101;                           // float32 1 / 1.01
};

namespace mmt_obj {

constexpr int kDofs = 6;        // object dofs of the build (padded)
constexpr int kRowFields = 10;  // J (6), aref, rinv, J x - aref, J p
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

// The active rows of one forward evaluation, in this env's column of the
// scratch buffer; cand counts the candidates (the row order of the plain
// version), trace (nullable) gets one bit per active candidate.
struct Sink {
  float* rows;   // this env's first word: rows[(k * kRowFields + f) * n]
  int n;         // the batch: the stride between fields
  int cap, count, cand;
  uint32_t* trace;
};

__device__ __forceinline__ float* row_ptr(const Sink& s, int k) {
  return s.rows + (size_t)k * kRowFields * s.n;
}

__device__ __forceinline__ void push_row(Sink& s, const float J[kDofs],
                                         float aref, float rinv) {
  if (s.trace) s.trace[s.cand >> 5] |= 1u << (s.cand & 31);
  if (s.count < s.cap) {
    float* r = row_ptr(s, s.count);
#pragma unroll
    for (int f = 0; f < kDofs; ++f) r[(size_t)f * s.n] = J[f];
    r[(size_t)6 * s.n] = aref;
    r[(size_t)7 * s.n] = rinv;
    ++s.count;
  }
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

// all rows of the ball (object_lanes._ball_rows)
__device__ void ball_rows(Sink& s, const ObjParams& p, const float* tab,
                          const Robot& rb, const float q[kDofs],
                          const float v[kDofs]) {
  const float* b = tab + p.off_ball;
  const int o = (int)b[3];
  const float cx = b[0] + pick(q, o), cy = b[1] + pick(q, o + 1);
  const float r = b[2];
  float jn[kDofs], jt1[kDofs], jt2[kDofs], t1[3], t2[3];
  // vs the wall boxes
  for (int w = 0; w < p.n_walls; ++w) {
    const float* wb = tab + p.off_walls + kWallFloats * w;
    const SphereBox c = sphere_box(cx, cy, r, wb[0], wb[1], wb[2], wb[3],
                                   wb[4], wb[5], r);
    if (!(c.pen > 0.f)) {
      s.cand += 4;
      continue;
    }
    const float n3[3] = {c.nx, c.ny, c.nz};
    make_frame(c.nx, c.ny, c.nz, t1, t2);
    ball_jac(jn, o, n3, c.px, c.py, cx, cy);
    ball_jac(jt1, o, t1, c.px, c.py, cx, cy);
    ball_jac(jt2, o, t2, c.px, c.py, cx, cy);
    add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, c.pen, true, 1.f,
                b + kBallImpWall);
  }
  // floor friction, always active
  {
    const float fn[3] = {0.f, 0.f, 1.f}, f1[3] = {0.f, 1.f, 0.f},
                f2[3] = {-1.f, 0.f, 0.f};
    ball_jac(jn, o, fn, cx, cy, cx, cy);
    ball_jac(jt1, o, f1, cx, cy, cx, cy);
    ball_jac(jt2, o, f2, cx, cy, cx, cy);
    add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, p.floor_pen, true,
                1.f, b + kBallImpFloor);
  }
  // robot body sphere vs ball (3D tilted normal); row = ball - robot
  {
    const float dxr = cx - rb.x, dyr = cy - rb.y, dzr = b[4];
    const float dist3 = sqrtf(dxr * dxr + dyr * dyr + dzr * dzr + 1e-30f);
    const float inv3 = 1.f / dist3;
    const float n3[3] = {dxr * inv3, dyr * inv3, dzr * inv3};
    const float pen = b[5] - dist3;
    if (pen > 0.f) {
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
      s.cand += 4;
    }
  }
  // arrow box vs ball (sphere vs rotated box, in the arrow's frame)
  {
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
    if (pen > 0.f) {
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
    } else {
      s.cand += 4;
    }
  }
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

// all rows of block k (object_lanes._block_rows)
__device__ void block_rows(Sink& s, const ObjParams& p, const float* tab,
                           int k, const Robot& rb, const float q[kDofs],
                           const float v[kDofs]) {
  const float* bk = tab + p.off_blocks + k * p.block_stride;
  const int dof[3] = {(int)bk[kBlkDof], (int)bk[kBlkDof + 1],
                      (int)bk[kBlkDof + 2]};
  float c[3];
  block_center(bk, q, c);
  const float cx = c[0], cy = c[1], cz = c[2];
  const float hx = bk[3], hy = bk[4], hz = bk[5];
  float jn[kDofs], jt1[kDofs], jt2[kDofs], t1[3], t2[3];

  // robot body sphere vs block (row = robot - block)
  {
    const SphereBox sb = sphere_box(rb.x, rb.y, p.sphere_z, cx, cy, cz, hx,
                                    hy, hz, p.sphere_r);
    if (sb.pen > 0.f) {
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
    } else {
      s.cand += 4;
    }
  }

  arrow_block_rows(s, p, bk, dof, c, rb, v);

  // vs the walls within reach: per wall [its z row,] the two face points
  const float* cw = bk + kBlkImpWall;
  for (int w = 0; w < p.n_walls; ++w) {
    if (bk[kBlkWalls + w] == 0.f) continue;
    const float* wb = tab + p.off_walls + kWallFloats * w;
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
  }

  // vs earlier blocks (two-sided Jacobian), two face points each
  for (int k2 = 0; k2 < k; ++k2) {
    const float* bp = tab + p.off_blocks + k2 * p.block_stride;
    const int dof2[3] = {(int)bp[kBlkDof], (int)bp[kBlkDof + 1],
                         (int)bp[kBlkDof + 2]};
    float c2[3];
    block_center(bp, q, c2);
    const FaceContact f = face_contact(cx, cy, cz, hx, hy, hz, c2[0], c2[1],
                                       c2[2], bp[3], bp[4], bp[5]);
    if (!f.active) {
      s.cand += 8;
      continue;
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
                  bk + kBlkImpPair + 6 * k2);
  }

  // the ball vs block (sphere-box; row = ball - block)
  if (p.n_balls > 0) {
    const float* b = tab + p.off_ball;
    const int o = (int)b[3];
    const float bcx = b[0] + pick(q, o), bcy = b[1] + pick(q, o + 1);
    const SphereBox sb = sphere_box(bcx, bcy, b[2], cx, cy, cz, hx, hy, hz,
                                    b[2]);
    if (sb.pen > 0.f) {
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
    } else {
      s.cand += 4;
    }
  }

  // a falling block: the z = 0 floor plane, and its slide limits
  if (dof[2] >= 0) {
    const float pen_f = -(cz - hz);
    if (pen_f > 0.f) {
      const float n3[3] = {0.f, 0.f, 1.f};
      make_frame(0.f, 0.f, 1.f, t1, t2);
      block_jac(jn, dof, n3, 1.f);
      block_jac(jt1, dof, t1, 1.f);
      block_jac(jt2, dof, t2, 1.f);
      add_contact(s, p.mu, jn, jt1, jt2, 0.f, 0.f, 0.f, v, pen_f, true, 1.f,
                  cw);
    } else {
      s.cand += 4;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (dof[a] < 0 || bk[kBlkLimited + a] == 0.f) continue;
    const float qd = pick(q, dof[a]);
    add_limit(s, dof[a], 1.f, bk[kBlkLo + a] - qd, v, bk + kBlkImpLim);
    add_limit(s, dof[a], -1.f, qd - bk[kBlkHi + a], v, bk + kBlkImpLim);
  }
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

// the line search's derivative at step t over the active rows
__device__ __forceinline__ float phi_prime(const Sink& s, float pMx, float pMp,
                                           float t) {
  float acc = 0.f;
  for (int r = 0; r < s.count; ++r) {
    const float* row = row_ptr(s, r);
    const float jp = row[(size_t)9 * s.n];
    const float jart = row[(size_t)8 * s.n] + t * jp;
    if (jart < 0.f) acc = acc + jp * (row[(size_t)7 * s.n] * jart);
  }
  return pMx + t * pMp + acc;
}

// primal Newton over the active rows (object_lanes._solve_newton)
__device__ void solve(const ObjParams& p, const float* tab, const Sink& s,
                      float x[kDofs]) {
  const float* M = tab + kHeadMass;
  const float* a0 = tab + kHeadA0;
  zero(x);
  for (int it = 0; it < p.newton_iters; ++it) {
    float g[kDofs], H[kDofs][kDofs];
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      g[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kDofs; ++j) H[i][j] = 0.f;
    }
    for (int r = 0; r < s.count; ++r) {
      float* row = row_ptr(s, r);
      float J[kDofs];
#pragma unroll
      for (int i = 0; i < kDofs; ++i) J[i] = row[(size_t)i * s.n];
      float jar0 = J[0] * x[0];
#pragma unroll
      for (int i = 1; i < kDofs; ++i) jar0 = jar0 + J[i] * x[i];
      jar0 = jar0 - row[(size_t)6 * s.n];
      row[(size_t)8 * s.n] = jar0;
      if (jar0 < 0.f) {
        const float w = row[(size_t)7 * s.n];
        const float wj = w * jar0;
#pragma unroll
        for (int i = 0; i < kDofs; ++i) {
          g[i] = g[i] + J[i] * wj;
          const float jw = J[i] * w;
#pragma unroll
          for (int j = i; j < kDofs; ++j) H[i][j] = H[i][j] + jw * J[j];
        }
      }
    }
    float grad[kDofs], sol[kDofs], pd[kDofs];
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      grad[i] = M[i] * (x[i] - a0[i]) + g[i];
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
    for (int r = 0; r < s.count; ++r) {
      float* row = row_ptr(s, r);
      float jp = row[0] * pd[0];
#pragma unroll
      for (int i = 1; i < kDofs; ++i) jp = jp + row[(size_t)i * s.n] * pd[i];
      row[(size_t)9 * s.n] = jp;
    }
    // bisection on the monotone derivative
    float lo = 0.f, hi = 2.f;
    if (phi_prime(s, pMx, pMp, hi) < 0.f) hi = 4.f;
    for (int k = 0; k < p.ls_iters; ++k) {
      const float mid = 0.5f * (lo + hi);
      if (phi_prime(s, pMx, pMp, mid) < 0.f)
        lo = mid;
      else
        hi = mid;
    }
    const float t = 0.5f * (lo + hi);
#pragma unroll
    for (int i = 0; i < kDofs; ++i) x[i] = x[i] + t * pd[i];
  }
}

// the object accelerations of one forward evaluation
__device__ void forward(const ObjParams& p, const float* tab, Sink& s,
                        const Robot& rb, const float q[kDofs],
                        const float v[kDofs], float acc[kDofs]) {
  s.count = 0;
  s.cand = 0;
  if (p.n_balls > 0) ball_rows(s, p, tab, rb, q, v);
  for (int k = 0; k < p.n_blocks; ++k) block_rows(s, p, tab, k, rb, q, v);
  solve(p, tab, s, acc);
}

// One RK4 env step of the object dofs (object_lanes.object_step_lanes):
// the robot's pose advances at its velocity through the stages.  q, v:
// the object dofs in the solve's order, stepped in place.  rows: this
// env's first word of the scratch, n the batch; trace (nullable): this
// env's 4 x trace_words words.
__device__ void object_step(const ObjParams& p, const float* tab, float* rows,
                            int n, uint32_t* trace, float x, float y,
                            float th, float vx, float vy, float vth,
                            float q[kDofs], float v[kDofs]) {
  Sink s{rows, n, p.max_rows, 0, 0, nullptr};
  const float ah[3] = {p.ah_half, p.ah_half, p.h};
  const float bw[4] = {p.bw16, p.bw13, p.bw13, p.bw16};
  float acc[kDofs], vs[kDofs], sq[kDofs], sv[kDofs], qi[kDofs], vi[kDofs];
  Robot rb{x, y, th, cosf(th), sinf(th), vx, vy, vth};
  s.trace = trace;
  forward(p, tab, s, rb, q, v, acc);
#pragma unroll
  for (int i = 0; i < kDofs; ++i) {
    sq[i] = bw[0] * v[i];
    sv[i] = bw[0] * acc[i];
    vs[i] = v[i];
  }
  for (int e = 0; e < 3; ++e) {
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      qi[i] = q[i] + ah[e] * vs[i];
      vi[i] = v[i] + ah[e] * acc[i];
    }
    const float ths = th + ah[e] * vth;
    Robot rs{x + ah[e] * vx, y + ah[e] * vy, ths, cosf(ths), sinf(ths),
             vx, vy, vth};
    s.trace = trace ? trace + (e + 1) * p.trace_words : nullptr;
    forward(p, tab, s, rs, qi, vi, acc);
#pragma unroll
    for (int i = 0; i < kDofs; ++i) {
      vs[i] = vi[i];
      sq[i] = sq[i] + bw[e + 1] * vi[i];
      sv[i] = sv[i] + bw[e + 1] * acc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kDofs; ++i) {
    q[i] = q[i] + p.h * sq[i];
    v[i] = v[i] + p.h * sv[i];
  }
}

}  // namespace mmt_obj
