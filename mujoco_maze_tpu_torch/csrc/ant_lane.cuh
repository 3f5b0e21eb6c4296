// Ant robot in a maze: the step and rollout kernels, as templates over the
// world's compile-time bounds.  ant_lane.cu instantiates the object-free
// mazes (no world dofs), ant_blocks.cu the block worlds (up to 3 movable
// blocks and 6 slide dofs), ant_balls.cu the ball worlds (one free object
// ball); each .cu file compiles on its own, so the builds run side by side.
//
// Replaces the TPU kernel of the JAX package
//   mujoco_maze_tpu/ops/ant_pallas.py build_step_kernel (:228) and
//   build_rollout_kernel (:222) -> _make_kernel.env_step (:139, with the
//   BlockCarry heads :158-171 and the Billiard heads :157-160), _rk4_scan
//   (:105), with ops/ant_math.py forward_ant (:1113, the block dofs
//   :1117-1136, the ball blocks :1137-1170, travel limits :1199-1233,
//   falling support :1235-1268), fk_ant (:198), mass_matrix (:309),
//   rne_bias (:347), _contact_rows (:890, moving boxes :918-968, the ball
//   rows _ball_rows :814), _ball_kin (:653), _ball_mass_block (:681),
//   _ball_bias (:708), _sphere_aabb_nearest2 (:751), integrate_ant (:1524,
//   with extra_free), and sample_ctrl / sample_reset (:186, :192),
// for worlds without spin blocks.
//
// What it computes.  One env step is frame_skip (5) RK4 steps of dt 0.02
// of the free-root ant, the world's slide dofs and the free object ball;
// each RK4 step runs four forward-dynamics evaluations.  A forward
// evaluation does, per env:
//   * the kinematics of the 13 ant bodies (torso from the quaternion, each
//     leg joint a Rodrigues rotation about its world axis); a block's
//     center is its base plus its slide offsets; the ball's pose from its
//     own free joint (position and quaternion);
//   * the 14x14 ant mass matrix in Jacobian form (sum over bodies of
//     m Jc^T Jc + W^T Iw W, plus armature), its Cholesky factor (pivots
//     clamped at 1e-12) and its inverse; the world dofs are decoupled in
//     M, so their block is the diagonal of the block masses and is never
//     factored; the ball's 6x6 block (composite rigid body form about the
//     ball's own origin), factored and inverted alike;
//   * the RNE bias of the ant (gravity and velocity products, in world
//     axes about the torso origin, where float32 keeps the robot's own
//     scale), and of the ball about its own origin (physics/engine.py
//     takes each kinematic tree about its root's origin: about the torso,
//     a ball far from the ant would lose every digit of its 6x6 block);
//     gravity m g on the z slides;
//   * impedance joint limits on the 8 hinges and on every limited slide
//     (physics/engine.py limit_force), from the smooth acceleration qacc0;
//   * the falling blocks' coupled platform support and z limit
//     (physics/contact.py falling_support_force) against the highest
//     platform top the block's center overlaps;
//   * contacts: every test sphere (37) against the floor plane, against
//     the two nearest static boxes (walls and platforms) of those within
//     the ant's reach of the torso, against every movable block, and
//     against the ball; the ball against the floor and the two nearest of
//     ALL static boxes (it roams the maze: the torso's reach says nothing
//     of it); a contact is active when dist < margin; 3 pyramid rows each
//     (normal, two tangents), a row's entry on a block dof -dir[axis], on
//     the ball's dofs +-(dir[k], (x - o) x dir . R e_k) (the ball is the
//     first body against the static world, the second against a sphere);
//     projected Jacobi, 4 sweeps, omega 0.6, on the regularised Delassus
//     matrix (physics/contact.py contact_qfrc);
//   * qacc = M^-1 (tau + f_con - bias).
// Then the task heads on (x, y, z) of the torso, or of the first observed
// object where the task observes it first: the first block's center
// (BlockCarry) or the ball's body origin (Billiard): the inner reward
// (planar torso speed minus 1e-4 |ctrl|^2, scaled) plus the goal/dist
// head, first hit wins.
//
// Design.  One thread is one env.  The public (B, nq) / (B, nv) row-major
// tensors are read in place with their row strides.  The per-spec data
// are runtime tables, packed into one float32 buffer that each block
// stages into shared memory: the bodies, the dofs, the actuators, the test
// spheres, the static boxes, the goals, the reset pose, for the block
// worlds the world dofs, the blocks, the platforms under falling blocks
// and the pair-mixed constants of every sphere-vs-block pair, and for the
// ball worlds the ball and the pair-mixed constants of every sphere-vs-ball
// pair.  So one build of each instantiation serves every Ant maze of its
// kind: the counts (blocks, world dofs, spheres, boxes) arrive at run time
// and only their maxima are compile-time.  The scalars come by value in
// AntParams.  Per-thread state that does not fit in registers (the 13 body
// poses, the 14x14 factor and inverse, the contact rows) lives in local
// memory.  Only ACTIVE contacts are kept, in a compacted list sized for
// every candidate (kMaxSph x (3 + blocks), and 3 + kMaxSph more with a
// ball): an inactive contact's force is exactly 0 after the projection
// (contact.py project), so it adds nothing to any sum.  The static boxes a
// sphere is tested against are those whose box lies within the ant's reach
// of the torso (P.reach2, a sound bound from the model: a box farther away
// can neither touch a sphere nor rank above a box that does), so the picks
// equal the nearest two of ALL boxes, as the plain version takes them.
// The row and sweep loops stay rolled (#pragma unroll 1) to keep the
// compile short.  All of the ball's code sits behind `if constexpr (NBALL
// > 0)`: the two other instantiations compile to the arithmetic they had.
//
// What bounds it on an H100.  About 270 bytes per env and step move
// (1.1 MB at B = 4096), against some 7 x 10^5 fp32 operations per
// env-step (ant_step_flops in chip_smoke.py counts them from this source,
// with the active contacts the kernel counts): the kernel is bound by
// fp32 operations, and at one thread per env it runs 4096 threads, 32 to
// 128 per block, so each SM holds one to four warps of a long serial
// dependence chain with local-memory traffic.  It is far from that bound;
// the design choice of this version is to be right and simple.  Spreading
// an env over a warp (the 14x14 factor, the contact rows) is the first
// thing to try to make it fast.
//
// Arithmetic.  The plain version (ops/ant_kernel.py ant_step_plain) is
// the batched engine (physics/engine.py, physics/contact.py), which
// computes the same function by another algorithm (the CRB mass matrix
// from 6x6 spatial inertias, dense J over all contacts, torch reductions
// and cuBLAS products), so the two agree to float32 rounding, not to the
// bit: chip_smoke.py states the bounds.  This file uses IEEE sqrtf, sinf,
// cosf, logf and divisions (no rsqrtf, no fast math) and is built with
// -fmad=false.  Knife edges, with the JAX comparison operators kept: the
// strict < of the nearest-two insertion (first of equal keys wins),
// outside = d_out > 1e-6, the min-exit axis ex <= min(ey, ez), active =
// dist < margin, the joint-limit switch viol > 0, the support's case
// analysis, the platform overlap |c - p| < o, and the max(0, .) / cone
// clamps of project.  Constants are not folded: a mask multiplies as a
// branch, never as a 1.0, and 0 * NaN stays NaN.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

struct AntParams {
  // offsets of the tables in the packed buffer (floats) and their sizes
  int off_body, off_dof, off_act, off_sph, off_box, off_goal, off_qpos0;
  int off_wdof, off_blk, off_plat, off_qpair, off_ball, off_bpair;
  int n_floats;
  int n_sph, n_box, n_goal, n_w, n_blk, n_ball;
  int frame_skip, solver_iters, reward_type, episode_limit, obs_offset;
  float h, h_half;            // RK4 step and float32(h / 2)
  float dt_outer;             // h * frame_skip: the reward's velocity step
  float gravity;              // +g of the fictitious base acceleration
  float ctrl_weight, inner_scale, penalty, inv_scale;
  float lim_b, lim_d0, lim_dd, lim_width, lim_kden;  // joint-limit impedance
  float omega;                // Jacobi relaxation
  float reach2;               // squared torso-to-box distance a sphere reaches
  // the falling support's impedance constants at its time constant tc:
  // 0.995 / (0.995^2 tc^2), 2 / (0.995 tc), 0.95^2 tc^2, 2 / (0.95 tc)
  float sup_kc, sup_bc, sup_kl_den, sup_bl;
};

namespace {

constexpr int kNb = 13;       // ant bodies
constexpr int kNa = 14;       // ant dofs: free 0-5, hinges 6-13
constexpr int kNu = 8;
constexpr int kBodyDofs = 8;  // 6 free dofs + 2 hinges on a root path
constexpr int kMaxSph = 40;
constexpr int kBoxWords = 4;  // static boxes: at most 32 x kBoxWords
// A forward evaluation's trace: 8 words of active-contact bits, 8 of those
// whose sphere centre is inside its box, 8 of those whose tangent frame is
// built off the x axis, 1 of limits (bits 0-23) and support rows (24 + 2 b).
constexpr int kTraceWords = 25;
// table layouts (ops/ant_kernel.py packs them, column for column)
constexpr int kBodyCols = 20;  // parent, hinge, chain0, chain1, pos3,
                               // axis3, mass, com3, Ixx Iyy Izz Ixy Ixz Iyz
constexpr int kDofCols = 5;    // armature, damping, limited, lo, hi
constexpr int kActCols = 4;    // dof, gear, lo, hi
constexpr int kSphCols = 13;   // body, local3, radius, margin, floor margin,
                               // mu, d0, dmax, width, tc (clamped), dampr
constexpr int kBoxCols = 7;    // center3, half3, margin
constexpr int kGoalCols = 9;   // pos3, dim_mask3, threshold^2, scale, valid
constexpr int kWdofCols = 7;   // axis, mass, 1/mass, limited, lo, hi,
                               // M^-1 diagonal (the engine's rounding)
constexpr int kBlkCols = 11;   // base3, half3, first dof, dof count,
                               // falling z dof (-1), platform row, count
constexpr int kPlatCols = 5;   // x, y, half x + block half x, half y + ..., top
constexpr int kPairCols = 7;   // margin, mu, d0, dmax, width, tc, dampr
                               // (the sphere-vs-ball pairs alike)
constexpr int kBallCols = 16;  // qadr, vadr, radius, mass, com3, inertia,
                               // margin, floor margin, mu, d0, dmax, width,
                               // tc (clamped), dampr
constexpr int kBallPar = 10;   // the ball's (mu, d0, .., dampr) in its row

// A contact's row entries: the sphere body's root-path dofs, then a
// block's slide dofs (with blocks), then the ball's 6 dofs (with a ball).
template <int NBLK, int NBALL>
struct Rows {
  static constexpr int kBall = kBodyDofs + (NBLK > 0 ? 3 : 0);
  static constexpr int kR = kBall + 6 * NBALL;
};

// The compile-time maxima of one instantiation: W slide dofs, NBLK
// blocks, NBALL free balls (0 or 1; its 6 dofs follow the slides').
template <int W, int NBLK, int NBALL = 0>
struct Dims {
  static_assert(NBALL == 0 || (W == 0 && NBLK == 0 && NBALL == 1),
                "one ball, in a world without blocks");
  static constexpr int kNv = kNa + W + 6 * NBALL;
  static constexpr int kNq = kNv + 1 + NBALL;   // a quaternion per free joint
  static constexpr int kRowDofs = Rows<NBLK, NBALL>::kR;
  static constexpr int kMaxCon = kMaxSph * (3 + NBLK) + NBALL * (3 + kMaxSph);
  static_assert(kMaxCon <= 32 * 8, "trace bits");
  static_assert(kNv <= 24 && NBLK <= 4, "limit and support bits");
};

struct Kin {
  float R[kNb][9];       // row-major world rotation
  float p[kNb][3];       // world frame origin
  float c[kNb][3];       // world com
  float w[kNa][3];       // world axis of each rotational dof (3..13)
  float anc[kNa][3];     // world anchor of each rotational dof
};

// The free ball's tree, about its own origin o (its free joint's
// position): the motion subspace of its 6 dofs (linear world axes, then
// the body axes), its spatial inertia, its world sphere centre, and the
// inverse of its 6x6 mass block.
struct Ball {
  int va;                // its first dof (q index va + 1)
  float o[3];            // the tree's reference point, the body origin
  float c[3];            // the sphere centre (the com), world
  float cdof[6][6];      // [w; v] of each dof about o
  float m, h[3], I[6];   // mass, m (c - o), inertia about o (xx yy zz xy
                         // xz yz)
  float Minv[6][6];
};

template <int R>
struct Contact {         // one active contact: 3 rows (n, t1, t2)
  int body;              // the ant body of the sphere, or -1 (the ball
                         // against the static world)
  int blk;               // the moving block of the pair, or -1
  int ball;              // +1: the ball is the first body, -1: the second,
                         // 0: not in the contact
  float mu;
  float J[3][R];         // row entries on the body's dof list, then the
                         // block's dofs, then the ball's
  float rhs[3];          // aref - a0
  float rreg[3];
  float denom[3];
  float f[3];
};

struct Tables {
  const float* body;
  const float* dof;
  const float* act;
  const float* sph;
  const float* box;
  const float* goal;
  const float* qpos0;
  const float* wdof;
  const float* blk;
  const float* plat;
  const float* qpair;
  const float* ball;
  const float* bpair;
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void mat_vec3(const float* R, const float* v,
                                         float* o) {
  o[0] = R[0] * v[0] + R[1] * v[1] + R[2] * v[2];
  o[1] = R[3] * v[0] + R[4] * v[1] + R[5] * v[2];
  o[2] = R[6] * v[0] + R[7] * v[1] + R[8] * v[2];
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The dof of entry e of a body's row list: free dofs 0-5, then the hinges
// on the body's root path (-1 where the path is shorter).
__device__ __forceinline__ int row_dof(const float* body, int e) {
  return e < 6 ? e : (int)body[2 + (e - 6)];
}

// ---------------------------------------------------------------------------
// kinematics (engine.fk): torso from the free joint, hinges pre-multiply
// ---------------------------------------------------------------------------
__device__ void fk(const Tables& tb, const float* q, Kin& k) {
  {
    const float qw = q[3], qx = q[4], qy = q[5], qz = q[6];
    float* R = k.R[0];
    R[0] = 1 - 2 * (qy * qy + qz * qz);
    R[1] = 2 * (qx * qy - qw * qz);
    R[2] = 2 * (qx * qz + qw * qy);
    R[3] = 2 * (qx * qy + qw * qz);
    R[4] = 1 - 2 * (qx * qx + qz * qz);
    R[5] = 2 * (qy * qz - qw * qx);
    R[6] = 2 * (qx * qz - qw * qy);
    R[7] = 2 * (qy * qz + qw * qx);
    R[8] = 1 - 2 * (qx * qx + qy * qy);
    k.p[0][0] = q[0]; k.p[0][1] = q[1]; k.p[0][2] = q[2];
    for (int j = 0; j < 3; ++j) {  // free angular dofs: body axes
      k.w[3 + j][0] = R[j]; k.w[3 + j][1] = R[3 + j]; k.w[3 + j][2] = R[6 + j];
      k.anc[3 + j][0] = q[0]; k.anc[3 + j][1] = q[1]; k.anc[3 + j][2] = q[2];
    }
  }
#pragma unroll 1
  for (int b = 1; b < kNb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const int par = (int)row[0];
    const int hd = (int)row[1];
    float* R = k.R[b];
    float* p = k.p[b];
    const float* Rp = k.R[par];
    float off[3];
    mat_vec3(Rp, row + 4, off);
    for (int i = 0; i < 3; ++i) p[i] = k.p[par][i] + off[i];
    for (int i = 0; i < 9; ++i) R[i] = Rp[i];
    if (hd >= 0) {
      float a[3];
      mat_vec3(Rp, row + 7, a);
      // Rj = I + s K + (1 - c) K K, K = skew(a)
      const float ang = q[hd + 1];
      const float s = sinf(ang), cm = 1.f - cosf(ang);
      const float K[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0], -a[1], a[0], 0.f};
      float Rj[9];
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc) {
          const float kk = K[r * 3] * K[cc] + K[r * 3 + 1] * K[3 + cc] +
                           K[r * 3 + 2] * K[6 + cc];
          Rj[r * 3 + cc] = (r == cc ? 1.f : 0.f) + s * K[r * 3 + cc] + cm * kk;
        }
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc)
          R[r * 3 + cc] = Rj[r * 3] * Rp[cc] + Rj[r * 3 + 1] * Rp[3 + cc] +
                          Rj[r * 3 + 2] * Rp[6 + cc];
      for (int i = 0; i < 3; ++i) {
        k.w[hd][i] = a[i];
        k.anc[hd][i] = p[i];  // the joint sits at the body origin
      }
    }
  }
#pragma unroll 1
  for (int b = 0; b < kNb; ++b) {
    float cw[3];
    mat_vec3(k.R[b], tb.body + b * kBodyCols + 11, cw);
    for (int i = 0; i < 3; ++i) k.c[b][i] = k.p[b][i] + cw[i];
  }
}

// Linear (J) and angular (W) velocity basis of dof d for a point x moving
// with a body whose root path holds d.
__device__ __forceinline__ void dof_basis(const Kin& k, int d, const float* x,
                                          float* J, float* W) {
  if (d < 3) {
    W[0] = W[1] = W[2] = 0.f;
    J[0] = J[1] = J[2] = 0.f;
    J[d] = 1.f;
  } else {
    const float rel[3] = {x[0] - k.anc[d][0], x[1] - k.anc[d][1],
                          x[2] - k.anc[d][2]};
    W[0] = k.w[d][0]; W[1] = k.w[d][1]; W[2] = k.w[d][2];
    cross3(W, rel, J);
  }
}

// World inertia Iw = R Ic R^T (Ic symmetric, from the body row).
__device__ void world_inertia(const float* R, const float* row, float* Iw) {
  const float Ic[9] = {row[14], row[17], row[18], row[17], row[15], row[19],
                       row[18], row[19], row[16]};
  float T[9];
  for (int r = 0; r < 3; ++r)
    for (int cc = 0; cc < 3; ++cc)
      T[r * 3 + cc] = R[r * 3] * Ic[cc] + R[r * 3 + 1] * Ic[3 + cc] +
                      R[r * 3 + 2] * Ic[6 + cc];
  for (int r = 0; r < 3; ++r)
    for (int cc = 0; cc < 3; ++cc)
      Iw[r * 3 + cc] = T[r * 3] * R[cc * 3] + T[r * 3 + 1] * R[cc * 3 + 1] +
                       T[r * 3 + 2] * R[cc * 3 + 2];
}

// Mass matrix in Jacobian form (ant_math.mass_matrix), plus armature.
__device__ void mass_matrix(const Tables& tb, const Kin& k, float M[kNa][kNa]) {
  for (int i = 0; i < kNa; ++i)
    for (int j = 0; j < kNa; ++j) M[i][j] = 0.f;
#pragma unroll 1
  for (int b = 0; b < kNb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const float m = row[10];
    float Iw[9];
    world_inertia(k.R[b], row, Iw);
    float J[kBodyDofs][3], W[kBodyDofs][3], IW[kBodyDofs][3];
    int dof[kBodyDofs];
    int n = 0;
#pragma unroll 1
    for (int e = 0; e < kBodyDofs; ++e) {
      const int d = row_dof(row, e);
      if (d < 0) continue;
      dof[n] = d;
      dof_basis(k, d, k.c[b], J[n], W[n]);
      mat_vec3(Iw, W[n], IW[n]);
      ++n;
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i)
      for (int j = i; j < n; ++j) {
        const float term = dot3(J[i], J[j]) * m + dot3(W[j], IW[i]);
        const int lo = min(dof[i], dof[j]), hi = max(dof[i], dof[j]);
        M[lo][hi] = M[lo][hi] + term;
      }
  }
  for (int i = 0; i < kNa; ++i) {
    M[i][i] = M[i][i] + tb.dof[i * kDofCols];
    for (int j = 0; j < i; ++j) M[i][j] = M[j][i];
  }
}

// Spatial motion / force algebra in world axes about the torso origin
// ([w; v], [m; f]).
__device__ __forceinline__ void motion_cross(const float* a, const float* b,
                                             float* o) {
  float t[3];
  cross3(a, b, o);            // w x w'
  cross3(a, b + 3, o + 3);    // w x v'
  cross3(a + 3, b, t);        // v x w'
  for (int i = 0; i < 3; ++i) o[3 + i] = o[3 + i] + t[i];
}

// I_b x (alpha, a) for body b's spatial inertia about the reference
// point, c its com relative to that point:
// moment = Iw alpha - m c x (c x alpha) + m c x a, force = m (a - c x alpha)
__device__ void inertia_mul(const float* Iw, float m, const float* c,
                            const float* mot, float* out) {
  float ca[3], cca[3], cl[3], Ia[3];
  cross3(c, mot, ca);
  cross3(c, ca, cca);
  cross3(c, mot + 3, cl);
  mat_vec3(Iw, mot, Ia);
  for (int i = 0; i < 3; ++i) {
    out[i] = Ia[i] - cca[i] * m + cl[i] * m;
    out[3 + i] = (mot[3 + i] - ca[i]) * m;
  }
}

// The motion subspace (cdof) of dof d about the torso origin p0:
// [w; (anchor - p0) x w], or [0; e_d].
__device__ __forceinline__ void cdof(const Kin& k, int d, float* s) {
  if (d < 3) {
    for (int i = 0; i < 6; ++i) s[i] = 0.f;
    s[3 + d] = 1.f;
  } else {
    const float rel[3] = {k.anc[d][0] - k.p[0][0], k.anc[d][1] - k.p[0][1],
                          k.anc[d][2] - k.p[0][2]};
    for (int i = 0; i < 3; ++i) s[i] = k.w[d][i];
    cross3(rel, k.w[d], s + 3);
  }
}

// qfrc_bias = C(q, v) v + gravity by RNE in world axes about the torso
// origin p0 (engine.rne_bias, which takes the same reference point).
__device__ void rne_bias(const Tables& tb, const AntParams& P, const Kin& k,
                         const float* v, float* bias) {
  float vel[kNb][6], acc[kNb][6], frc[kNb][6];
  // torso: free dofs in order; angular cdofdot uses the full torso velocity
  {
    float s[6];
    for (int i = 0; i < 6; ++i) vel[0][i] = 0.f;
    for (int d = 0; d < 6; ++d) {
      cdof(k, d, s);
      for (int i = 0; i < 6; ++i) vel[0][i] = vel[0][i] + s[i] * v[d];
    }
    for (int i = 0; i < 6; ++i) acc[0][i] = 0.f;
    acc[0][5] = P.gravity;
    for (int d = 3; d < 6; ++d) {
      float sd[6];
      cdof(k, d, s);
      motion_cross(vel[0], s, sd);
      for (int i = 0; i < 6; ++i) acc[0][i] = acc[0][i] + sd[i] * v[d];
    }
  }
#pragma unroll 1
  for (int b = 1; b < kNb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const int par = (int)row[0];
    const int hd = (int)row[1];
    for (int i = 0; i < 6; ++i) {
      vel[b][i] = vel[par][i];
      acc[b][i] = acc[par][i];
    }
    if (hd >= 0) {
      float s[6], sd[6];
      cdof(k, hd, s);
      motion_cross(vel[par], s, sd);  // velocity before the joint
      for (int i = 0; i < 6; ++i) {
        acc[b][i] = acc[b][i] + sd[i] * v[hd];
        vel[b][i] = vel[b][i] + s[i] * v[hd];
      }
    }
  }
#pragma unroll 1
  for (int b = 0; b < kNb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const float crel[3] = {k.c[b][0] - k.p[0][0], k.c[b][1] - k.p[0][1],
                           k.c[b][2] - k.p[0][2]};
    float Iw[9], Ia[6], Iv[6], t[3];
    world_inertia(k.R[b], row, Iw);
    inertia_mul(Iw, row[10], crel, acc[b], Ia);
    inertia_mul(Iw, row[10], crel, vel[b], Iv);
    // v x* (I v) = [w x m + v x f; w x f]
    float fx[6];
    cross3(vel[b], Iv, fx);
    cross3(vel[b] + 3, Iv + 3, t);
    for (int i = 0; i < 3; ++i) fx[i] = fx[i] + t[i];
    cross3(vel[b], Iv + 3, fx + 3);
    for (int i = 0; i < 6; ++i) frc[b][i] = Ia[i] + fx[i];
  }
  // subtree sums: children come after their parents in the body order
#pragma unroll 1
  for (int b = kNb - 1; b >= 1; --b) {
    const int par = (int)tb.body[b * kBodyCols];
    for (int i = 0; i < 6; ++i) frc[par][i] = frc[par][i] + frc[b][i];
  }
  float s[6];
  for (int d = 0; d < 6; ++d) {
    cdof(k, d, s);
    bias[d] = dot3(s, frc[0]) + dot3(s + 3, frc[0] + 3);
  }
#pragma unroll 1
  for (int b = 1; b < kNb; ++b) {
    const int hd = (int)tb.body[b * kBodyCols + 1];
    if (hd < 0) continue;
    cdof(k, hd, s);
    bias[hd] = dot3(s, frc[b]) + dot3(s + 3, frc[b] + 3);
  }
}

// Minv = M^-1 by the Cholesky factor (linalg.spd_inverse): M is
// overwritten with L.  N = 14 for the ant, 6 for the ball.
template <int N>
__device__ void spd_inverse(float M[N][N], float Minv[N][N]) {
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    for (int i = j; i < N; ++i) {
      float s = M[i][j];
      for (int kk = 0; kk < j; ++kk) s = s - M[i][kk] * M[j][kk];
      M[i][j] = s;  // provisional: divided by the pivot below
    }
    const float d = sqrtf(fmaxf(M[j][j], 1e-12f));
    for (int i = j; i < N; ++i) M[i][j] = M[i][j] / d;
  }
  // forward substitution L Y = I, then back substitution L^T X = Y
#pragma unroll 1
  for (int c = 0; c < N; ++c) {
    for (int i = 0; i < N; ++i) {
      float acc = i == c ? 1.f : 0.f;
      for (int kk = 0; kk < i; ++kk) acc = acc - M[i][kk] * Minv[kk][c];
      Minv[i][c] = acc / M[i][i];
    }
    for (int i = N - 1; i >= 0; --i) {
      float acc = Minv[i][c];
      for (int kk = i + 1; kk < N; ++kk) acc = acc - M[kk][i] * Minv[kk][c];
      Minv[i][c] = acc / M[i][i];
    }
  }
}

__device__ __forceinline__ void minv_mul(const float Minv[kNa][kNa],
                                         const float* x, float* y) {
  for (int i = 0; i < kNa; ++i) {
    float s = 0.f;
    for (int j = 0; j < kNa; ++j) s = s + Minv[i][j] * x[j];
    y[i] = s;
  }
}

// ---------------------------------------------------------------------------
// the free ball's tree (engine.kin_dyn, crb_mass_matrix, rne_bias on its
// six dofs), about its own origin
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] +
         a[4] * b[4] + a[5] * b[5];
}

__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

// The ball's spatial inertia times a motion s = [w; v] about its origin:
// [Io w + h x v; m v - h x w].
__device__ __forceinline__ void ball_inertia_mul(const Ball& bl,
                                                 const float* s, float* out) {
  const float* w = s;
  const float* v = s + 3;
  float hv[3], hw[3];
  cross3(bl.h, v, hv);
  cross3(bl.h, w, hw);
  out[0] = bl.I[0] * w[0] + bl.I[3] * w[1] + bl.I[4] * w[2] + hv[0];
  out[1] = bl.I[3] * w[0] + bl.I[1] * w[1] + bl.I[5] * w[2] + hv[1];
  out[2] = bl.I[4] * w[0] + bl.I[5] * w[1] + bl.I[2] * w[2] + hv[2];
  for (int i = 0; i < 3; ++i) out[3 + i] = bl.m * v[i] - hw[i];
}

// The ball's pose, motion subspace and spatial inertia about its origin
// o, its bias (gravity and velocity products, into bias[va..va + 5]) and
// the inverse of its 6x6 mass block.  Its free joint's linear dofs move
// along the world axes, its angular dofs turn about the body axes through
// o; the sphere sits at the body-frame com.
__device__ void ball_dynamics(const Tables& tb, const AntParams& P,
                              const float* q, const float* v, Ball& bl,
                              float* bias) {
  const float* row = tb.ball;
  const int qa = (int)row[0];
  const int va = (int)row[1];
  bl.va = va;
  for (int i = 0; i < 3; ++i) bl.o[i] = q[qa + i];
  float R[9], off[3];
  quat_to_mat(q + qa + 3, R);
  mat_vec3(R, row + 4, off);
  for (int i = 0; i < 3; ++i) bl.c[i] = bl.o[i] + off[i];
  for (int kk = 0; kk < 3; ++kk) {
    for (int i = 0; i < 6; ++i) {
      bl.cdof[kk][i] = 0.f;
      bl.cdof[3 + kk][i] = 0.f;
    }
    bl.cdof[kk][3 + kk] = 1.f;
    for (int i = 0; i < 3; ++i) bl.cdof[3 + kk][i] = R[i * 3 + kk];
  }
  // the isotropic inertia about the com, moved to o: Ic + m (|c|^2 1 - c c^T)
  const float m = row[3], Ic = row[7];
  const float c[3] = {bl.c[0] - bl.o[0], bl.c[1] - bl.o[1],
                      bl.c[2] - bl.o[2]};
  bl.m = m;
  for (int i = 0; i < 3; ++i) bl.h[i] = m * c[i];
  bl.I[0] = Ic + m * (c[1] * c[1] + c[2] * c[2]);
  bl.I[1] = Ic + m * (c[0] * c[0] + c[2] * c[2]);
  bl.I[2] = Ic + m * (c[0] * c[0] + c[1] * c[1]);
  bl.I[3] = -(m * (c[0] * c[1]));
  bl.I[4] = -(m * (c[0] * c[2]));
  bl.I[5] = -(m * (c[1] * c[2]));
  // its velocity; the body axes turn with the full velocity (cdof_dot)
  float vel[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < 6; ++d)
    for (int i = 0; i < 6; ++i) vel[i] = vel[i] + bl.cdof[d][i] * v[va + d];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, P.gravity};
  for (int d = 3; d < 6; ++d) {
    float sd[6];
    motion_cross(vel, bl.cdof[d], sd);
    for (int i = 0; i < 6; ++i) acc[i] = acc[i] + sd[i] * v[va + d];
  }
  // f = I a + v x* (I v); bias = cdof . f
  float Ia[6], Iv[6], fx[6], t[3], f[6];
  ball_inertia_mul(bl, acc, Ia);
  ball_inertia_mul(bl, vel, Iv);
  cross3(vel, Iv, fx);
  cross3(vel + 3, Iv + 3, t);
  for (int i = 0; i < 3; ++i) fx[i] = fx[i] + t[i];
  cross3(vel, Iv + 3, fx + 3);
  for (int i = 0; i < 6; ++i) f[i] = Ia[i] + fx[i];
  for (int d = 0; d < 6; ++d) bias[va + d] = dot6(bl.cdof[d], f);
  // M = (I s_a) . s_b over the tree, then its inverse
  float M[6][6];
#pragma unroll 1
  for (int a = 0; a < 6; ++a) {
    float F[6];
    ball_inertia_mul(bl, bl.cdof[a], F);
    for (int b = 0; b <= a; ++b) {
      const float x = dot6(F, bl.cdof[b]);
      M[a][b] = x;
      M[b][a] = x;
    }
  }
  spd_inverse<6>(M, bl.Minv);
}

// Sphere vs an axis-aligned box bx = (center3, half3) (contact.py
// contact_qfrc): signed distance, world contact point and normal.
__device__ void sphere_box(const float* c, float r, const float* bx,
                           float* dist, float* pos, float* n, bool* inside) {
  float local[3], cl[3], delta[3];
  for (int i = 0; i < 3; ++i) {
    local[i] = c[i] - bx[i];
    cl[i] = fmaxf(fminf(local[i], bx[3 + i]), -bx[3 + i]);
    delta[i] = local[i] - cl[i];
  }
  const float d_out = sqrtf(delta[0] * delta[0] + delta[1] * delta[1] +
                            delta[2] * delta[2] + 1e-12f);
  const bool outside = d_out > 1e-6f;
  const float ex = bx[3] - fabsf(local[0]);
  const float ey = bx[4] - fabsf(local[1]);
  const float ez = bx[5] - fabsf(local[2]);
  const float mmin = fminf(fminf(ex, ey), ez);
  const bool is_x = ex <= fminf(ey, ez);
  const bool is_y = !is_x && ey <= ez;
  const bool is_z = !is_x && !is_y;
  const float nin[3] = {is_x ? (local[0] >= 0.f ? 1.f : -1.f) : 0.f,
                        is_y ? (local[1] >= 0.f ? 1.f : -1.f) : 0.f,
                        is_z ? (local[2] >= 0.f ? 1.f : -1.f) : 0.f};
  const float pen_in = -mmin;
  *inside = !outside;
  *dist = outside ? d_out - r : pen_in - r;
  for (int i = 0; i < 3; ++i) {
    n[i] = outside ? delta[i] / d_out : nin[i];
    pos[i] = bx[i] + (outside ? cl[i] : local[i] - nin[i] * pen_in);
  }
}

// The two nearest static boxes of a sphere by dist - box margin (strict
// <: the first of equal keys wins); a pick no box filled stays at an
// infinite distance, never active.
struct Nearest2 {
  float e[2] = {INFINITY, INFINITY}, d[2] = {INFINITY, INFINITY};
  float p[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float n[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float m[2] = {0.f, 0.f};
  bool in[2] = {false, false};

  __device__ __forceinline__ void test(const float* c, float r,
                                       const float* bx) {
    float dist, pos[3], nn[3];
    bool inside;
    sphere_box(c, r, bx, &dist, pos, nn, &inside);
    const float ee = dist - bx[6];
    const bool b1 = ee < e[0];
    const bool b2 = !b1 && ee < e[1];
    if (b1) {
      e[1] = e[0]; d[1] = d[0]; m[1] = m[0];
      in[1] = in[0];
      for (int i = 0; i < 3; ++i) {
        p[1][i] = p[0][i];
        n[1][i] = n[0][i];
      }
      e[0] = ee; d[0] = dist; m[0] = bx[6];
      in[0] = inside;
      for (int i = 0; i < 3; ++i) {
        p[0][i] = pos[i];
        n[0][i] = nn[i];
      }
    } else if (b2) {
      e[1] = ee; d[1] = dist; m[1] = bx[6];
      in[1] = inside;
      for (int i = 0; i < 3; ++i) {
        p[1][i] = pos[i];
        n[1][i] = nn[i];
      }
    }
  }
};

// Minv[i][j] over the block-diagonal structure: the ant's 14x14 inverse,
// then the diagonal 1/mass of the slide dofs, or the ball's 6x6 inverse.
template <int NBALL>
__device__ __forceinline__ float minv_at(const Tables& tb,
                                         const float Minv[kNa][kNa],
                                         const Ball* bl, int i, int j) {
  if (i < kNa && j < kNa) return Minv[i][j];
  if constexpr (NBALL > 0) {
    const int va = bl->va;
    return i >= va && j >= va ? bl->Minv[i - va][j - va] : 0.f;
  } else {
    if (i == j) return tb.wdof[(i - kNa) * kWdofCols + 6];
    return 0.f;
  }
}

// y = Minv x over the ant's and the slides' ns dofs, and the ball's six.
template <int NBALL>
__device__ void minv_mul_all(const Tables& tb, const float Minv[kNa][kNa],
                             const Ball* bl, int ns, const float* x,
                             float* y) {
  minv_mul(Minv, x, y);
  for (int d = kNa; d < ns; ++d) y[d] = tb.wdof[(d - kNa) * kWdofCols + 6] * x[d];
  if constexpr (NBALL > 0) {
    const int va = bl->va;
    for (int i = 0; i < 6; ++i) {
      float s = 0.f;
      for (int j = 0; j < 6; ++j) s = s + bl->Minv[i][j] * x[va + j];
      y[va + i] = s;
    }
  }
}

// The dof of entry e of a contact's row list: the sphere body's root-path
// dofs, then the block's slide dofs, then the ball's six (-1 where there
// are fewer, or where that body is not in the contact).
template <int NBLK, int NBALL, int R>
__device__ __forceinline__ int con_dof(const Tables& tb, const Contact<R>& ct,
                                       int e) {
  if (e < kBodyDofs) {
    if constexpr (NBALL > 0) {
      if (ct.body < 0) return -1;
    }
    return row_dof(tb.body + ct.body * kBodyCols, e);
  }
  if constexpr (NBALL > 0) {
    constexpr int kBall = Rows<NBLK, NBALL>::kBall;
    if (e >= kBall) return ct.ball ? (int)tb.ball[1] + (e - kBall) : -1;
  }
  if (ct.blk < 0) return -1;
  const float* br = tb.blk + ct.blk * kBlkCols;
  const int k = e - kBodyDofs;
  return k < (int)br[7] ? (int)br[6] + k : -1;
}

// Append one active contact: its three rows on the contact's dof list, the
// impedance constants, A = J Minv J^T, aref - a0, R and the denominator
// (contact.py contact_qfrc, row by row).  par = (mu, d0, dmax, width, tc,
// dampr) of the sphere, of the sphere-block or sphere-ball pair, or of the
// ball.  body: the sphere's ant body (-1: none); blk: the pair's block
// (-1: none); ball: +1 if the ball is the contact's first body, -1 if its
// second, 0 if it is not in it.
template <int NBLK, int NBALL>
__device__ void add_contact(const Tables& tb, const Kin& k,
                            const float Minv[kNa][kNa], const Ball* bl,
                            const float* v, const float* qacc0,
                            const float* par, int body, int blk, int ball,
                            const float* pos, const float* nrm, float dist,
                            float margin,
                            Contact<Rows<NBLK, NBALL>::kR>& ct) {
  constexpr int R = Rows<NBLK, NBALL>::kR;
  const float mu = par[0], d0 = par[1], dmax = par[2], width = par[3];
  const float tc = par[4], dampr = par[5];
  ct.body = body;
  ct.blk = blk;
  ct.ball = ball;
  ct.mu = mu;
  // tangent frame: reference x if |n.x| < 0.5, else y
  const bool use_x = fabsf(nrm[0]) < 0.5f;
  const float ref[3] = {use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f};
  float t1[3], t2[3];
  cross3(nrm, ref, t1);
  const float tn = sqrtf(dot3(t1, t1) + 1e-12f);
  for (int i = 0; i < 3; ++i) t1[i] = t1[i] / tn;
  cross3(nrm, t1, t2);
  const float* dirs[3] = {nrm, t1, t2};
  // the ball's columns: [(x - o) x dir; dir] . cdof, about its origin o
  float Fb[3][6];
  if constexpr (NBALL > 0) {
    if (ball) {
      const float rel[3] = {pos[0] - bl->o[0], pos[1] - bl->o[1],
                            pos[2] - bl->o[2]};
      for (int r = 0; r < 3; ++r) {
        cross3(rel, dirs[r], Fb[r]);
        for (int i = 0; i < 3; ++i) Fb[r][3 + i] = dirs[r][i];
      }
    }
  }
  int dof[R];
  for (int e = 0; e < R; ++e) {
    const int d = con_dof<NBLK, NBALL>(tb, ct, e);
    dof[e] = d;
    if (e < kBodyDofs) {
      float J[3], W[3];
      if (d >= 0) dof_basis(k, d, pos, J, W);
      for (int r = 0; r < 3; ++r) ct.J[r][e] = d >= 0 ? dot3(J, dirs[r]) : 0.f;
    } else if constexpr (NBALL > 0) {
      // the ball's entries (a ball world has no blocks): + as the
      // contact's first body, - as its second
      for (int r = 0; r < 3; ++r) {
        float x = 0.f;
        if (d >= 0) {
          x = dot6(Fb[r], bl->cdof[d - bl->va]);
          if (ball < 0) x = -x;
        }
        ct.J[r][e] = x;
      }
    } else {
      // the block is the contact's second body: a slide moves its box
      // along its axis, so the row's entry is -dir[axis]
      const int ax = d >= 0 ? (int)tb.wdof[(d - kNa) * kWdofCols] : 0;
      for (int r = 0; r < 3; ++r) ct.J[r][e] = d >= 0 ? -dirs[r][ax] : 0.f;
    }
  }
  const float r = dist - margin;
  const float b_imp = 2.f / (dmax * tc);
  const float imp = d0 + (dmax - d0) * clampf(-r / width, 0.f, 1.f);
  const float k_imp = imp / (dmax * dmax * tc * tc * dampr * dampr);
  const float rfac = (1.f - imp) / fmaxf(imp, 1e-6f);
#pragma unroll 1
  for (int rr = 0; rr < 3; ++rr) {
    const float* J = ct.J[rr];
    float A = 0.f, vr = 0.f, ar = 0.f;
    for (int i = 0; i < R; ++i) {
      if (dof[i] < 0) continue;
      float s = 0.f;
      for (int j = 0; j < R; ++j)
        if (dof[j] >= 0)
          s = s + J[j] * minv_at<NBALL>(tb, Minv, bl, dof[j], dof[i]);
      A = A + s * J[i];
      vr = vr + J[i] * v[dof[i]];
      ar = ar + J[i] * qacc0[dof[i]];
    }
    const float aref = rr == 0 ? -b_imp * vr - k_imp * r : -b_imp * vr;
    ct.rhs[rr] = aref - ar;
    ct.rreg[rr] = rfac * A;
    ct.denom[rr] = A + ct.rreg[rr] + 1e-9f;
  }
}

// Friction-cone projection of one contact's (f_n, f_t1, f_t2).
template <int R>
__device__ __forceinline__ void project(Contact<R>& ct) {
  const float fn = fmaxf(ct.f[0], 0.f);
  const float ftn = sqrtf(ct.f[1] * ct.f[1] + ct.f[2] * ct.f[2] + 1e-12f);
  const float scale = fminf(ct.mu * fn / ftn, 1.f);
  ct.f[0] = fn;
  ct.f[1] = ct.f[1] * scale;
  ct.f[2] = ct.f[2] * scale;
}

// J^T f of one contact, added into x (nv).
template <int NBLK, int NBALL, int R>
__device__ __forceinline__ void add_jt_f(const Tables& tb,
                                         const Contact<R>& ct, float* x) {
  for (int e = 0; e < R; ++e) {
    const int d = con_dof<NBLK, NBALL>(tb, ct, e);
    if (d < 0) continue;
    x[d] = x[d] + (ct.J[0][e] * ct.f[0] + ct.J[1][e] * ct.f[1] +
                   ct.J[2][e] * ct.f[2]);
  }
}

// The trace bits of one active contact (bit kind * n_sph + sphere): active,
// centre inside its box, tangent frame off the x axis.
__device__ __forceinline__ void mark(int* trace, int bit, bool inside,
                                     const float* n) {
  if (!trace) return;
  const int w = bit >> 5;
  const int m = (int)(1u << (bit & 31));
  trace[w] |= m;
  if (inside) trace[8 + w] |= m;
  if (fabsf(n[0]) < 0.5f) trace[16 + w] |= m;
}

// Contact detection, compacted active list and the projected-Jacobi
// solve; adds the contact force into fcon.  bc holds each block's box
// (center3, half3), bl the ball's tree.  Sets the trace bits of the
// active contacts (``mark``; kind 0 the floor, 1-2 the first and second
// static-box pick, 3 + b block b, bit kind * S + sphere; then, from
// (3 + blocks) * S, the ball against the floor, its first and second box
// pick, then each sphere against the ball) when trace is not null.
// Returns the active count.
template <int W, int NBLK, int NBALL>
__device__ int contact_force(const Tables& tb, const AntParams& P,
                             const Kin& k, const float Minv[kNa][kNa],
                             const Ball* bl, const float* v,
                             const float* qacc0, const float (*bc)[6],
                             float* fcon,
                             Contact<Dims<W, NBLK, NBALL>::kRowDofs>* con,
                             int* trace) {
  constexpr int R = Dims<W, NBLK, NBALL>::kRowDofs;
  const int ns = kNa + P.n_w;
  const int nv = ns + 6 * NBALL;
  // the static boxes within reach of the torso, as a bit set
  uint32_t near[kBoxWords];
  for (int w = 0; w < kBoxWords; ++w) near[w] = 0u;
#pragma unroll 1
  for (int b = 0; b < P.n_box; ++b) {
    const float* bx = tb.box + b * kBoxCols;
    float d = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float di = fmaxf(fabsf(k.p[0][i] - bx[i]) - bx[3 + i], 0.f);
      d = d + di * di;
    }
    if (d <= P.reach2) near[b >> 5] |= 1u << (b & 31);
  }
  int nc = 0;
  const int S = P.n_sph;
  const int ball_bit = (3 + P.n_blk) * S;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const float* sp = tb.sph + s * kSphCols;
    const int body = (int)sp[0];
    float c[3];
    mat_vec3(k.R[body], sp + 1, c);
    for (int i = 0; i < 3; ++i) c[i] = k.p[body][i] + c[i];
    const float r = sp[4];
    {  // floor plane z = 0
      const float dist = c[2] - r;
      if (dist < sp[6]) {
        const float pos[3] = {c[0], c[1], c[2] - r};
        const float up[3] = {0.f, 0.f, 1.f};
        mark(trace, s, false, up);
        add_contact<NBLK, NBALL>(tb, k, Minv, bl, v, qacc0, sp + 7, body, -1,
                                 0, pos, up, dist, sp[6], con[nc++]);
      }
    }
    // the two nearest boxes within reach
    Nearest2 pick;
#pragma unroll 1
    for (int w = 0; w < kBoxWords; ++w) {
      uint32_t m = near[w];
#pragma unroll 1
      while (m) {
        const int b = (w << 5) + __ffs(m) - 1;
        m &= m - 1u;
        pick.test(c, r, tb.box + b * kBoxCols);
      }
    }
    for (int j = 0; j < 2; ++j) {
      const float margin = sp[5] + pick.m[j];
      if (pick.d[j] < margin) {
        mark(trace, (1 + j) * S + s, pick.in[j], pick.n[j]);
        add_contact<NBLK, NBALL>(tb, k, Minv, bl, v, qacc0, sp + 7, body, -1,
                                 0, pick.p[j], pick.n[j], pick.d[j], margin,
                                 con[nc++]);
      }
    }
    // every movable block (the box frame is the world's: slides only)
#pragma unroll 1
    for (int b = 0; b < P.n_blk; ++b) {
      const float* pr = tb.qpair + (b * S + s) * kPairCols;
      float dist, pos[3], n[3];
      bool inside;
      sphere_box(c, r, bc[b], &dist, pos, n, &inside);
      if (dist < pr[0]) {
        mark(trace, (3 + b) * S + s, inside, n);
        add_contact<NBLK, NBALL>(tb, k, Minv, bl, v, qacc0, pr + 1, body, b,
                                 0, pos, n, dist, pr[0], con[nc++]);
      }
    }
    // the ball, the pair's second body: the normal from its centre to the
    // sphere's, the point midway through the overlap
    if constexpr (NBALL > 0) {
      const float* pr = tb.bpair + s * kPairCols;
      const float rb = tb.ball[2];
      const float d[3] = {c[0] - bl->c[0], c[1] - bl->c[1], c[2] - bl->c[2]};
      const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12f);
      const float n[3] = {d[0] / dn, d[1] / dn, d[2] / dn};
      const float dist = dn - (r + rb);
      if (dist < pr[0]) {
        const float reach = rb + dist * 0.5f;
        const float pos[3] = {bl->c[0] + n[0] * reach, bl->c[1] + n[1] * reach,
                              bl->c[2] + n[2] * reach};
        mark(trace, ball_bit + 3 + s, false, n);
        add_contact<NBLK, NBALL>(tb, k, Minv, bl, v, qacc0, pr + 1, body, -1,
                                 -1, pos, n, dist, pr[0], con[nc++]);
      }
    }
  }
  // the ball against the floor and the two nearest of all static boxes
  if constexpr (NBALL > 0) {
    const float* br = tb.ball;
    const float* c = bl->c;
    const float rb = br[2];
    const float dist = c[2] - rb;
    if (dist < br[9]) {
      const float pos[3] = {c[0], c[1], c[2] - rb};
      const float up[3] = {0.f, 0.f, 1.f};
      mark(trace, ball_bit, false, up);
      add_contact<NBLK, NBALL>(tb, k, Minv, bl, v, qacc0, br + kBallPar, -1,
                               -1, 1, pos, up, dist, br[9], con[nc++]);
    }
    Nearest2 pick;
#pragma unroll 1
    for (int b = 0; b < P.n_box; ++b) pick.test(c, rb, tb.box + b * kBoxCols);
    for (int j = 0; j < 2; ++j) {
      const float margin = br[8] + pick.m[j];
      if (pick.d[j] < margin) {
        mark(trace, ball_bit + 1 + j, pick.in[j], pick.n[j]);
        add_contact<NBLK, NBALL>(tb, k, Minv, bl, v, qacc0, br + kBallPar, -1,
                                 -1, 1, pick.p[j], pick.n[j], pick.d[j],
                                 margin, con[nc++]);
      }
    }
  }
  if (nc == 0) return 0;
  // projected Jacobi on (A + R) f = aref - a0, all rows in parallel
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    for (int r = 0; r < 3; ++r) con[i].f[r] = con[i].rhs[r] / con[i].denom[r];
    project(con[i]);
  }
#pragma unroll 1
  for (int it = 0; it < P.solver_iters; ++it) {
    float x[Dims<W, NBLK, NBALL>::kNv], y[Dims<W, NBLK, NBALL>::kNv];
    for (int d = 0; d < nv; ++d) x[d] = 0.f;
#pragma unroll 1
    for (int i = 0; i < nc; ++i) add_jt_f<NBLK, NBALL>(tb, con[i], x);
    minv_mul_all<NBALL>(tb, Minv, bl, ns, x, y);
#pragma unroll 1
    for (int i = 0; i < nc; ++i) {
      Contact<R>& ct = con[i];
      float af[3] = {0.f, 0.f, 0.f};
      for (int e = 0; e < R; ++e) {
        const int d = con_dof<NBLK, NBALL>(tb, ct, e);
        if (d < 0) continue;
        for (int r = 0; r < 3; ++r) af[r] = af[r] + ct.J[r][e] * y[d];
      }
      for (int r = 0; r < 3; ++r) {
        const float resid = ct.rhs[r] - af[r] - ct.rreg[r] * ct.f[r];
        ct.f[r] = ct.f[r] + P.omega * resid / ct.denom[r];
      }
      project(ct);
    }
  }
#pragma unroll 1
  for (int i = 0; i < nc; ++i) add_jt_f<NBLK, NBALL>(tb, con[i], fcon);
  return nc;
}

// The falling blocks' coupled platform support and z limit
// (contact.py falling_support_force): the net force on the z dof.  z: the
// slide's value; bottom: the box's bottom; s: the support target; w: the
// dof's inverse mass; a0: its smooth acceleration.  *rows: which rows the
// solve takes (0 neither, 1 the platform's, 2 the limit's, 3 both).
__device__ float falling_support(const AntParams& P, float z, float bottom,
                                 float s, float vz, float a0, float w,
                                 int* rows) {
  // mu = 1, the limit's margin 0.01, solimp (0.995, 0.995) for the
  // platform rows and (0.9, 0.95, 0.001) for the limit
  const float pen_c = s - bottom;
  const float aref_c = -P.sup_bc * vz + P.sup_kc * pen_c;
  const float R_c = (float)((1.0 - 0.995) / 0.995 * (2.0 * (1.0 + 1.0))) *
                    w / 16.f;
  const bool act_c = pen_c > 0.f;
  const float pen_l = z + 0.01f;
  const float x = clampf(pen_l / 0.001f, 0.f, 1.f);
  const float y = x < 0.5f ? 2.f * x * x : 1.f - 2.f * (1.f - x) * (1.f - x);
  const float d_l = 0.9f + y * 0.05f;
  const float k_l = d_l / P.sup_kl_den;
  const float aref_l = P.sup_bl * vz + k_l * pen_l;
  const float R_l = ((1.f - d_l) / d_l) * w;
  const bool act_l = pen_l > 0.f;
  const float qa_both = (a0 + w * aref_c / R_c - w * aref_l / R_l) /
                        (1.f + w / R_c + w / R_l);
  const float qa_c = (a0 + w * aref_c / R_c) / (1.f + w / R_c);
  const float qa_l = (a0 - w * aref_l / R_l) / (1.f + w / R_l);
  const float fc_both = (aref_c - qa_both) / R_c;
  const float fl_both = (aref_l + qa_both) / R_l;
  const float fc_only = (aref_c - qa_c) / R_c;
  const float fl_only = (aref_l + qa_l) / R_l;
  const bool use_c = act_c && fc_only > 0.f;
  const bool use_l = act_l && fl_only > 0.f;
  const bool both = use_c && use_l && fc_both > 0.f && fl_both > 0.f;
  *rows = both ? 3 : (use_c ? 1 : (use_l ? 2 : 0));
  return both ? fc_both - fl_both
              : (use_c ? fmaxf(fc_only, 0.f)
                       : (use_l ? -fmaxf(fl_only, 0.f) : 0.f));
}

// One joint-limit row (engine.limit_force): the force on dof d from its
// upper, then its lower limit.
__device__ __forceinline__ float limit_force(const AntParams& P, float qd,
                                             float vd, float a0, float m_eff,
                                             float lo, float hi, bool* on) {
  float f = 0.f;
  for (int side = 0; side < 2; ++side) {
    const float sign = side == 0 ? 1.f : -1.f;
    const float viol = side == 0 ? fmaxf(qd - hi, 0.f) : fmaxf(lo - qd, 0.f);
    const float dimp =
        P.lim_d0 + P.lim_dd * clampf(viol / P.lim_width, 0.f, 1.f);
    const float kimp = dimp / P.lim_kden;
    const float aref = -P.lim_b * (sign * vd) - kimp * viol;
    const float f_out = fminf(m_eff * dimp * (aref - sign * a0), 0.f);
    f = f + (viol > 0.f ? sign * f_out : 0.f);
    *on = *on || viol > 0.f;
  }
  return f;
}

// qacc of one forward-dynamics evaluation (engine.forward with the contact
// and support forces).  Adds the active-contact count to *n_active; fills
// this evaluation's trace words when trace is not null.
template <int W, int NBLK, int NBALL>
__device__ void forward(const Tables& tb, const AntParams& P, const float* q,
                        const float* v, const float* ctrl, float* qacc,
                        int* n_active, int* trace) {
  constexpr int kNv = Dims<W, NBLK, NBALL>::kNv;
  const int ns = kNa + P.n_w;         // the ant's and the slides' dofs
  const int nv = ns + 6 * NBALL;
  Kin k;
  fk(tb, q, k);
  float M[kNa][kNa], Minv[kNa][kNa];
  mass_matrix(tb, k, M);
  float bias[kNv], tau[kNv];
  rne_bias(tb, P, k, v, bias);
  for (int d = 0; d < kNv; ++d) tau[d] = 0.f;
  for (int u = 0; u < kNu; ++u) {
    const float* a = tb.act + u * kActCols;
    const int d = (int)a[0];
    tau[d] = tau[d] + a[1] * clampf(ctrl[u], a[2], a[3]);
  }
  for (int d = 0; d < kNa; ++d)
    tau[d] = tau[d] - tb.dof[d * kDofCols + 1] * v[d];
  // world dofs: gravity on the z slides (pure translation: no velocity
  // products), no actuation or damping
  for (int d = kNa; d < ns; ++d) {
    const float* wr = tb.wdof + (d - kNa) * kWdofCols;
    bias[d] = (int)wr[0] == 2 ? wr[1] * P.gravity : 0.f;
  }
  // the ball's tree: its bias and its 6x6 block's inverse (no actuation,
  // damping or limits)
  Ball ball;
  const Ball* bl = nullptr;
  if constexpr (NBALL > 0) {
    ball_dynamics(tb, P, q, v, ball, bias);
    bl = &ball;
  }
  spd_inverse(M, Minv);
  float rhs[kNv], qacc0[kNv], fcon[kNv];
  for (int d = 0; d < nv; ++d) {
    rhs[d] = tau[d] - bias[d];
    fcon[d] = 0.f;
  }
  minv_mul_all<NBALL>(tb, Minv, bl, ns, rhs, qacc0);
  // joint limits: the hinges, then the limited slides
  uint32_t lim_bits = 0u;
#pragma unroll 1
  for (int d = 6; d < ns; ++d) {
    float m_eff, lo, hi;
    if (d < kNa) {
      const float* dr = tb.dof + d * kDofCols;
      if (dr[2] == 0.f) continue;
      m_eff = 1.f / fmaxf(Minv[d][d], 1e-12f);
      lo = dr[3];
      hi = dr[4];
    } else {
      const float* wr = tb.wdof + (d - kNa) * kWdofCols;
      if (wr[3] == 0.f) continue;
      m_eff = 1.f / fmaxf(wr[6], 1e-12f);
      lo = wr[4];
      hi = wr[5];
    }
    bool on = false;
    fcon[d] = fcon[d] + limit_force(P, q[d + 1], v[d], qacc0[d], m_eff, lo,
                                    hi, &on);
    if (on) lim_bits |= 1u << d;
  }
  // the blocks' boxes
  float bc[NBLK > 0 ? NBLK : 1][6];
#pragma unroll 1
  for (int b = 0; b < P.n_blk; ++b) {
    const float* br = tb.blk + b * kBlkCols;
    for (int i = 0; i < 6; ++i) bc[b][i] = br[i];
    for (int j = 0; j < (int)br[7]; ++j) {
      const int d = (int)br[6] + j;
      const int ax = (int)tb.wdof[(d - kNa) * kWdofCols];
      bc[b][ax] = bc[b][ax] + q[d + 1];
    }
  }
  if (trace)
    for (int w = 0; w < kTraceWords; ++w) trace[w] = 0;
  Contact<Dims<W, NBLK, NBALL>::kRowDofs> con[Dims<W, NBLK, NBALL>::kMaxCon];
  *n_active += contact_force<W, NBLK, NBALL>(tb, P, k, Minv, bl, v, qacc0, bc,
                                             fcon, con, trace);
  if (trace) trace[kTraceWords - 1] = (int)lim_bits;
  // falling blocks: the coupled support, against the highest platform top
  // the block's center overlaps (else the floor, z = 0)
#pragma unroll 1
  for (int b = 0; b < P.n_blk; ++b) {
    const float* br = tb.blk + b * kBlkCols;
    const int zd = (int)br[8];
    if (zd < 0) continue;
    // z as the engine reads it off the block's world origin
    const float z = (br[2] + q[zd + 1]) - br[2];
    const float bottom = br[2] + z - br[5];
    float s = 0.f;
    for (int pi = 0; pi < (int)br[10]; ++pi) {
      const float* pl = tb.plat + ((int)br[9] + pi) * kPlatCols;
      const bool over = fabsf(bc[b][0] - pl[0]) < pl[2] &&
                        fabsf(bc[b][1] - pl[1]) < pl[3];
      s = fmaxf(s, over ? pl[4] : 0.f);
    }
    const float w = tb.wdof[(zd - kNa) * kWdofCols + 6] + 1e-12f;
    int rows;
    fcon[zd] = fcon[zd] + falling_support(P, z, bottom, s, v[zd], qacc0[zd],
                                          w, &rows);
    if (trace) trace[kTraceWords - 1] |= rows << (24 + 2 * b);
  }
  for (int d = 0; d < nv; ++d) rhs[d] = tau[d] + fcon[d] - bias[d];
  minv_mul_all<NBALL>(tb, Minv, bl, ns, rhs, qacc);
}

// quat o exp(w h / 2), renormalised (the body-frame exponential of
// engine._quat_exp_step).
__device__ __forceinline__ void quat_step(const float* q, const float* w,
                                          float h, float* o) {
  const float wx = w[0], wy = w[1], wz = w[2];
  const float angle = sqrtf(wx * wx + wy * wy + wz * wz + 1e-18f);
  const float half = angle * h * 0.5f;
  const float sh = sinf(half), dw = cosf(half);
  const float dx = wx / angle * sh, dy = wy / angle * sh, dz = wz / angle * sh;
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float nw = qw * dw - qx * dx - qy * dy - qz * dz;
  const float nx = qw * dx + qx * dw + qy * dz - qz * dy;
  const float ny = qw * dy - qx * dz + qy * dw + qz * dx;
  const float nz = qw * dz + qx * dy - qy * dx + qz * dw;
  const float nn = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
  o[0] = nw / nn; o[1] = nx / nn; o[2] = ny / nn; o[3] = nz / nn;
}

// q + v h with the free joints' body-frame exponential, the hinges and
// slides linear (engine.integrate_pos): the torso, the ns - 6 hinge and
// slide dofs, then the ball's free joint (its qpos after theirs).
template <int NBALL>
__device__ void integrate(const float* q, const float* v, float h, int ns,
                          float* out) {
  for (int i = 0; i < 3; ++i) out[i] = q[i] + v[i] * h;
  quat_step(q + 3, v + 3, h, out + 3);
  for (int d = 6; d < ns; ++d) out[d + 1] = q[d + 1] + v[d] * h;
  if constexpr (NBALL > 0) {
    const int qa = ns + 1;
    for (int i = 0; i < 3; ++i) out[qa + i] = q[qa + i] + v[ns + i] * h;
    quat_step(q + qa + 3, v + ns + 3, h, out + qa + 3);
  }
}

// One RK4 step (engine.rk4_step: the four stages in order).
template <int W, int NBLK, int NBALL>
__device__ void rk4(const Tables& tb, const AntParams& P, float* q, float* v,
                    const float* ctrl, int* n_active, int* trace) {
  constexpr int kNv = Dims<W, NBLK, NBALL>::kNv;
  constexpr int kNq = Dims<W, NBLK, NBALL>::kNq;
  const int ns = kNa + P.n_w;
  const int nv = ns + 6 * NBALL, nq = nv + 1 + NBALL;
  float prev_v[kNv], prev_a[kNv], acc_v[kNv], acc_a[kNv];
  for (int d = 0; d < nv; ++d) {
    prev_v[d] = v[d];
    prev_a[d] = 0.f;
    acc_v[d] = 0.f;
    acc_a[d] = 0.f;
  }
#pragma unroll 1
  for (int st = 0; st < 4; ++st) {
    const float hs = st == 0 ? 0.f : (st == 3 ? P.h : P.h_half);
    const float w = (st == 0 || st == 3) ? 1.f : 2.f;
    float qs[kNq], vs[kNv], as[kNv];
    integrate<NBALL>(q, prev_v, hs, ns, qs);
    for (int d = 0; d < nv; ++d) vs[d] = v[d] + prev_a[d] * hs;
    forward<W, NBLK, NBALL>(tb, P, qs, vs, ctrl, as, n_active,
                            trace ? trace + st * kTraceWords : nullptr);
    for (int d = 0; d < nv; ++d) {
      prev_v[d] = vs[d];
      prev_a[d] = as[d];
      acc_v[d] = acc_v[d] + w * vs[d];
      acc_a[d] = acc_a[d] + w * as[d];
    }
  }
  float vavg[kNv], qn[kNq];
  for (int d = 0; d < nv; ++d) vavg[d] = acc_v[d] / 6.f;
  integrate<NBALL>(q, vavg, P.h, ns, qn);
  for (int i = 0; i < nq; ++i) q[i] = qn[i];
  for (int d = 0; d < nv; ++d) v[d] = v[d] + (acc_a[d] / 6.f) * P.h;
}

// One Ant env step: frame_skip RK4 steps, then the inner reward and the
// task heads on (x, y, z) of the torso, or of the first observed object
// where the task observes it first (obs_offset 3): the first block's
// center, or the ball's body origin.  t + 1; no reset.
template <int W, int NBLK, int NBALL>
__device__ void ant_step(const Tables& tb, const AntParams& P, float* q,
                         float* v, int* t, const float* ctrl, float* reward,
                         bool* term, int* n_active, int* trace) {
  const float x0 = q[0], y0 = q[1];
#pragma unroll 1
  for (int fs = 0; fs < P.frame_skip; ++fs)
    rk4<W, NBLK, NBALL>(tb, P, q, v, ctrl, n_active,
                        trace ? trace + fs * 4 * kTraceWords : nullptr);
  const float vx = (q[0] - x0) / P.dt_outer, vy = (q[1] - y0) / P.dt_outer;
  const float fwd = sqrtf(vx * vx + vy * vy);
  float csq = 0.f;
  for (int u = 0; u < kNu; ++u) csq = csq + ctrl[u] * ctrl[u];
  const float inner = fwd - P.ctrl_weight * csq;
  float hx = q[0], hy = q[1], hz = q[2];
  if (P.obs_offset == 3 && P.n_blk > 0) {
    float c[3] = {tb.blk[0], tb.blk[1], tb.blk[2]};
    for (int j = 0; j < (int)tb.blk[7]; ++j) {
      const int d = (int)tb.blk[6] + j;
      const int ax = (int)tb.wdof[(d - kNa) * kWdofCols];
      c[ax] = c[ax] + q[d + 1];
    }
    hx = c[0];
    hy = c[1];
    hz = c[2];
  }
  if constexpr (NBALL > 0) {
    if (P.obs_offset == 3) {
      const int qa = (int)tb.ball[0];
      hx = q[qa];
      hy = q[qa + 1];
      hz = q[qa + 2];
    }
  }
  float rew = P.reward_type == 2 ? P.penalty : 0.f;
  bool hit_any = false;
  for (int gi = P.n_goal - 1; gi >= 0; --gi) {
    const float* gr = tb.goal + gi * kGoalCols;
    const float ddx = (hx - gr[0]) * gr[3];
    const float ddy = (hy - gr[1]) * gr[4];
    const float ddz = (hz - gr[2]) * gr[5];
    const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
    if (gi == 0 && P.reward_type == 1) rew = -(sqrtf(d2) * P.inv_scale);
    const bool near = gr[8] != 0.f && d2 <= gr[6];
    hit_any = hit_any || near;
    if (near && P.reward_type == 2) rew = gr[7];
  }
  *t = *t + 1;
  *reward = P.inner_scale * inner + rew;
  *term = hit_any;
}

__device__ Tables stage_tables(float* smem, const float* tables,
                               const AntParams& P) {
  for (int i = threadIdx.x; i < P.n_floats; i += blockDim.x)
    smem[i] = tables[i];
  __syncthreads();
  return Tables{smem + P.off_body,  smem + P.off_dof,   smem + P.off_act,
                smem + P.off_sph,   smem + P.off_box,   smem + P.off_goal,
                smem + P.off_qpos0, smem + P.off_wdof,  smem + P.off_blk,
                smem + P.off_plat,  smem + P.off_qpair, smem + P.off_ball,
                smem + P.off_bpair};
}

template <int W, int NBLK, int NBALL>
__global__ void ant_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    int* __restrict__ active_out, int* __restrict__ trace_out,
    const float* __restrict__ tables, AntParams P, int n) {
  constexpr int kNv = Dims<W, NBLK, NBALL>::kNv;
  constexpr int kNq = Dims<W, NBLK, NBALL>::kNq;
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, tables, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nv = kNa + P.n_w + 6 * NBALL, nq = nv + 1 + NBALL;
  float q[kNq], v[kNv], ctrl[kNu];
  for (int j = 0; j < nq; ++j) q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = 0; j < nv; ++j) v[j] = qvel[(size_t)i * v_stride + j];
  for (int j = 0; j < kNu; ++j) ctrl[j] = act[(size_t)i * a_stride + j];
  int t = t_in[i], n_active = 0;
  float rew;
  bool done;
  int* trace = trace_out ? trace_out + (size_t)i * P.frame_skip * 4 *
                                           kTraceWords
                         : nullptr;
  ant_step<W, NBLK, NBALL>(tb, P, q, v, &t, ctrl, &rew, &done, &n_active,
                           trace);
  for (int j = 0; j < nq; ++j) qpos_out[(size_t)i * nq + j] = q[j];
  for (int j = 0; j < nv; ++j) qvel_out[(size_t)i * nv + j] = v[j];
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
  if (active_out) active_out[i] = n_active;
}

template <int W, int NBLK, int NBALL>
__global__ void ant_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, int* __restrict__ active_out,
    const float* __restrict__ tables, AntParams P, int n, int num_steps,
    uint32_t seed) {
  constexpr int kNv = Dims<W, NBLK, NBALL>::kNv;
  constexpr int kNq = Dims<W, NBLK, NBALL>::kNq;
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, tables, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nv = kNa + P.n_w + 6 * NBALL, nq = nv + 1 + NBALL;
  float q[kNq], v[kNv];
  for (int j = 0; j < nq; ++j) q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = 0; j < nv; ++j) v[j] = qvel[(size_t)i * v_stride + j];
  int t = t_in[i], n_active = 0, eps = 0;
  float rew_sum = 0.f;
#pragma unroll 1
  for (int s = 0; s < num_steps; ++s) {
    // words 0-7 (blocks 0, 1): ctrl ~ U(+-30)
    const uint4 b0 = mmt::philox_block((uint32_t)i, (uint32_t)s, 0u, seed);
    const uint4 b1 = mmt::philox_block((uint32_t)i, (uint32_t)s, 1u, seed);
    const uint32_t cw[kNu] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float ctrl[kNu];
    for (int u = 0; u < kNu; ++u) ctrl[u] = mmt::uniform24(cw[u], -30.f, 30.f);
    float rew;
    bool term;
    ant_step<W, NBLK, NBALL>(tb, P, q, v, &t, ctrl, &rew, &term, &n_active,
                             nullptr);
    rew_sum = rew_sum + rew;
    if (term || t >= P.episode_limit) {
      // words 8-51 (blocks 2-12): the ant's qpos0 + U(+-0.1) with the
      // quaternion renormalised, then its qvel = 0.1 N(0, 1) by
      // Box-Muller (lane_env.normal); the world dofs (slides, or the
      // ball's position and quaternion) go back to qpos0 at rest and draw
      // nothing
      uint32_t w[44];
      for (int b = 0; b < 11; ++b) {
        const uint4 bb = mmt::philox_block((uint32_t)i, (uint32_t)s,
                                           (uint32_t)(2 + b), seed);
        w[4 * b] = bb.x; w[4 * b + 1] = bb.y;
        w[4 * b + 2] = bb.z; w[4 * b + 3] = bb.w;
      }
      for (int j = 0; j < kNa + 1; ++j)
        q[j] = tb.qpos0[j] + mmt::uniform24(w[j], -0.1f, 0.1f);
      const float qn = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] +
                             q[6] * q[6]);
      for (int j = 3; j < 7; ++j) q[j] = q[j] / qn;
      for (int d = 0; d < kNa; ++d) {
        const float u1 = mmt::uniform24(w[15 + 2 * d], 1e-7f, 1.f);
        const float u2 = mmt::uniform24(w[16 + 2 * d], 0.f, 1.f);
        const float z = sqrtf(-2.f * logf(u1)) * cosf(6.2831854820251465f * u2);
        v[d] = z * 0.1f;
      }
      for (int j = kNa + 1; j < nq; ++j) q[j] = tb.qpos0[j];
      for (int d = kNa; d < nv; ++d) v[d] = 0.f;
      t = 0;
      eps = eps + 1;
    }
  }
  for (int j = 0; j < nq; ++j) qpos_out[(size_t)i * nq + j] = q[j];
  for (int j = 0; j < nv; ++j) qvel_out[(size_t)i * nv + j] = v[j];
  t_out[i] = t;
  reward_sum[i] = rew_sum;
  episodes[i] = eps;
  if (active_out) active_out[i] = n_active;
}

}  // namespace

// Launchers of one instantiation: each launches on the given stream with
// `block` threads per block and returns cudaGetLastError().
template <int W, int NBLK, int NBALL = 0>
int launch_ant_step(const float* qpos, const float* qvel, const int* t,
                    const float* act, int q_stride, int v_stride,
                    int a_stride, float* qpos_out, float* qvel_out,
                    int* t_out, float* reward, bool* term, int* active_out,
                    int* trace_out, const float* tables, AntParams p, int n,
                    int block, void* stream) {
  if (n > 0) {
    ant_step_kernel<W, NBLK, NBALL><<<(n + block - 1) / block, block,
                                      sizeof(float) * (size_t)p.n_floats,
                                      (cudaStream_t)stream>>>(
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
        t_out, reward, term, active_out, trace_out, tables, p, n);
  }
  return (int)cudaGetLastError();
}

template <int W, int NBLK, int NBALL = 0>
int launch_ant_rollout(const float* qpos, const float* qvel, const int* t,
                       int q_stride, int v_stride, float* qpos_out,
                       float* qvel_out, int* t_out, float* reward_sum,
                       int* episodes, int* active_out, const float* tables,
                       AntParams p, int n, int num_steps, unsigned int seed,
                       int block, void* stream) {
  if (n > 0) {
    ant_rollout_kernel<W, NBLK, NBALL><<<(n + block - 1) / block, block,
                                         sizeof(float) * (size_t)p.n_floats,
                                         (cudaStream_t)stream>>>(
        qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
        reward_sum, episodes, active_out, tables, p, n, num_steps, seed);
  }
  return (int)cudaGetLastError();
}

// The block-world instantiation, compiled in ant_blocks.cu.
constexpr int kBlockWorldDofs = 6;
constexpr int kBlockWorldBlocks = 3;
int launch_ant_blocks_step(const float* qpos, const float* qvel, const int* t,
                           const float* act, int q_stride, int v_stride,
                           int a_stride, float* qpos_out, float* qvel_out,
                           int* t_out, float* reward, bool* term,
                           int* active_out, int* trace_out,
                           const float* tables, AntParams p, int n, int block,
                           void* stream);
int launch_ant_blocks_rollout(const float* qpos, const float* qvel,
                              const int* t, int q_stride, int v_stride,
                              float* qpos_out, float* qvel_out, int* t_out,
                              float* reward_sum, int* episodes,
                              int* active_out, const float* tables,
                              AntParams p, int n, int num_steps,
                              unsigned int seed, int block, void* stream);

// The ball-world instantiation (one free object ball, no blocks or
// slides), compiled in ant_balls.cu.
constexpr int kBallWorldBalls = 1;
int launch_ant_balls_step(const float* qpos, const float* qvel, const int* t,
                          const float* act, int q_stride, int v_stride,
                          int a_stride, float* qpos_out, float* qvel_out,
                          int* t_out, float* reward, bool* term,
                          int* active_out, int* trace_out,
                          const float* tables, AntParams p, int n, int block,
                          void* stream);
int launch_ant_balls_rollout(const float* qpos, const float* qvel,
                             const int* t, int q_stride, int v_stride,
                             float* qpos_out, float* qvel_out, int* t_out,
                             float* reward_sum, int* episodes,
                             int* active_out, const float* tables,
                             AntParams p, int n, int num_steps,
                             unsigned int seed, int block, void* stream);
