// Ant robot on an object-free maze: the step and rollout kernels.
//
// Replaces the TPU kernel of the JAX package
//   mujoco_maze_tpu/ops/ant_pallas.py build_step_kernel (:228) and
//   build_rollout_kernel (:222) -> _make_kernel.env_step (:139), _rk4_scan
//   (:105), with ops/ant_math.py forward_ant (:1113), fk_ant (:198),
//   mass_matrix (:309), rne_bias (:347), _contact_rows (:890),
//   integrate_ant (:1524), and sample_ctrl / sample_reset (:186, :192),
// for worlds without movable blocks or object balls.
//
// What it computes.  One env step is frame_skip (5) RK4 steps of dt 0.02
// of the free-root ant; each RK4 step runs four forward-dynamics
// evaluations.  A forward evaluation does, per env:
//   * the kinematics of the 13 bodies (torso from the quaternion, each leg
//     joint a Rodrigues rotation about its world axis);
//   * the 14x14 joint-space mass matrix in Jacobian form
//     (sum over bodies of m Jc^T Jc + W^T Iw W, plus armature), its
//     Cholesky factor (pivots clamped at 1e-12) and its inverse;
//   * the RNE bias (gravity and velocity products, in world axes about the
//     torso origin, where float32 keeps the robot's own scale; about the
//     world origin the rounding would grow with the squared distance);
//   * impedance joint limits on the 8 hinges (physics/engine.py
//     limit_force), from the smooth acceleration qacc0;
//   * contacts: every test sphere (37) against the floor plane and against
//     the two nearest of the 4 boxes nearest the torso (ant_math's torso
//     prune); a contact is active when dist < margin; 3 pyramid rows each
//     (normal, two tangents); projected Jacobi, 4 sweeps, omega 0.6, on
//     the regularised Delassus matrix (physics/contact.py contact_qfrc);
//   * qacc = M^-1 (tau + f_con - bias).
// Then the task heads on (x, y, z): the inner reward (planar torso speed
// minus 1e-4 |ctrl|^2, scaled) plus the goal/dist head, first hit wins.
//
// Design.  One thread is one env.  The public (B, 15) / (B, 14) row-major
// tensors are read in place with their row strides.  The per-spec data
// are runtime tables, packed into one float32 buffer that each block
// stages into shared memory: the bodies (parent, hinge dof, the two
// hinge dofs on the root path, offset, axis, mass, com, inertia), the
// dofs (armature, damping, range), the actuators, the test spheres, the
// static boxes and the goals.  So one build serves every object-free Ant
// maze.  The scalars come by value in AntParams.  Per-thread state that
// does not fit in registers (the 13 body poses, the 14x14 factor and
// inverse, the contact rows) lives in local memory.  Only ACTIVE contacts
// are kept, in a compacted list bounded by 3 x kMaxSph rows: an inactive
// contact's force is exactly 0 after the projection in the JAX math
// (contact.py project, ant_math.py:1438-1455), so it adds nothing to any
// sum.  The row and sweep loops stay rolled (#pragma unroll 1) to keep
// the compile short.
//
// What bounds it on an H100.  About 270 bytes per env and step move
// (1.1 MB at B = 4096), against some 7 x 10^5 fp32 operations per
// env-step (ant_step_flops in chip_smoke.py counts them from this source,
// with the active contacts the kernel counts): the
// kernel is bound by fp32 operations, and at one thread per env it runs
// 4096 threads, 32 to 128 per block, so each SM holds one to four warps
// of a long serial dependence chain with local-memory traffic.  It is far
// from that bound; the design choice of this first version is to be
// right and simple.  Spreading an env over a warp (the 14x14 factor, the
// contact rows) is the first thing to try to make it fast.
//
// Arithmetic.  The plain version (ops/ant_kernel.py ant_step_plain) is
// the batched engine (physics/engine.py, physics/contact.py), which
// computes the same function by another algorithm (the CRB mass matrix
// from 6x6 spatial inertias, dense J over all contacts, torch reductions
// and cuBLAS products), so the two
// agree to float32 rounding, not to the bit: chip_smoke.py states the
// bounds.  This file uses IEEE sqrtf, sinf, cosf, logf and divisions (no
// rsqrtf, no fast math) and is built with -fmad=false.  Knife edges, with
// the JAX comparison operators kept: the strict < of the near-box and
// nearest-two insertions (first of equal keys wins), outside = d_out >
// 1e-6, the min-exit axis ex <= min(ey, ez), active = dist < margin, the
// joint-limit switch viol > 0, and the max(0, .) / cone clamps of project.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

struct AntParams {
  // offsets of the tables in the packed buffer (floats) and their sizes
  int off_body, off_dof, off_act, off_sph, off_box, off_goal, off_qpos0;
  int n_floats;
  int n_sph, n_box, n_near, n_goal;
  int frame_skip, solver_iters, reward_type, episode_limit;
  float h, h_half;            // RK4 step and float32(h / 2)
  float dt_outer;             // h * frame_skip: the reward's velocity step
  float gravity;              // +g of the fictitious base acceleration
  float ctrl_weight, inner_scale, penalty, inv_scale;
  float lim_b, lim_d0, lim_dd, lim_width, lim_kden;  // joint-limit impedance
  float omega;                // Jacobi relaxation
};

namespace {

constexpr int kNb = 13;       // bodies
constexpr int kNv = 14;       // dofs: free 0-5, hinges 6-13
constexpr int kNq = 15;
constexpr int kNu = 8;
constexpr int kRowDofs = 8;   // 6 free dofs + 2 hinges on a root path
constexpr int kMaxSph = 40;
constexpr int kMaxNear = 4;
constexpr int kMaxCon = 3 * kMaxSph;
// table layouts (ops/ant_kernel.py packs them, column for column)
constexpr int kBodyCols = 20;  // parent, hinge, chain0, chain1, pos3,
                               // axis3, mass, com3, Ixx Iyy Izz Ixy Ixz Iyz
constexpr int kDofCols = 5;    // armature, damping, limited, lo, hi
constexpr int kActCols = 4;    // dof, gear, lo, hi
constexpr int kSphCols = 13;   // body, local3, radius, margin, floor margin,
                               // mu, d0, dmax, width, tc (clamped), dampr
constexpr int kBoxCols = 7;    // center3, half3, margin
constexpr int kGoalCols = 9;   // pos3, dim_mask3, threshold^2, scale, valid

struct Kin {
  float R[kNb][9];       // row-major world rotation
  float p[kNb][3];       // world frame origin
  float c[kNb][3];       // world com
  float w[kNv][3];       // world axis of each rotational dof (3..13)
  float anc[kNv][3];     // world anchor of each rotational dof
};

struct Contact {         // one active contact: 3 rows (n, t1, t2)
  int body;
  float mu;
  float J[3][kRowDofs];  // row entries on the body's dof list
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
__device__ void mass_matrix(const Tables& tb, const Kin& k, float M[kNv][kNv]) {
  for (int i = 0; i < kNv; ++i)
    for (int j = 0; j < kNv; ++j) M[i][j] = 0.f;
#pragma unroll 1
  for (int b = 0; b < kNb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const float m = row[10];
    float Iw[9];
    world_inertia(k.R[b], row, Iw);
    float J[kRowDofs][3], W[kRowDofs][3], IW[kRowDofs][3];
    int dof[kRowDofs];
    int n = 0;
#pragma unroll 1
    for (int e = 0; e < kRowDofs; ++e) {
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
  for (int i = 0; i < kNv; ++i) {
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
// overwritten with L.
__device__ void spd_inverse(float M[kNv][kNv], float Minv[kNv][kNv]) {
#pragma unroll 1
  for (int j = 0; j < kNv; ++j) {
    for (int i = j; i < kNv; ++i) {
      float s = M[i][j];
      for (int kk = 0; kk < j; ++kk) s = s - M[i][kk] * M[j][kk];
      M[i][j] = s;  // provisional: divided by the pivot below
    }
    const float d = sqrtf(fmaxf(M[j][j], 1e-12f));
    for (int i = j; i < kNv; ++i) M[i][j] = M[i][j] / d;
  }
  // forward substitution L Y = I, then back substitution L^T X = Y
#pragma unroll 1
  for (int c = 0; c < kNv; ++c) {
    for (int i = 0; i < kNv; ++i) {
      float acc = i == c ? 1.f : 0.f;
      for (int kk = 0; kk < i; ++kk) acc = acc - M[i][kk] * Minv[kk][c];
      Minv[i][c] = acc / M[i][i];
    }
    for (int i = kNv - 1; i >= 0; --i) {
      float acc = Minv[i][c];
      for (int kk = i + 1; kk < kNv; ++kk) acc = acc - M[kk][i] * Minv[kk][c];
      Minv[i][c] = acc / M[i][i];
    }
  }
}

__device__ __forceinline__ void minv_mul(const float Minv[kNv][kNv],
                                         const float* x, float* y) {
  for (int i = 0; i < kNv; ++i) {
    float s = 0.f;
    for (int j = 0; j < kNv; ++j) s = s + Minv[i][j] * x[j];
    y[i] = s;
  }
}

// Sphere vs static AABB (contact.py contact_qfrc): signed distance, world
// contact point and normal.
__device__ void sphere_box(const float* c, float r, const float* bx,
                           float* dist, float* pos, float* n) {
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
  *dist = outside ? d_out - r : pen_in - r;
  for (int i = 0; i < 3; ++i) {
    n[i] = outside ? delta[i] / d_out : nin[i];
    pos[i] = bx[i] + (outside ? cl[i] : local[i] - nin[i] * pen_in);
  }
}

// Append one active contact: its three rows on the body's dof list, the
// impedance constants, A = J Minv J^T, aref - a0, R and the denominator
// (contact.py contact_qfrc, row by row).
__device__ void add_contact(const Tables& tb, const Kin& k,
                            const float Minv[kNv][kNv], const float* v,
                            const float* qacc0, const float* sp, int body,
                            const float* pos, const float* nrm, float dist,
                            float margin, Contact& ct) {
  const float* brow = tb.body + body * kBodyCols;
  const float mu = sp[7], d0 = sp[8], dmax = sp[9], width = sp[10];
  const float tc = sp[11], dampr = sp[12];
  ct.body = body;
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
  int dof[kRowDofs];
  for (int e = 0; e < kRowDofs; ++e) {
    const int d = row_dof(brow, e);
    dof[e] = d;
    float J[3], W[3];
    if (d >= 0) dof_basis(k, d, pos, J, W);
    for (int r = 0; r < 3; ++r) ct.J[r][e] = d >= 0 ? dot3(J, dirs[r]) : 0.f;
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
    for (int i = 0; i < kRowDofs; ++i) {
      if (dof[i] < 0) continue;
      float s = 0.f;
      for (int j = 0; j < kRowDofs; ++j)
        if (dof[j] >= 0) s = s + J[j] * Minv[dof[j]][dof[i]];
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
__device__ __forceinline__ void project(Contact& ct) {
  const float fn = fmaxf(ct.f[0], 0.f);
  const float ftn = sqrtf(ct.f[1] * ct.f[1] + ct.f[2] * ct.f[2] + 1e-12f);
  const float scale = fminf(ct.mu * fn / ftn, 1.f);
  ct.f[0] = fn;
  ct.f[1] = ct.f[1] * scale;
  ct.f[2] = ct.f[2] * scale;
}

// J^T f of one contact, added into x (nv).
__device__ __forceinline__ void add_jt_f(const Tables& tb, const Contact& ct,
                                         float* x) {
  const float* brow = tb.body + ct.body * kBodyCols;
  for (int e = 0; e < kRowDofs; ++e) {
    const int d = row_dof(brow, e);
    if (d < 0) continue;
    x[d] = x[d] + (ct.J[0][e] * ct.f[0] + ct.J[1][e] * ct.f[1] +
                   ct.J[2][e] * ct.f[2]);
  }
}

// Contact detection, compacted active list and the projected-Jacobi
// solve; adds the contact force into fcon.  Returns the active count.
__device__ int contact_force(const Tables& tb, const AntParams& P,
                             const Kin& k, const float Minv[kNv][kNv],
                             const float* v, const float* qacc0, float* fcon,
                             Contact* con) {
  // the n_near boxes nearest the torso, sorted, first of equal keys first
  float near_d[kMaxNear];
  int near_i[kMaxNear];
  for (int sl = 0; sl < kMaxNear; ++sl) {
    near_d[sl] = INFINITY;
    near_i[sl] = -1;
  }
#pragma unroll 1
  for (int b = 0; b < P.n_box; ++b) {
    const float* bx = tb.box + b * kBoxCols;
    float d = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float di = fmaxf(fabsf(k.p[0][i] - bx[i]) - bx[3 + i], 0.f);
      d = d + di * di;
    }
    float cd = d;
    int ci = b;
    for (int sl = 0; sl < P.n_near; ++sl) {
      if (cd < near_d[sl]) {
        const float td = near_d[sl];
        const int ti = near_i[sl];
        near_d[sl] = cd;
        near_i[sl] = ci;
        cd = td;
        ci = ti;
      }
    }
  }
  int nc = 0;
#pragma unroll 1
  for (int s = 0; s < P.n_sph; ++s) {
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
        add_contact(tb, k, Minv, v, qacc0, sp, body, pos, up, dist, sp[6],
                    con[nc++]);
      }
    }
    // the two nearest near boxes by dist - box margin (strict <)
    float best_e[2] = {INFINITY, INFINITY}, best_d[2] = {0.f, 0.f};
    float best_p[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float best_n[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float best_m[2] = {0.f, 0.f};
#pragma unroll 1
    for (int sl = 0; sl < P.n_near; ++sl) {
      const float* bx = tb.box + near_i[sl] * kBoxCols;
      float dist, pos[3], n[3];
      sphere_box(c, r, bx, &dist, pos, n);
      const float e = dist - bx[6];
      const bool b1 = e < best_e[0];
      const bool b2 = !b1 && e < best_e[1];
      if (b1) {
        best_e[1] = best_e[0]; best_d[1] = best_d[0]; best_m[1] = best_m[0];
        for (int i = 0; i < 3; ++i) {
          best_p[1][i] = best_p[0][i];
          best_n[1][i] = best_n[0][i];
        }
        best_e[0] = e; best_d[0] = dist; best_m[0] = bx[6];
        for (int i = 0; i < 3; ++i) {
          best_p[0][i] = pos[i];
          best_n[0][i] = n[i];
        }
      } else if (b2) {
        best_e[1] = e; best_d[1] = dist; best_m[1] = bx[6];
        for (int i = 0; i < 3; ++i) {
          best_p[1][i] = pos[i];
          best_n[1][i] = n[i];
        }
      }
    }
    const int n_pick = P.n_near < 2 ? P.n_near : 2;
    for (int j = 0; j < n_pick; ++j) {
      const float margin = sp[5] + best_m[j];
      if (best_d[j] < margin)
        add_contact(tb, k, Minv, v, qacc0, sp, body, best_p[j], best_n[j],
                    best_d[j], margin, con[nc++]);
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
    float x[kNv], y[kNv];
    for (int d = 0; d < kNv; ++d) x[d] = 0.f;
#pragma unroll 1
    for (int i = 0; i < nc; ++i) add_jt_f(tb, con[i], x);
    minv_mul(Minv, x, y);
#pragma unroll 1
    for (int i = 0; i < nc; ++i) {
      Contact& ct = con[i];
      const float* brow = tb.body + ct.body * kBodyCols;
      float af[3] = {0.f, 0.f, 0.f};
      for (int e = 0; e < kRowDofs; ++e) {
        const int d = row_dof(brow, e);
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
  for (int i = 0; i < nc; ++i) add_jt_f(tb, con[i], fcon);
  return nc;
}

// qacc of one forward-dynamics evaluation (engine.forward with the contact
// force).  Adds the active-contact count to *n_active.
__device__ void forward(const Tables& tb, const AntParams& P, const float* q,
                        const float* v, const float* ctrl, float* qacc,
                        int* n_active) {
  Kin k;
  fk(tb, q, k);
  float M[kNv][kNv], Minv[kNv][kNv];
  mass_matrix(tb, k, M);
  float bias[kNv], tau[kNv];
  rne_bias(tb, P, k, v, bias);
  for (int d = 0; d < kNv; ++d) tau[d] = 0.f;
  for (int u = 0; u < kNu; ++u) {
    const float* a = tb.act + u * kActCols;
    const int d = (int)a[0];
    tau[d] = tau[d] + a[1] * clampf(ctrl[u], a[2], a[3]);
  }
  for (int d = 0; d < kNv; ++d)
    tau[d] = tau[d] - tb.dof[d * kDofCols + 1] * v[d];
  spd_inverse(M, Minv);
  float rhs[kNv], qacc0[kNv], fcon[kNv];
  for (int d = 0; d < kNv; ++d) {
    rhs[d] = tau[d] - bias[d];
    fcon[d] = 0.f;
  }
  minv_mul(Minv, rhs, qacc0);
  // joint limits (engine.limit_force): upper, then lower
#pragma unroll 1
  for (int d = 6; d < kNv; ++d) {
    const float* dr = tb.dof + d * kDofCols;
    if (dr[2] == 0.f) continue;
    const float qd = q[d + 1], vd = v[d], a0 = qacc0[d];
    const float m_eff = 1.f / fmaxf(Minv[d][d], 1e-12f);
    for (int side = 0; side < 2; ++side) {
      const float sign = side == 0 ? 1.f : -1.f;
      const float viol = side == 0 ? fmaxf(qd - dr[4], 0.f)
                                   : fmaxf(dr[3] - qd, 0.f);
      const float dimp =
          P.lim_d0 + P.lim_dd * clampf(viol / P.lim_width, 0.f, 1.f);
      const float kimp = dimp / P.lim_kden;
      const float aref = -P.lim_b * (sign * vd) - kimp * viol;
      const float f_out = fminf(m_eff * dimp * (aref - sign * a0), 0.f);
      fcon[d] = fcon[d] + (viol > 0.f ? sign * f_out : 0.f);
    }
  }
  Contact con[kMaxCon];
  *n_active += contact_force(tb, P, k, Minv, v, qacc0, fcon, con);
  for (int d = 0; d < kNv; ++d) rhs[d] = tau[d] + fcon[d] - bias[d];
  minv_mul(Minv, rhs, qacc);
}

// q + v h with the free joint's body-frame exponential (engine.integrate_pos).
__device__ void integrate(const float* q, const float* v, float h, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = q[i] + v[i] * h;
  const float wx = v[3], wy = v[4], wz = v[5];
  const float angle = sqrtf(wx * wx + wy * wy + wz * wz + 1e-18f);
  const float half = angle * h * 0.5f;
  const float sh = sinf(half), dw = cosf(half);
  const float dx = wx / angle * sh, dy = wy / angle * sh, dz = wz / angle * sh;
  const float qw = q[3], qx = q[4], qy = q[5], qz = q[6];
  const float nw = qw * dw - qx * dx - qy * dy - qz * dz;
  const float nx = qw * dx + qx * dw + qy * dz - qz * dy;
  const float ny = qw * dy - qx * dz + qy * dw + qz * dx;
  const float nz = qw * dz + qx * dy - qy * dx + qz * dw;
  const float nn = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
  out[3] = nw / nn; out[4] = nx / nn; out[5] = ny / nn; out[6] = nz / nn;
  for (int d = 6; d < kNv; ++d) out[d + 1] = q[d + 1] + v[d] * h;
}

// One RK4 step (engine.rk4_step: the four stages in order).
__device__ void rk4(const Tables& tb, const AntParams& P, float* q, float* v,
                    const float* ctrl, int* n_active) {
  float prev_v[kNv], prev_a[kNv], acc_v[kNv], acc_a[kNv];
  for (int d = 0; d < kNv; ++d) {
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
    integrate(q, prev_v, hs, qs);
    for (int d = 0; d < kNv; ++d) vs[d] = v[d] + prev_a[d] * hs;
    forward(tb, P, qs, vs, ctrl, as, n_active);
    for (int d = 0; d < kNv; ++d) {
      prev_v[d] = vs[d];
      prev_a[d] = as[d];
      acc_v[d] = acc_v[d] + w * vs[d];
      acc_a[d] = acc_a[d] + w * as[d];
    }
  }
  float vavg[kNv], qn[kNq];
  for (int d = 0; d < kNv; ++d) vavg[d] = acc_v[d] / 6.f;
  integrate(q, vavg, P.h, qn);
  for (int i = 0; i < kNq; ++i) q[i] = qn[i];
  for (int d = 0; d < kNv; ++d) v[d] = v[d] + (acc_a[d] / 6.f) * P.h;
}

// One Ant env step: frame_skip RK4 steps, then the inner reward and the
// task heads on (x, y, z).  t + 1; no reset.
__device__ void ant_step(const Tables& tb, const AntParams& P, float* q,
                         float* v, int* t, const float* ctrl, float* reward,
                         bool* term, int* n_active) {
  const float x0 = q[0], y0 = q[1];
#pragma unroll 1
  for (int fs = 0; fs < P.frame_skip; ++fs) rk4(tb, P, q, v, ctrl, n_active);
  const float vx = (q[0] - x0) / P.dt_outer, vy = (q[1] - y0) / P.dt_outer;
  const float fwd = sqrtf(vx * vx + vy * vy);
  float csq = 0.f;
  for (int u = 0; u < kNu; ++u) csq = csq + ctrl[u] * ctrl[u];
  const float inner = fwd - P.ctrl_weight * csq;
  float rew = P.reward_type == 2 ? P.penalty : 0.f;
  bool hit_any = false;
  for (int gi = P.n_goal - 1; gi >= 0; --gi) {
    const float* gr = tb.goal + gi * kGoalCols;
    const float ddx = (q[0] - gr[0]) * gr[3];
    const float ddy = (q[1] - gr[1]) * gr[4];
    const float ddz = (q[2] - gr[2]) * gr[5];
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
  return Tables{smem + P.off_body, smem + P.off_dof, smem + P.off_act,
                smem + P.off_sph,  smem + P.off_box, smem + P.off_goal,
                smem + P.off_qpos0};
}

__global__ void ant_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    int* __restrict__ active_out, const float* __restrict__ tables,
    AntParams P, int n) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, tables, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float q[kNq], v[kNv], ctrl[kNu];
  for (int j = 0; j < kNq; ++j) q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = 0; j < kNv; ++j) v[j] = qvel[(size_t)i * v_stride + j];
  for (int j = 0; j < kNu; ++j) ctrl[j] = act[(size_t)i * a_stride + j];
  int t = t_in[i], n_active = 0;
  float rew;
  bool done;
  ant_step(tb, P, q, v, &t, ctrl, &rew, &done, &n_active);
  for (int j = 0; j < kNq; ++j) qpos_out[(size_t)i * kNq + j] = q[j];
  for (int j = 0; j < kNv; ++j) qvel_out[(size_t)i * kNv + j] = v[j];
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
  if (active_out) active_out[i] = n_active;
}

__global__ void ant_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, int* __restrict__ active_out,
    const float* __restrict__ tables, AntParams P, int n, int num_steps,
    uint32_t seed) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, tables, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float q[kNq], v[kNv];
  for (int j = 0; j < kNq; ++j) q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = 0; j < kNv; ++j) v[j] = qvel[(size_t)i * v_stride + j];
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
    ant_step(tb, P, q, v, &t, ctrl, &rew, &term, &n_active);
    rew_sum = rew_sum + rew;
    if (term || t >= P.episode_limit) {
      // words 8-51 (blocks 2-12): qpos0 + U(+-0.1) with the quaternion
      // renormalised, then qvel = 0.1 N(0, 1) by Box-Muller (lane_env.normal)
      uint32_t w[44];
      for (int b = 0; b < 11; ++b) {
        const uint4 bb = mmt::philox_block((uint32_t)i, (uint32_t)s,
                                           (uint32_t)(2 + b), seed);
        w[4 * b] = bb.x; w[4 * b + 1] = bb.y;
        w[4 * b + 2] = bb.z; w[4 * b + 3] = bb.w;
      }
      for (int j = 0; j < kNq; ++j)
        q[j] = tb.qpos0[j] + mmt::uniform24(w[j], -0.1f, 0.1f);
      const float qn = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] +
                             q[6] * q[6]);
      for (int j = 3; j < 7; ++j) q[j] = q[j] / qn;
      for (int d = 0; d < kNv; ++d) {
        const float u1 = mmt::uniform24(w[15 + 2 * d], 1e-7f, 1.f);
        const float u2 = mmt::uniform24(w[16 + 2 * d], 0.f, 1.f);
        const float z = sqrtf(-2.f * logf(u1)) * cosf(6.2831854820251465f * u2);
        v[d] = z * 0.1f;
      }
      t = 0;
      eps = eps + 1;
    }
  }
  for (int j = 0; j < kNq; ++j) qpos_out[(size_t)i * kNq + j] = q[j];
  for (int j = 0; j < kNv; ++j) qvel_out[(size_t)i * kNv + j] = v[j];
  t_out[i] = t;
  reward_sum[i] = rew_sum;
  episodes[i] = eps;
  if (active_out) active_out[i] = n_active;
}

}  // namespace

// C entry points: each launches on the given stream with `block` threads
// per block and returns cudaGetLastError(), which the Python wrapper
// checks.  active_out may be null.
extern "C" int mmt_ant_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term, int* active_out,
    const float* tables, AntParams p, int n, int block, void* stream) {
  if (n > 0) {
    ant_step_kernel<<<(n + block - 1) / block, block,
                      sizeof(float) * (size_t)p.n_floats,
                      (cudaStream_t)stream>>>(
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
        t_out, reward, term, active_out, tables, p, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int mmt_ant_rollout(
    const float* qpos, const float* qvel, const int* t, int q_stride,
    int v_stride, float* qpos_out, float* qvel_out, int* t_out,
    float* reward_sum, int* episodes, int* active_out, const float* tables,
    AntParams p, int n, int num_steps, unsigned int seed, int block,
    void* stream) {
  if (n > 0) {
    ant_rollout_kernel<<<(n + block - 1) / block, block,
                         sizeof(float) * (size_t)p.n_floats,
                         (cudaStream_t)stream>>>(
        qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
        reward_sum, episodes, active_out, tables, p, n, num_steps, seed);
  }
  return (int)cudaGetLastError();
}
