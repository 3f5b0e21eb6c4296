// The generic engine step: one env step of any engine-world robot (a custom
// robot composed through the extension API), per thread, over runtime
// tables of the model and the world.  engine_lane.cu wraps it in the
// kernel and its C entry point; this header holds the per-env device code
// only, so that it also compiles on the host (with __device__ and
// __forceinline__ defined empty) for a check against the plain version.
//
// Replaces the TPU kernel of the JAX package
//   mujoco_maze_tpu/ops/engine_pallas.py build_step_kernel (:190) ->
//   _make_kernel (:129): env_step (:156), rk4_scan (:136), with
//   ops/lane_engine.py forward_lane (:690), integrate_lane (:926), fk_lane
//   (:215), mass_blocks (:299), rne_bias_lane (:336), fluid_lane (:439)
//   and _contact_rows_lane (:492),
// without the JAX lane form's 4-nearest-box prune (lane_engine.py:530-585,
// which dropped contacts in the Fall worlds): each sphere is tested against
// every static box and keeps the nearest two, as physics/contact.py does.
//
// What it computes (the plain version, ops/engine_kernel.py
// engine_step_plain, is physics/engine.py and physics/contact.py).  One
// env step is frame_skip RK4 steps of dt h of the composed RigidModel;
// each RK4 step runs four forward-dynamics evaluations.  A forward
// evaluation does, per env:
//   * kinematics of every body in body order (FREE, BALL, SLIDE and HINGE
//     joints, each joint's axis and anchor taken at its place in the
//     sequence), and each dof's motion subspace cdof and its derivative
//     about its kinematic tree's reference point, the origin of the
//     tree's root body (where float32 keeps each tree at its own scale:
//     the robot, a block, a free ball; physics/engine.py);
//   * the mass matrix by composite rigid bodies (M[a][b] = (I^C s_a) . s_b
//     for b on the root path of a's body), plus armature; its Cholesky
//     factor and inverse per kinematic tree (M is block diagonal over the
//     trees: a robot, each movable block);
//   * the RNE bias (gravity as the fictitious base acceleration, velocity
//     products), MuJoCo's inertia-box fluid drag, actuation and damping;
//   * impedance joint limits (physics/engine.py limit_force) from the
//     smooth acceleration qacc0;
//   * contacts: every test sphere that meets the world against the floor
//     plane and the two nearest static boxes (by dist - box margin, strict
//     <), every sphere-sphere pair (a robot's sphere and an object ball's:
//     the normal along the centre line, the point midway through the
//     overlap) and every sphere-vs-moving-box pair in the box's frame, in
//     that order; a contact is active when dist < margin, with 3 pyramid
//     rows (normal, two tangents) over the dofs of both bodies' root paths,
//     + on the first body's and - on the second's, each tree's columns
//     with the moment arm about its own reference point; projected
//     Jacobi, solver_iters sweeps, omega 0.6, on the regularised Delassus
//     diagonal (physics/contact.py contact_qfrc);
//   * the falling blocks' coupled platform support and z limit
//     (physics/contact.py falling_support_force);
//   * qacc = M^-1 (tau + f_con - bias).
// Then the inner reward fwd_weight |dxy| / dt - ctrl_weight |a|^2 on the
// raw action (scaled), t + 1, and the task heads on the anchor: the
// robot's qpos[0:3], the first object ball's centre or the first block's.
//
// Design.  One thread is one env.  The public (B, nq) / (B, nv) row-major
// tensors are read in place with their row strides.  Every model datum is
// a runtime table, staged by each block into shared memory, so one build
// serves every model within the compile-time caps below (the wrapper
// checks them before launch and raises past them): the bodies, joints,
// dofs, actuators, test spheres, static boxes, moving boxes, sphere-sphere
// pairs, sphere-box pairs, falling blocks, platforms and goals.  Per-thread state (the body
// poses, cdof, M and M^-1) lives in local memory.  Only ACTIVE contacts
// are kept, in a compacted list in wrapper-owned global scratch sized for
// every candidate, laid out [slot][field][env] so that a warp's accesses
// fall on neighbouring addresses; an inactive contact's force is exactly
// 0 after the projection, so it adds nothing to any sum.
//
// What bounds it on an H100.  A step reads and writes a few dozen floats
// per env; it does 10^4 (the Roller) to 10^6 (the Ant model) fp32
// operations per env-step: it is bound by operations, and one thread per
// env leaves the card's lanes mostly waiting on one long serial chain per
// env.  The design choice of this version is to be right and simple;
// spreading an env over a warp (the tree factorisations, the contact rows)
// is the first thing to try to make it fast.
//
// Arithmetic.  The plain version computes the same function with batched
// tensor operations (matrix products, reductions), so the two agree to
// float32 rounding, not to the bit.  IEEE sqrtf, sinf, cosf and divisions
// (no fast math; built with -fmad=false).  Knife edges keep the plain
// version's comparison operators: the strict < of the nearest-two picks
// (first of equal keys wins), outside = d_out > 1e-6, the min-exit axis
// ex <= min(ey, ez), active = dist < margin, the limit switch viol > 0,
// the support's case analysis, the platform overlap |c - p| < o and the
// cone clamps of the projection.

#pragma once

#include <math.h>
#include <stdint.h>

struct EngineParams {
  // offsets of the tables in the packed buffer (floats) and their sizes
  int off_body, off_jnt, off_dof, off_act, off_sph, off_box, off_dbox;
  int off_spair, off_pair, off_fall, off_plat, off_goal;
  int n_floats;
  int nb, nj, nq, nv, nu, n_sph, n_box, n_spair, n_pair, n_fall, n_goal;
  int has_floor;    // 1: a floor plane
  int n_static;     // test spheres that meet the static world
  int n_pick;       // static boxes a sphere keeps: min(n_box, 2)
  int n_cand, row_floats, trace_words;
  int frame_skip, solver_iters, reward_type;
  int head_q0, head_q1, head_q2;  // qpos of the heads' anchor (-1: none)
  int visc_on, rho_on;            // the fluid model's terms
  float h, h_half;                // RK4 step and float32(h / 2)
  float dt_outer;                 // float32(h * frame_skip)
  float gx, gy, gz;               // gravity
  float floor_z;
  float fwd_weight, ctrl_weight, inner_scale, penalty, inv_scale;
  float head_b0, head_b1, head_b2;
  float lim_b, lim_d0, lim_dd, lim_width, lim_kden;  // joint-limit impedance
  float omega;                    // Jacobi relaxation
  // the falling support's impedance constants at its time constant tc:
  // 0.995 / (0.995^2 tc^2), 2 / (0.995 tc), 0.95^2 tc^2, 2 / (0.95 tc)
  float sup_kc, sup_bc, sup_kl_den, sup_bl;
};

namespace mmt_eng {

// compile-time caps (the wrapper reads them with mmt_engine_caps)
constexpr int kMaxBodies = 16;
constexpr int kMaxNv = 24;     // the dof bit sets are exact in float32
constexpr int kMaxNq = 32;
constexpr int kMaxNu = 16;
constexpr int kMaxTableFloats = 12288;  // 48 KB of shared memory
// joint types (physics/model.py)
constexpr int kFree = 0, kBall = 1, kSlide = 2, kHinge = 3;
// table layouts (ops/engine_kernel.py packs them, column for column)
constexpr int kBodyCols = 34;  // parent, jnt0, njnt, pos3, Roff9, mass,
                               // com3, Ixx Iyy Izz Ixy Ixz Iyz, chain bits,
                               // kvf, kvt, kf3, kt3
constexpr int kJntCols = 12;   // type, qadr, vadr, axis3, pos3, limited,
                               // lo, hi
constexpr int kDofCols = 5;    // body, armature, damping, tree lo, tree hi
constexpr int kActCols = 4;    // dof, gear, lo, hi
constexpr int kSphCols = 14;   // body, local3, radius, margin, floor
                               // margin, mu, d0, dmax, width, tc, dampr,
                               // static index (-1)
constexpr int kBoxCols = 7;    // center3, half3, margin
constexpr int kDboxCols = 7;   // body, local3, half3
constexpr int kPairCols = 9;   // sphere, dbox (spair: sphere i, sphere j),
                               // margin, mu, d0, dmax, width, tc, dampr
constexpr int kFallCols = 6;   // body, zdof, half z, plat0, nplat, rest z
constexpr int kPlatCols = 5;   // x, y, half x + .., half y + .., top
constexpr int kGoalCols = 9;   // pos3, dim_mask3, threshold^2, scale, valid
// a contact's scratch fields after its 3 x nv Jacobian entries
// (ROW_FIXED in ops/engine_kernel.py): rhs3, rreg3, denom3, f3, mu
constexpr int kRowFixed = 13;

struct Tables {
  const float* body;
  const float* jnt;
  const float* dof;
  const float* act;
  const float* sph;
  const float* box;
  const float* dbox;
  const float* spair;  // sphere-sphere pairs
  const float* pair;   // sphere-vs-moving-box pairs
  const float* fall;
  const float* plat;
  const float* goal;
};

__device__ __forceinline__ Tables tables_at(const float* base,
                                            const EngineParams& P) {
  return Tables{base + P.off_body,  base + P.off_jnt,  base + P.off_dof,
                base + P.off_act,   base + P.off_sph,  base + P.off_box,
                base + P.off_dbox,  base + P.off_spair, base + P.off_pair,
                base + P.off_fall,  base + P.off_plat, base + P.off_goal};
}

// One env's contact scratch: element (slot, field) of env e.
struct Scratch {
  float* base;
  int64_t n;    // envs (the stride of a field)
  int e;
  int rf;       // floats per contact
  __device__ __forceinline__ float& at(int slot, int field) const {
    return base[((int64_t)slot * rf + field) * n + e];
  }
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] +
         a[4] * b[4] + a[5] * b[5];
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

__device__ __forceinline__ void mat_tvec3(const float* R, const float* v,
                                          float* o) {
  o[0] = R[0] * v[0] + R[3] * v[1] + R[6] * v[2];
  o[1] = R[1] * v[0] + R[4] * v[1] + R[7] * v[2];
  o[2] = R[2] * v[0] + R[5] * v[1] + R[8] * v[2];
}

__device__ __forceinline__ void mat_mul3(const float* A, const float* B,
                                         float* o) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      o[r * 3 + c] = A[r * 3] * B[c] + A[r * 3 + 1] * B[3 + c] +
                     A[r * 3 + 2] * B[6 + c];
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ bool bit(int bits, int d) {
  return (bits >> d) & 1;
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

// Featherstone's motion cross product v x m ([w; v] about one point).
__device__ __forceinline__ void motion_cross(const float* a, const float* b,
                                             float* o) {
  float t[3];
  cross3(a, b, o);
  cross3(a, b + 3, o + 3);
  cross3(a + 3, b, t);
  for (int i = 0; i < 3; ++i) o[3 + i] = o[3 + i] + t[i];
}

// A spatial inertia about O in compact form: mass, h = m c (c the com
// about O) and the rotational inertia about O, Io = Ic + m (|c|^2 I -
// c c^T), symmetric (xx, yy, zz, xy, xz, yz).
struct SpInertia {
  float m, h[3], I[6];
};

// I s for a motion s = [w; v]: [Io w + h x v; m v - h x w].
__device__ __forceinline__ void sp_mul(const SpInertia& S, const float* s,
                                       float* out) {
  const float* w = s;
  const float* v = s + 3;
  float hv[3], hw[3];
  cross3(S.h, v, hv);
  cross3(S.h, w, hw);
  out[0] = S.I[0] * w[0] + S.I[3] * w[1] + S.I[4] * w[2] + hv[0];
  out[1] = S.I[3] * w[0] + S.I[1] * w[1] + S.I[5] * w[2] + hv[1];
  out[2] = S.I[4] * w[0] + S.I[5] * w[1] + S.I[2] * w[2] + hv[2];
  for (int i = 0; i < 3; ++i) out[3 + i] = S.m * v[i] - hw[i];
}

// Per-env state of one forward evaluation.
struct Kin {
  int root[kMaxBodies];       // the root body of each body's tree
  float R[kMaxBodies][9];     // world rotation, row-major
  float p[kMaxBodies][3];     // world frame origin
  float c[kMaxBodies][3];     // world com
  float cvel[kMaxBodies][6];  // spatial velocity about the tree's point
  float cdof[kMaxNv][6];      // motion subspace of each dof about its
                              // tree's point
  float cdd[kMaxNv][6];       // its time derivative
  SpInertia I[kMaxBodies];    // each body's spatial inertia about its
                              // tree's point
};

// The reference point of body b's tree: its root body's origin.
__device__ __forceinline__ const float* origin_of(const Kin& k, int b) {
  return k.p[k.root[b]];
}

// Kinematics (engine.fk): joints applied in declaration order per body;
// each dof's world axis (and, for a rotation, its anchor) taken at its
// place in the sequence; then cdof about the origin of its tree's root.
__device__ void fk(const Tables& tb, const EngineParams& P, const float* q,
                   Kin& k) {
  float ax[kMaxNv][3], an[kMaxNv][3];
  bool rot[kMaxNv];
#pragma unroll 1
  for (int b = 0; b < P.nb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const int par = (int)row[0];
    float* R = k.R[b];
    float* p = k.p[b];
    k.root[b] = par < 0 ? b : k.root[par];
    if (par < 0) {
      for (int i = 0; i < 9; ++i) R[i] = row[6 + i];
      for (int i = 0; i < 3; ++i) p[i] = row[3 + i];
    } else {
      float off[3];
      mat_mul3(k.R[par], row + 6, R);
      mat_vec3(k.R[par], row + 3, off);
      for (int i = 0; i < 3; ++i) p[i] = k.p[par][i] + off[i];
    }
    const int j0 = (int)row[1], nj = (int)row[2];
#pragma unroll 1
    for (int j = j0; j < j0 + nj; ++j) {
      const float* jr = tb.jnt + j * kJntCols;
      const int jt = (int)jr[0], qa = (int)jr[1], va = (int)jr[2];
      const float* jpos = jr + 6;
      if (jt == kFree) {
        for (int i = 0; i < 3; ++i) p[i] = q[qa + i];
        quat_to_mat(q + qa + 3, R);
        for (int kk = 0; kk < 3; ++kk) {
          rot[va + kk] = false;
          for (int i = 0; i < 3; ++i) ax[va + kk][i] = i == kk ? 1.f : 0.f;
          rot[va + 3 + kk] = true;
          for (int i = 0; i < 3; ++i) {
            ax[va + 3 + kk][i] = R[i * 3 + kk];
            an[va + 3 + kk][i] = p[i];
          }
        }
      } else if (jt == kBall) {
        float Rj[9], Rn[9], a[3], t[3];
        quat_to_mat(q + qa, Rj);
        mat_vec3(R, jpos, t);
        for (int i = 0; i < 3; ++i) a[i] = p[i] + t[i];
        mat_mul3(R, Rj, Rn);
        for (int i = 0; i < 9; ++i) R[i] = Rn[i];
        mat_vec3(R, jpos, t);
        for (int i = 0; i < 3; ++i) p[i] = a[i] - t[i];
        for (int kk = 0; kk < 3; ++kk) {
          rot[va + kk] = true;
          for (int i = 0; i < 3; ++i) {
            ax[va + kk][i] = R[i * 3 + kk];
            an[va + kk][i] = a[i];
          }
        }
      } else if (jt == kSlide) {
        float a[3];
        mat_vec3(R, jr + 3, a);
        for (int i = 0; i < 3; ++i) p[i] = p[i] + a[i] * q[qa];
        rot[va] = false;
        for (int i = 0; i < 3; ++i) ax[va][i] = a[i];
      } else {  // hinge: Rj = I + s K + (1 - c) K K, K = skew(world axis)
        float a[3], t[3], anc[3], Rj[9], Rn[9];
        mat_vec3(R, jr + 3, a);
        const float s = sinf(q[qa]), cm = 1.f - cosf(q[qa]);
        const float K[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0],
                            -a[1], a[0], 0.f};
        float KK[9];
        mat_mul3(K, K, KK);
        for (int i = 0; i < 9; ++i)
          Rj[i] = ((i % 4 == 0) ? 1.f : 0.f) + s * K[i] + cm * KK[i];
        mat_vec3(R, jpos, t);
        for (int i = 0; i < 3; ++i) anc[i] = p[i] + t[i];
        mat_mul3(Rj, R, Rn);
        for (int i = 0; i < 9; ++i) R[i] = Rn[i];
        mat_vec3(R, jpos, t);
        for (int i = 0; i < 3; ++i) p[i] = anc[i] - t[i];
        rot[va] = true;
        for (int i = 0; i < 3; ++i) {
          ax[va][i] = a[i];
          an[va][i] = anc[i];
        }
      }
    }
    float cw[3];
    mat_vec3(R, row + 16, cw);
    for (int i = 0; i < 3; ++i) k.c[b][i] = p[i] + cw[i];
  }
#pragma unroll 1
  for (int d = 0; d < P.nv; ++d) {
    float* s = k.cdof[d];
    const float* O = origin_of(k, (int)tb.dof[d * kDofCols]);
    if (rot[d]) {
      const float rel[3] = {an[d][0] - O[0], an[d][1] - O[1],
                            an[d][2] - O[2]};
      for (int i = 0; i < 3; ++i) s[i] = ax[d][i];
      cross3(rel, ax[d], s + 3);
    } else {
      s[0] = s[1] = s[2] = 0.f;
      for (int i = 0; i < 3; ++i) s[3 + i] = ax[d][i];
    }
  }
}

// Body velocities and cdof derivatives (engine.kin_dyn), and each body's
// spatial inertia about its tree's point.
__device__ void kin_dyn(const Tables& tb, const EngineParams& P,
                        const float* v, Kin& k) {
#pragma unroll 1
  for (int b = 0; b < P.nb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const int par = (int)row[0];
    float vel[6];
    for (int i = 0; i < 6; ++i) vel[i] = par < 0 ? 0.f : k.cvel[par][i];
    const int j0 = (int)row[1], nj = (int)row[2];
#pragma unroll 1
    for (int j = j0; j < j0 + nj; ++j) {
      const float* jr = tb.jnt + j * kJntCols;
      const int jt = (int)jr[0], va = (int)jr[2];
      if (jt == kFree || jt == kBall) {
        const int r0 = jt == kFree ? va + 3 : va;  // the rotational dofs
        for (int d = va; d < r0 + 3; ++d) {
          if (d < r0)
            for (int i = 0; i < 6; ++i) k.cdd[d][i] = 0.f;
          for (int i = 0; i < 6; ++i)
            vel[i] = vel[i] + k.cdof[d][i] * v[d];
        }
        // the rotational axes turn with every dof of the joint
        for (int d = r0; d < r0 + 3; ++d) motion_cross(vel, k.cdof[d], k.cdd[d]);
      } else {
        motion_cross(vel, k.cdof[va], k.cdd[va]);
        for (int i = 0; i < 6; ++i) vel[i] = vel[i] + k.cdof[va][i] * v[va];
      }
    }
    for (int i = 0; i < 6; ++i) k.cvel[b][i] = vel[i];
    // Io = R Ic R^T + m (|c|^2 I - c c^T) about the tree's point O
    const float* O = origin_of(k, b);
    const float m = row[15];
    const float Ic[9] = {row[19], row[22], row[23], row[22], row[20],
                         row[24], row[23], row[24], row[21]};
    float T[9], Iw[9];
    mat_mul3(k.R[b], Ic, T);
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc)
        Iw[r * 3 + cc] = T[r * 3] * k.R[b][cc * 3] +
                         T[r * 3 + 1] * k.R[b][cc * 3 + 1] +
                         T[r * 3 + 2] * k.R[b][cc * 3 + 2];
    const float c[3] = {k.c[b][0] - O[0], k.c[b][1] - O[1], k.c[b][2] - O[2]};
    SpInertia& S = k.I[b];
    S.m = m;
    for (int i = 0; i < 3; ++i) S.h[i] = m * c[i];
    const float cxx = m * (c[1] * c[1] + c[2] * c[2]);
    const float cyy = m * (c[0] * c[0] + c[2] * c[2]);
    const float czz = m * (c[0] * c[0] + c[1] * c[1]);
    S.I[0] = Iw[0] + cxx;
    S.I[1] = Iw[4] + cyy;
    S.I[2] = Iw[8] + czz;
    S.I[3] = Iw[1] - m * (c[0] * c[1]);
    S.I[4] = Iw[2] - m * (c[0] * c[2]);
    S.I[5] = Iw[5] - m * (c[1] * c[2]);
  }
}

__device__ __forceinline__ int dof_body(const Tables& tb, int d) {
  return (int)tb.dof[d * kDofCols];
}

__device__ __forceinline__ int chain_bits(const Tables& tb, int b) {
  return (int)tb.body[b * kBodyCols + 25];
}

// Composite-rigid-body mass matrix plus armature: M[a][b] = (I^C s_a) .
// s_b for every dof b <= a on the root path of a's body (engine
// crb_mass_matrix).  Entries between trees stay 0 and are never read.
__device__ void mass_matrix(const Tables& tb, const EngineParams& P,
                            const Kin& k, float M[kMaxNv][kMaxNv]) {
  for (int a = 0; a < P.nv; ++a)
    for (int b = 0; b < P.nv; ++b) M[a][b] = 0.f;
  SpInertia C[kMaxBodies];
  for (int b = 0; b < P.nb; ++b) C[b] = k.I[b];
#pragma unroll 1
  for (int b = P.nb - 1; b >= 1; --b) {  // children after their parents
    const int par = (int)tb.body[b * kBodyCols];
    if (par < 0) continue;
    C[par].m = C[par].m + C[b].m;
    for (int i = 0; i < 3; ++i) C[par].h[i] = C[par].h[i] + C[b].h[i];
    for (int i = 0; i < 6; ++i) C[par].I[i] = C[par].I[i] + C[b].I[i];
  }
#pragma unroll 1
  for (int a = 0; a < P.nv; ++a) {
    const int ba = dof_body(tb, a);
    const int bits = chain_bits(tb, ba);
    float F[6];
    sp_mul(C[ba], k.cdof[a], F);
#pragma unroll 1
    for (int b = 0; b <= a; ++b) {
      if (!bit(bits, b)) continue;
      const float x = dot6(F, k.cdof[b]);
      M[a][b] = x;
      M[b][a] = x;
    }
    M[a][a] = M[a][a] + tb.dof[a * kDofCols + 1];
  }
}

// qfrc_bias = C(q, v) v + gravity by RNE about each tree's point
// (engine.rne_bias).
__device__ void rne_bias(const Tables& tb, const EngineParams& P,
                         const Kin& k, const float* v, float* bias) {
  float acc[kMaxBodies][6], frc[kMaxBodies][6];
#pragma unroll 1
  for (int b = 0; b < P.nb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    const int par = (int)row[0];
    float* a = acc[b];
    if (par < 0) {
      a[0] = a[1] = a[2] = 0.f;
      a[3] = -P.gx; a[4] = -P.gy; a[5] = -P.gz;
    } else {
      for (int i = 0; i < 6; ++i) a[i] = acc[par][i];
    }
    const int j0 = (int)row[1], nj = (int)row[2];
    for (int j = j0; j < j0 + nj; ++j) {
      const float* jr = tb.jnt + j * kJntCols;
      const int jt = (int)jr[0], va = (int)jr[2];
      const int n = jt == kFree ? 6 : (jt == kBall ? 3 : 1);
      for (int d = va; d < va + n; ++d)
        for (int i = 0; i < 6; ++i) a[i] = a[i] + k.cdd[d][i] * v[d];
    }
    // f = I a + v x* (I v), v x* f = [w x m + vl x fl; w x fl]
    float Ia[6], Iv[6], t[3], fx[6];
    sp_mul(k.I[b], a, Ia);
    sp_mul(k.I[b], k.cvel[b], Iv);
    const float* vel = k.cvel[b];
    cross3(vel, Iv, fx);
    cross3(vel + 3, Iv + 3, t);
    for (int i = 0; i < 3; ++i) fx[i] = fx[i] + t[i];
    cross3(vel, Iv + 3, fx + 3);
    for (int i = 0; i < 6; ++i) frc[b][i] = Ia[i] + fx[i];
  }
#pragma unroll 1
  for (int b = P.nb - 1; b >= 1; --b) {
    const int par = (int)tb.body[b * kBodyCols];
    if (par < 0) continue;
    for (int i = 0; i < 6; ++i) frc[par][i] = frc[par][i] + frc[b][i];
  }
  for (int d = 0; d < P.nv; ++d)
    bias[d] = dot6(k.cdof[d], frc[dof_body(tb, d)]);
}

// MuJoCo's inertia-box fluid drag (engine.fluid_force), added into qfrc.
__device__ void fluid_force(const Tables& tb, const EngineParams& P,
                            const Kin& k, float* qfrc) {
#pragma unroll 1
  for (int b = 0; b < P.nb; ++b) {
    const float* row = tb.body + b * kBodyCols;
    if (!(row[15] > 0.f)) continue;
    const float* O = origin_of(k, b);
    const float* R = k.R[b];
    const float com[3] = {k.c[b][0] - O[0], k.c[b][1] - O[1],
                          k.c[b][2] - O[2]};
    const float* ww = k.cvel[b];
    float vw[3], wb[3], vb[3], t[3];
    cross3(ww, com, t);
    for (int i = 0; i < 3; ++i) vw[i] = k.cvel[b][3 + i] + t[i];
    mat_tvec3(R, ww, wb);
    mat_tvec3(R, vw, vb);
    float force[3] = {0.f, 0.f, 0.f}, torque[3] = {0.f, 0.f, 0.f};
    if (P.visc_on) {
      for (int i = 0; i < 3; ++i) {
        force[i] = force[i] - row[26] * vb[i];
        torque[i] = torque[i] - row[27] * wb[i];
      }
    }
    if (P.rho_on) {
      for (int i = 0; i < 3; ++i) {
        force[i] = force[i] - row[28 + i] * fabsf(vb[i]) * vb[i];
        torque[i] = torque[i] - row[31 + i] * fabsf(wb[i]) * wb[i];
      }
    }
    float fs[6], fw[3], tw[3];
    mat_vec3(R, force, fw);
    mat_vec3(R, torque, tw);
    cross3(com, fw, t);
    for (int i = 0; i < 3; ++i) {
      fs[i] = tw[i] + t[i];
      fs[3 + i] = fw[i];
    }
    const int bits = chain_bits(tb, b);
    for (int d = 0; d < P.nv; ++d)
      if (bit(bits, d)) qfrc[d] = qfrc[d] + dot6(k.cdof[d], fs);
  }
}

// M^-1 per kinematic tree by the Cholesky factor (linalg.spd_inverse,
// pivots clamped at 1e-12): M's block is overwritten with L.
__device__ void tree_inverse(const Tables& tb, const EngineParams& P,
                             float M[kMaxNv][kMaxNv],
                             float Minv[kMaxNv][kMaxNv]) {
  int lo = 0;
#pragma unroll 1
  while (lo < P.nv) {
    const int hi = (int)tb.dof[lo * kDofCols + 4];
#pragma unroll 1
    for (int j = lo; j < hi; ++j) {
      for (int i = j; i < hi; ++i) {
        float s = M[i][j];
        for (int kk = lo; kk < j; ++kk) s = s - M[i][kk] * M[j][kk];
        M[i][j] = s;
      }
      const float d = sqrtf(fmaxf(M[j][j], 1e-12f));
      for (int i = j; i < hi; ++i) M[i][j] = M[i][j] / d;
    }
#pragma unroll 1
    for (int c = lo; c < hi; ++c) {
      for (int i = lo; i < hi; ++i) {
        float acc = i == c ? 1.f : 0.f;
        for (int kk = lo; kk < i; ++kk) acc = acc - M[i][kk] * Minv[kk][c];
        Minv[i][c] = acc / M[i][i];
      }
      for (int i = hi - 1; i >= lo; --i) {
        float acc = Minv[i][c];
        for (int kk = i + 1; kk < hi; ++kk)
          acc = acc - M[kk][i] * Minv[kk][c];
        Minv[i][c] = acc / M[i][i];
      }
    }
    lo = hi;
  }
}

// y = M^-1 x within the trees.
__device__ void minv_mul(const Tables& tb, const EngineParams& P,
                         const float Minv[kMaxNv][kMaxNv], const float* x,
                         float* y) {
  for (int i = 0; i < P.nv; ++i) {
    const int lo = (int)tb.dof[i * kDofCols + 3];
    const int hi = (int)tb.dof[i * kDofCols + 4];
    float s = 0.f;
    for (int j = lo; j < hi; ++j) s = s + Minv[i][j] * x[j];
    y[i] = s;
  }
}

// Sphere (centre c, radius r) against a box (centre bc, half bh, in the
// frame of the 3x3 rotation R, or axis-aligned when R is null)
// (contact.py _detect): signed distance, world point and normal.
__device__ void sphere_box(const float* c, float r, const float* bc,
                           const float* bh, const float* R, float* dist,
                           float* pos, float* n, bool* inside) {
  float d[3], local[3], cl[3], delta[3];
  for (int i = 0; i < 3; ++i) d[i] = c[i] - bc[i];
  if (R) {
    mat_tvec3(R, d, local);
  } else {
    for (int i = 0; i < 3; ++i) local[i] = d[i];
  }
  for (int i = 0; i < 3; ++i) {
    cl[i] = fmaxf(fminf(local[i], bh[i]), -bh[i]);
    delta[i] = local[i] - cl[i];
  }
  const float d_out = sqrtf(delta[0] * delta[0] + delta[1] * delta[1] +
                            delta[2] * delta[2] + 1e-12f);
  const bool outside = d_out > 1e-6f;
  const float ex = bh[0] - fabsf(local[0]);
  const float ey = bh[1] - fabsf(local[1]);
  const float ez = bh[2] - fabsf(local[2]);
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
  float nl[3], surf[3];
  for (int i = 0; i < 3; ++i) {
    nl[i] = outside ? delta[i] / d_out : nin[i];
    surf[i] = outside ? cl[i] : local[i] - nin[i] * pen_in;
  }
  if (R) {
    float t[3];
    mat_vec3(R, nl, n);
    mat_vec3(R, surf, t);
    for (int i = 0; i < 3; ++i) pos[i] = bc[i] + t[i];
  } else {
    for (int i = 0; i < 3; ++i) {
      n[i] = nl[i];
      pos[i] = bc[i] + surf[i];
    }
  }
}

// Append one active contact to the scratch list: its three rows over the
// dofs of both bodies' root paths (sign + on body a's, the sphere's, - on
// body b's, the second sphere's or the box's, body b -1 for the static
// world; 0 on the dofs the two paths share), each path's columns with the
// moment arm about its tree's point,
// the impedance constants, A = J M^-1 J^T, aref - a0, R and the
// denominator (contact.py contact_qfrc).  par = (mu, d0, dmax, width, tc,
// dampr).
__device__ void add_contact(const Tables& tb, const EngineParams& P,
                            const Kin& k, const float Minv[kMaxNv][kMaxNv],
                            const float* v, const float* qacc0,
                            const float* par, int body_a, int body_b,
                            const float* pos, const float* nrm, float dist,
                            float margin, const Scratch& S, int slot) {
  const int nv = P.nv;
  const float mu = par[0], d0 = par[1], dmax = par[2], width = par[3];
  const float tc = par[4], dampr = par[5];
  const bool use_x = fabsf(nrm[0]) < 0.5f;
  const float ref[3] = {use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f};
  float t1[3], t2[3];
  cross3(nrm, ref, t1);
  const float tn = sqrtf(dot3(t1, t1) + 1e-12f);
  for (int i = 0; i < 3; ++i) t1[i] = t1[i] / tn;
  cross3(nrm, t1, t2);
  const float* dirs[3] = {nrm, t1, t2};
  const int bits_a = chain_bits(tb, body_a);
  const int bits_b = body_b < 0 ? 0 : chain_bits(tb, body_b);
  const float* Oa = origin_of(k, body_a);
  const float* Ob = origin_of(k, body_b < 0 ? body_a : body_b);
  const float rel_a[3] = {pos[0] - Oa[0], pos[1] - Oa[1], pos[2] - Oa[2]};
  const float rel_b[3] = {pos[0] - Ob[0], pos[1] - Ob[1], pos[2] - Ob[2]};
  const int bits = bits_a | bits_b;
  const float r = dist - margin;
  const float b_imp = 2.f / (dmax * tc);
  const float imp = d0 + (dmax - d0) * clampf(-r / width, 0.f, 1.f);
  const float k_imp = imp / (dmax * dmax * tc * tc * dampr * dampr);
  const float rfac = (1.f - imp) / fmaxf(imp, 1e-6f);
#pragma unroll 1
  for (int rr = 0; rr < 3; ++rr) {
    float Fa[6], Fb[6];
    cross3(rel_a, dirs[rr], Fa);
    cross3(rel_b, dirs[rr], Fb);
    for (int i = 0; i < 3; ++i) Fa[3 + i] = Fb[3 + i] = dirs[rr][i];
    float J[kMaxNv];
    for (int d = 0; d < nv; ++d) {
      const int s = (int)bit(bits_a, d) - (int)bit(bits_b, d);
      J[d] = s > 0 ? dot6(Fa, k.cdof[d])
                   : (s < 0 ? -dot6(Fb, k.cdof[d]) : 0.f);
      S.at(slot, rr * nv + d) = J[d];
    }
    float A = 0.f, vr = 0.f, ar = 0.f;
    for (int i = 0; i < nv; ++i) {
      if (!bit(bits, i)) continue;
      const int lo = (int)tb.dof[i * kDofCols + 3];
      const int hi = (int)tb.dof[i * kDofCols + 4];
      float s = 0.f;
      for (int j = lo; j < hi; ++j)
        if (bit(bits, j)) s = s + J[j] * Minv[j][i];
      A = A + s * J[i];
      vr = vr + J[i] * v[i];
      ar = ar + J[i] * qacc0[i];
    }
    const float aref = rr == 0 ? -b_imp * vr - k_imp * r : -b_imp * vr;
    const float rreg = rfac * A;
    S.at(slot, 3 * nv + rr) = aref - ar;
    S.at(slot, 3 * nv + 3 + rr) = rreg;
    S.at(slot, 3 * nv + 6 + rr) = A + rreg + 1e-9f;
  }
  S.at(slot, 3 * nv + 12) = mu;
}

// Friction-cone projection of a contact's (f_n, f_t1, f_t2).
__device__ __forceinline__ void project(float mu, float* f) {
  const float fn = fmaxf(f[0], 0.f);
  const float ftn = sqrtf(f[1] * f[1] + f[2] * f[2] + 1e-12f);
  const float scale = fminf(mu * fn / ftn, 1.f);
  f[0] = fn;
  f[1] = f[1] * scale;
  f[2] = f[2] * scale;
}

// The trace bits of one active candidate: active, centre inside its box,
// tangent frame off the x axis.
__device__ __forceinline__ void mark(int* trace, int nw, int id, bool inside,
                                     const float* n) {
  if (!trace) return;
  const int w = id >> 5;
  const int m = (int)(1u << (id & 31));
  trace[w] |= m;
  if (inside) trace[nw + w] |= m;
  if (fabsf(n[0]) < 0.5f) trace[2 * nw + w] |= m;
}

// Contact detection, the compacted active list and the projected-Jacobi
// solve; adds the contact force into fc.  Returns the active count.
__device__ int contact_force(const Tables& tb, const EngineParams& P,
                             const Kin& k, const float Minv[kMaxNv][kMaxNv],
                             const float* v, const float* qacc0, float* fc,
                             const Scratch& S, int* trace) {
  const int nv = P.nv;
  const int nw = (P.n_cand + 31) >> 5;
  const int groups = P.has_floor + P.n_pick;
  int nc = 0;
#pragma unroll 1
  for (int s = 0; s < P.n_sph; ++s) {
    const float* sp = tb.sph + s * kSphCols;
    const int ks = (int)sp[13];
    if (ks < 0) continue;  // meets no static geom
    const int body = (int)sp[0];
    float c[3];
    mat_vec3(k.R[body], sp + 1, c);
    for (int i = 0; i < 3; ++i) c[i] = k.p[body][i] + c[i];
    const float r = sp[4];
    if (P.has_floor) {
      const float dist = (c[2] - P.floor_z) - r;
      if (dist < sp[6]) {
        const float pos[3] = {c[0], c[1], c[2] - r};
        const float up[3] = {0.f, 0.f, 1.f};
        mark(trace, nw, ks, false, up);
        add_contact(tb, P, k, Minv, v, qacc0, sp + 7, body, -1, pos, up,
                    dist, sp[6], S, nc++);
      }
    }
    // the two nearest static boxes by dist - box margin (strict <); a
    // pick no box filled stays at an infinite distance, never active
    float best_e[2] = {INFINITY, INFINITY}, best_d[2] = {INFINITY, INFINITY};
    float best_p[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float best_n[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float best_m[2] = {0.f, 0.f};
    bool best_in[2] = {false, false};
#pragma unroll 1
    for (int b = 0; b < P.n_box; ++b) {
      const float* bx = tb.box + b * kBoxCols;
      float dist, pos[3], n[3];
      bool inside;
      sphere_box(c, r, bx, bx + 3, nullptr, &dist, pos, n, &inside);
      const float e = dist - bx[6];
      const bool b1 = e < best_e[0];
      const bool b2 = !b1 && e < best_e[1];
      if (b1) {
        best_e[1] = best_e[0]; best_d[1] = best_d[0]; best_m[1] = best_m[0];
        best_in[1] = best_in[0];
        for (int i = 0; i < 3; ++i) {
          best_p[1][i] = best_p[0][i];
          best_n[1][i] = best_n[0][i];
        }
        best_e[0] = e; best_d[0] = dist; best_m[0] = bx[6];
        best_in[0] = inside;
        for (int i = 0; i < 3; ++i) {
          best_p[0][i] = pos[i];
          best_n[0][i] = n[i];
        }
      } else if (b2) {
        best_e[1] = e; best_d[1] = dist; best_m[1] = bx[6];
        best_in[1] = inside;
        for (int i = 0; i < 3; ++i) {
          best_p[1][i] = pos[i];
          best_n[1][i] = n[i];
        }
      }
    }
    for (int j = 0; j < P.n_pick; ++j) {
      const float margin = sp[5] + best_m[j];
      if (best_d[j] < margin) {
        mark(trace, nw, (P.has_floor + j) * P.n_static + ks, best_in[j],
             best_n[j]);
        add_contact(tb, P, k, Minv, v, qacc0, sp + 7, body, -1, best_p[j],
                    best_n[j], best_d[j], margin, S, nc++);
      }
    }
  }
  // every sphere-sphere pair: the normal from sphere j's centre to sphere
  // i's, the point midway through the overlap (contact.py _detect)
#pragma unroll 1
  for (int ps = 0; ps < P.n_spair; ++ps) {
    const float* pr = tb.spair + ps * kPairCols;
    const float* si = tb.sph + (int)pr[0] * kSphCols;
    const float* sj = tb.sph + (int)pr[1] * kSphCols;
    const int bi = (int)si[0], bj = (int)sj[0];
    float ci[3], cj[3], d[3];
    mat_vec3(k.R[bi], si + 1, ci);
    mat_vec3(k.R[bj], sj + 1, cj);
    for (int i = 0; i < 3; ++i) {
      ci[i] = k.p[bi][i] + ci[i];
      cj[i] = k.p[bj][i] + cj[i];
      d[i] = ci[i] - cj[i];
    }
    const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12f);
    const float n[3] = {d[0] / dn, d[1] / dn, d[2] / dn};
    const float rj = sj[4];
    const float dist = dn - (si[4] + rj);
    const float margin = pr[2];  // the two spheres' margins summed
    if (dist < margin) {
      const float reach = rj + dist * 0.5f;
      const float pos[3] = {cj[0] + n[0] * reach, cj[1] + n[1] * reach,
                            cj[2] + n[2] * reach};
      mark(trace, nw, groups * P.n_static + ps, false, n);
      add_contact(tb, P, k, Minv, v, qacc0, pr + 3, bi, bj, pos, n, dist,
                  margin, S, nc++);
    }
  }
  // every sphere-vs-moving-box pair, in the box's frame
#pragma unroll 1
  for (int qp = 0; qp < P.n_pair; ++qp) {
    const float* pr = tb.pair + qp * kPairCols;
    const float* sp = tb.sph + (int)pr[0] * kSphCols;
    const float* db = tb.dbox + (int)pr[1] * kDboxCols;
    const int sb = (int)sp[0], bb = (int)db[0];
    float c[3], bc[3];
    mat_vec3(k.R[sb], sp + 1, c);
    for (int i = 0; i < 3; ++i) c[i] = k.p[sb][i] + c[i];
    mat_vec3(k.R[bb], db + 1, bc);
    for (int i = 0; i < 3; ++i) bc[i] = k.p[bb][i] + bc[i];
    float dist, pos[3], n[3];
    bool inside;
    sphere_box(c, sp[4], bc, db + 4, k.R[bb], &dist, pos, n, &inside);
    if (dist < pr[2]) {
      mark(trace, nw, groups * P.n_static + P.n_spair + qp, inside, n);
      add_contact(tb, P, k, Minv, v, qacc0, pr + 3, sb, bb, pos, n, dist,
                  pr[2], S, nc++);
    }
  }
  if (nc == 0) return 0;
  // projected Jacobi on (A + R) f = aref - a0, all rows in parallel
  const int fb = 3 * nv;  // rhs at fb, rreg fb + 3, denom fb + 6, f fb + 9
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    float f[3];
    for (int r = 0; r < 3; ++r)
      f[r] = S.at(i, fb + r) / S.at(i, fb + 6 + r);
    project(S.at(i, fb + 12), f);
    for (int r = 0; r < 3; ++r) S.at(i, fb + 9 + r) = f[r];
  }
#pragma unroll 1
  for (int it = 0; it < P.solver_iters; ++it) {
    float x[kMaxNv], y[kMaxNv];
    for (int d = 0; d < nv; ++d) x[d] = 0.f;
#pragma unroll 1
    for (int i = 0; i < nc; ++i) {
      const float f0 = S.at(i, fb + 9), f1 = S.at(i, fb + 10),
                  f2 = S.at(i, fb + 11);
      for (int d = 0; d < nv; ++d)
        x[d] = x[d] + (S.at(i, d) * f0 + S.at(i, nv + d) * f1 +
                       S.at(i, 2 * nv + d) * f2);
    }
    minv_mul(tb, P, Minv, x, y);
#pragma unroll 1
    for (int i = 0; i < nc; ++i) {
      float f[3];
      for (int r = 0; r < 3; ++r) {
        float af = 0.f;
        for (int d = 0; d < nv; ++d) af = af + S.at(i, r * nv + d) * y[d];
        const float cur = S.at(i, fb + 9 + r);
        const float resid = S.at(i, fb + r) - af - S.at(i, fb + 3 + r) * cur;
        f[r] = cur + P.omega * resid / S.at(i, fb + 6 + r);
      }
      project(S.at(i, fb + 12), f);
      for (int r = 0; r < 3; ++r) S.at(i, fb + 9 + r) = f[r];
    }
  }
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    const float f0 = S.at(i, fb + 9), f1 = S.at(i, fb + 10),
                f2 = S.at(i, fb + 11);
    for (int d = 0; d < nv; ++d)
      fc[d] = fc[d] + (S.at(i, d) * f0 + S.at(i, nv + d) * f1 +
                       S.at(i, 2 * nv + d) * f2);
  }
  return nc;
}

// The falling blocks' coupled platform support and z limit
// (contact.py falling_support_force): the net force on the z dof; *rows:
// which rows the solve takes (0 neither, 1 the platform's, 2 the limit's,
// 3 both).
__device__ float falling_support(const EngineParams& P, float z, float bottom,
                                 float s, float vz, float a0, float w,
                                 int* rows) {
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

// qacc of one forward evaluation (engine.forward with the contact and
// support forces).  Adds the active-contact count to *n_active; fills
// this evaluation's trace words when trace is not null.
__device__ void forward(const Tables& tb, const EngineParams& P,
                        const float* q, const float* v, const float* ctrl,
                        float* qacc, const Scratch& S, int* n_active,
                        int* trace) {
  const int nv = P.nv;
  Kin k;
  fk(tb, P, q, k);
  kin_dyn(tb, P, v, k);
  float M[kMaxNv][kMaxNv], Minv[kMaxNv][kMaxNv];
  mass_matrix(tb, P, k, M);
  float bias[kMaxNv], tau[kMaxNv], fl[kMaxNv];
  rne_bias(tb, P, k, v, bias);
  for (int d = 0; d < nv; ++d) {
    tau[d] = 0.f;
    fl[d] = 0.f;
  }
  for (int u = 0; u < P.nu; ++u) {
    const float* a = tb.act + u * kActCols;
    const int d = (int)a[0];
    tau[d] = tau[d] + a[1] * clampf(ctrl[u], a[2], a[3]);
  }
  if (P.visc_on || P.rho_on) {
    fluid_force(tb, P, k, fl);
    for (int d = 0; d < nv; ++d) tau[d] = tau[d] + fl[d];
  }
  for (int d = 0; d < nv; ++d)
    tau[d] = tau[d] - tb.dof[d * kDofCols + 2] * v[d];
  tree_inverse(tb, P, M, Minv);
  float rhs[kMaxNv], qacc0[kMaxNv], flim[kMaxNv], fc[kMaxNv], fsup[kMaxNv];
  for (int d = 0; d < nv; ++d) {
    rhs[d] = tau[d] - bias[d];
    flim[d] = 0.f;
    fc[d] = 0.f;
    fsup[d] = 0.f;
  }
  minv_mul(tb, P, Minv, rhs, qacc0);
  const int nw = (P.n_cand + 31) >> 5;
  if (trace)
    for (int w = 0; w < P.trace_words; ++w) trace[w] = 0;
  // joint limits (engine.limit_force), in joint order
  uint32_t lim_bits = 0u;
  int n_lim = 0;
#pragma unroll 1
  for (int j = 0; j < P.nj; ++j) {
    const float* jr = tb.jnt + j * kJntCols;
    if (jr[9] == 0.f) continue;
    const int qa = (int)jr[1], d = (int)jr[2];
    const float lo = jr[10], hi = jr[11];
    const float qd = q[qa], vd = v[d], a0 = qacc0[d];
    const float m_eff = 1.f / fmaxf(Minv[d][d], 1e-12f);
    float f = 0.f;
    bool on = false;
    for (int side = 0; side < 2; ++side) {
      const float sign = side == 0 ? 1.f : -1.f;
      const float viol = side == 0 ? fmaxf(qd - hi, 0.f) : fmaxf(lo - qd, 0.f);
      const float dimp =
          P.lim_d0 + P.lim_dd * clampf(viol / P.lim_width, 0.f, 1.f);
      const float kimp = dimp / P.lim_kden;
      const float aref = -P.lim_b * (sign * vd) - kimp * viol;
      const float f_out = fminf(m_eff * dimp * (aref - sign * a0), 0.f);
      f = f + (viol > 0.f ? sign * f_out : 0.f);
      on = on || viol > 0.f;
    }
    flim[d] = f;
    if (on) lim_bits |= 1u << n_lim;
    ++n_lim;
  }
  *n_active += contact_force(tb, P, k, Minv, v, qacc0, fc, S, trace);
  // falling blocks: the support against the highest platform top their
  // body's origin overlaps (else the floor)
#pragma unroll 1
  for (int f = 0; f < P.n_fall; ++f) {
    const float* fr = tb.fall + f * kFallCols;
    const int b = (int)fr[0], zd = (int)fr[1];
    const float bpz = fr[5];
    const float* c = k.p[b];
    const float z = c[2] - bpz;
    const float bottom = bpz + z - fr[2];
    float s = 0.f;
    for (int pi = 0; pi < (int)fr[4]; ++pi) {
      const float* pl = tb.plat + ((int)fr[3] + pi) * kPlatCols;
      const bool over = fabsf(c[0] - pl[0]) < pl[2] &&
                        fabsf(c[1] - pl[1]) < pl[3];
      s = fmaxf(s, over ? pl[4] : 0.f);
    }
    int rows;
    fsup[zd] = fsup[zd] + falling_support(P, z, bottom, s, v[zd], qacc0[zd],
                                          Minv[zd][zd] + 1e-12f, &rows);
    lim_bits |= (uint32_t)rows << (24 + 2 * f);
  }
  if (trace) trace[3 * nw] = (int)lim_bits;
  for (int d = 0; d < nv; ++d)
    rhs[d] = (tau[d] + (flim[d] + (fc[d] + fsup[d]))) - bias[d];
  minv_mul(tb, P, Minv, rhs, qacc);
}

// q + v h per joint (engine.integrate_pos): the free joint's position
// linear and its quaternion by the body-frame exponential, a ball joint's
// quaternion likewise, hinges and slides linear.
__device__ void quat_step(const float* q, const float* w, float h, float* o) {
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

__device__ void integrate(const Tables& tb, const EngineParams& P,
                          const float* q, const float* v, float h,
                          float* out) {
#pragma unroll 1
  for (int j = 0; j < P.nj; ++j) {
    const float* jr = tb.jnt + j * kJntCols;
    const int jt = (int)jr[0], qa = (int)jr[1], va = (int)jr[2];
    if (jt == kFree) {
      for (int i = 0; i < 3; ++i) out[qa + i] = q[qa + i] + v[va + i] * h;
      quat_step(q + qa + 3, v + va + 3, h, out + qa + 3);
    } else if (jt == kBall) {
      quat_step(q + qa, v + va, h, out + qa);
    } else {
      out[qa] = q[qa] + v[va] * h;
    }
  }
}

// One RK4 step (engine.rk4_step: the four stages in order).
__device__ void rk4(const Tables& tb, const EngineParams& P, float* q,
                    float* v, const float* ctrl, const Scratch& S,
                    int* n_active, int* trace) {
  const int nv = P.nv, nq = P.nq;
  float prev_v[kMaxNv], prev_a[kMaxNv], acc_v[kMaxNv], acc_a[kMaxNv];
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
    float qs[kMaxNq], vs[kMaxNv], as[kMaxNv];
    integrate(tb, P, q, prev_v, hs, qs);
    for (int d = 0; d < nv; ++d) vs[d] = v[d] + prev_a[d] * hs;
    forward(tb, P, qs, vs, ctrl, as, S, n_active,
            trace ? trace + st * P.trace_words : nullptr);
    for (int d = 0; d < nv; ++d) {
      prev_v[d] = vs[d];
      prev_a[d] = as[d];
      acc_v[d] = acc_v[d] + w * vs[d];
      acc_a[d] = acc_a[d] + w * as[d];
    }
  }
  float vavg[kMaxNv], qn[kMaxNq];
  for (int d = 0; d < nv; ++d) vavg[d] = acc_v[d] / 6.f;
  integrate(tb, P, q, vavg, P.h, qn);
  for (int i = 0; i < nq; ++i) q[i] = qn[i];
  for (int d = 0; d < nv; ++d) v[d] = v[d] + (acc_a[d] / 6.f) * P.h;
}

// One env step: frame_skip RK4 steps, the inner reward, t + 1 and the
// task heads on the anchor (first hit wins).  No reset.
__device__ void engine_step(const Tables& tb, const EngineParams& P, float* q,
                            float* v, int* t, const float* ctrl,
                            float* reward, bool* term, const Scratch& S,
                            int* n_active, int* trace) {
  const float x0 = q[0], y0 = q[1];
#pragma unroll 1
  for (int fs = 0; fs < P.frame_skip; ++fs)
    rk4(tb, P, q, v, ctrl, S, n_active,
        trace ? trace + fs * 4 * P.trace_words : nullptr);
  const float vx = (q[0] - x0) / P.dt_outer, vy = (q[1] - y0) / P.dt_outer;
  const float fwd = sqrtf(vx * vx + vy * vy);
  float csq = 0.f;
  for (int u = 0; u < P.nu; ++u) csq = csq + ctrl[u] * ctrl[u];
  const float inner = P.fwd_weight * fwd - P.ctrl_weight * csq;
  const float hx = (P.head_q0 >= 0 ? q[P.head_q0] : 0.f) + P.head_b0;
  const float hy = (P.head_q1 >= 0 ? q[P.head_q1] : 0.f) + P.head_b1;
  const float hz = (P.head_q2 >= 0 ? q[P.head_q2] : 0.f) + P.head_b2;
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

}  // namespace mmt_eng
