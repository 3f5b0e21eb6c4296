// The generic engine step: one env step of any engine-world robot (a custom
// robot composed through the extension API) over runtime tables of the
// model and the world, by a group of G lanes per env.  engine_lane.cu
// instantiates the smallest size class and holds the C entry points;
// engine_mid.cu and engine_large.cu instantiate the two larger classes, so
// the three builds run side by side.
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
//   * kinematics of every body (FREE, BALL, SLIDE and HINGE joints, each
//     joint's axis and anchor taken at its place in the sequence), and
//     each dof's motion subspace cdof and its derivative about its
//     kinematic tree's reference point, the origin of the tree's root body
//     (where float32 keeps each tree at its own scale: the robot, a block,
//     a free ball; physics/engine.py);
//   * the mass matrix by composite rigid bodies (M[a][b] = (I^C s_a) . s_b
//     for b on the root path of a's body), plus armature; its Cholesky
//     factor and inverse per kinematic tree (M is block diagonal over the
//     trees: a robot, each movable block, each ball);
//   * the RNE bias (gravity as the fictitious base acceleration, velocity
//     products), MuJoCo's inertia-box fluid drag, actuation and damping;
//   * impedance joint limits (physics/engine.py limit_force) from the
//     smooth acceleration qacc0;
//   * contacts: every test sphere that meets the world against the floor
//     plane and the two nearest static boxes (by dist - box margin, strict
//     <), every sphere-sphere pair (a robot's sphere and an object ball's:
//     the normal along the centre line, the point midway through the
//     overlap) and every sphere-vs-moving-box pair in the box's frame; a
//     contact is active when dist < margin, with 3 pyramid rows (normal,
//     two tangents) over the dofs of both bodies' root paths, + on the
//     first body's and - on the second's, each tree's columns with the
//     moment arm about its own reference point; projected Jacobi,
//     solver_iters sweeps, omega 0.6, on the regularised Delassus diagonal
//     (physics/contact.py contact_qfrc);
//   * the falling blocks' coupled platform support and z limit
//     (physics/contact.py falling_support_force);
//   * qacc = M^-1 (tau + f_con - bias).
// Then the inner reward fwd_weight |dxy| / dt - ctrl_weight |a|^2 on the
// raw action (scaled), t + 1, and the task heads on the anchor: the
// robot's qpos[0:3], the first object ball's centre or the first block's.
//
// Design.  A group of G lanes steps one env (G a template parameter that
// each size class fixes: 8 in the two smaller ones, a warp in the largest),
// `groups` envs a block; ops/lane_env.py engine_geometry picks the size
// class and the envs a block from the model's own sizes.  The
// public (B, nq) / (B, nv) row-major tensors are read in place with their
// row strides.  Every model datum is a runtime table, staged by each block
// into shared memory, so one build of a class serves every model within
// its bounds: the bodies, joints, dofs, actuators, test spheres, static
// boxes, moving boxes, sphere-sphere pairs, sphere-box pairs, falling
// blocks, platforms and goals.  After the tables come integer lists the
// block derives once (struct BlockLists: per dof its tree and body, per
// body its parent, joints, depth and root-path dofs, per joint its type
// and addresses, M's entries), then each group's state, laid out by the
// wrapper from the model's sizes and passed in EngineParams (the o_*
// offsets): the pose and velocity, the RK4 stages, the body poses and
// spatial quantities, cdof, M and M^-1 as one block per kinematic tree
// (sum of the trees' squares, not nv^2), the force vectors, and one slot
// per candidate contact: its detection record (bodies, point, normal,
// distance, margin), its three rows over the nv dofs, rhs, regulariser,
// denominator, force and friction.  Nothing goes to global memory but the
// outputs.  The size class (NV dofs, NB bodies: 4/2, 12/4, 24/16) bounds
// the lane loops at compile time so that they unroll and their arrays stay
// in registers.  The lanes share the work:
//   * the kinematics, the body velocities and the RNE forward pass, level
//     by level down the body tree (lanes over the bodies of a level); the
//     spatial inertias and RNE forces with lanes over the bodies; the
//     composite inertias and the RNE backward sums with lanes over their
//     16 components, in body order;
//   * the mass matrix with lanes over its entries (the lower triangle of
//     each tree's block); the factor, tree by tree, with lane i holding
//     row i of L in registers (the pivot row's entries by shuffles), the
//     inverse with lane c solving for column c (a tree has at most G dofs);
//   * detection: each static sphere's box tests split over a sub-group of
//     lanes (the width that takes the fewest tests and merge rounds), the
//     nearest two merged across it by (key, box index) with shuffles, so
//     that the pick is the serial scan's (first of equal keys wins); lanes
//     over the sphere-sphere and sphere-box pairs;
//   * the active list compacted in slot order with a ballot and a prefix
//     count (slots sphere by sphere: floor, two boxes; then the pairs), so
//     that the force sums keep the plain version's contact order;
//   * the rows with one lane per contact row (G / 3 contacts a round), the
//     three rows' projection by shuffles; each Jacobi sweep's J^T f and
//     M^-1 x with lanes over the dofs and each row's J y and update with
//     lanes over the rows (the sums in the one-thread version's order, so
//     the two agree to the bit);
//   * J^T f, M^-1 products, the RK4 vector updates and the force sums with
//     lanes over the dofs; the integration with lanes over the joints.
// The warp's groups run the same control flow in lockstep (struct Ctx), so
// syncs and collectives take the whole warp.
//
// What bounds it on an H100.  A step reads and writes a few dozen floats
// per env; it does 10^4 (the Roller) to 10^6 (the Ant model) fp32
// operations per env-step: it is bound by operations, and far from that
// bound each group runs a chain of dependent steps (shared-memory loads
// of ~30 cycles, IEEE divisions and square roots of ~60, shuffles of ~25,
// measured on an NVIDIA H100 80GB HBM3 at 700 W): the levels, each factor
// column and substitution, each contact's rows, the four sweeps.  The
// chain, not the card's throughput, sets the time: a forward evaluation
// of the Roller takes the same SM cycles with 8 envs on that card as with
// 4096 (PERF.md).
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase counters of a profiling build (nvcc -DMMT_ENGINE_PHASES;
// chip_smoke.py --engine-phases): lane 0 of each group adds the clock64()
// cycles of each phase of a forward evaluation (and of the RK4 updates and
// integration around it) into g_engine_phases[phase], and counts the
// evaluations in g_engine_phases[kEngPhaseCount]; each .cu file reads its
// own counters through ENGINE_PHASES_READER.  Without the macro they
// compile to nothing.
enum EnginePhase {
  kEngKinematics, kEngMassMatrix, kEngBias, kEngFactor, kEngLimits,
  kEngDetect, kEngRows, kEngSweeps, kEngQacc, kEngIntegrate, kEngPhaseCount
};
#ifdef MMT_ENGINE_PHASES
static __device__ unsigned long long g_engine_phases[kEngPhaseCount + 1];
#define ENG_PHASE_START long long eng_t0_ = clock64();
#define ENG_PHASE(i)                                                     \
  {                                                                      \
    const long long eng_t1_ = clock64();                                 \
    if (cx.lane == 0)                                                    \
      atomicAdd(&g_engine_phases[i],                                     \
                (unsigned long long)(eng_t1_ - eng_t0_));                \
    eng_t0_ = eng_t1_;                                                   \
  }
#define ENG_PHASE_RESTART eng_t0_ = clock64();
#define ENG_COUNT_EVAL \
  if (cx.lane == 0) atomicAdd(&g_engine_phases[kEngPhaseCount], 1ull);
static const unsigned long long kEnginePhasesZero[kEngPhaseCount + 1] = {};
// name(out) copies the counters to out, or zeroes them where out is null
#define ENGINE_PHASES_READER(name)                                         \
  extern "C" int name(unsigned long long* out) {                           \
    return out ? (int)cudaMemcpyFromSymbol(out, g_engine_phases,           \
                                           sizeof(g_engine_phases))        \
               : (int)cudaMemcpyToSymbol(g_engine_phases,                  \
                                         kEnginePhasesZero,                \
                                         sizeof(g_engine_phases));         \
  }
#else
#define ENG_PHASE_START
#define ENG_PHASE(i)
#define ENG_PHASE_RESTART
#define ENG_COUNT_EVAL
#define ENGINE_PHASES_READER(name)
#endif

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
  // the layout (ops/lane_env.py engine_geometry): tree levels, M's floats
  // (the trees' blocks), M's lower-triangle entries, the largest tree's
  // dofs, the block's lists (floats after the staged tables) and each
  // group's floats
  int n_levels, m_floats, n_mpairs, tree_max, blk_floats, g_floats;
  // each group's fields, floats from the group's base
  int o_q, o_v, o_ctrl, o_qs, o_vs, o_as, o_accv, o_acca;
  int o_R, o_p, o_c, o_cvel, o_I, o_C, o_acc, o_frc, o_fs, o_root;
  int o_cdof, o_cdd, o_ax, o_an, o_rot;
  int o_M, o_Minv;
  int o_bias, o_tau, o_qacc0, o_flim, o_fsup, o_fc, o_x, o_y;
  int o_flags, o_slot, o_list;
  // the block's lists (struct BlockLists), ints from the end of the
  // staged tables
  int b_rowoff, b_dinfo, b_binfo, b_chain, b_jinfo, b_static, b_mpairs;
};

namespace {
namespace mmt_eng {

// compile-time caps (ops/lane_env.py ENGINE_CAPS mirrors them)
constexpr int kMaxBodies = 16;
constexpr int kMaxNv = 24;     // the dof bit sets are exact in float32
constexpr int kMaxNq = 32;
constexpr int kMaxNu = 16;
constexpr int kMaxTableFloats = 12288;  // 48 KB of shared memory
constexpr int kMaxThreads = 256;        // threads a block
// the size classes: dof and body bounds (ops/lane_env.py ENGINE_CLASSES,
// beside each class's lanes an env)
constexpr int kSmallNv = 4, kSmallNb = 2;
constexpr int kMidNv = 12, kMidNb = 4;
constexpr int kLargeNv = kMaxNv, kLargeNb = kMaxBodies;
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
// A candidate contact's slot: its record (kRec floats: active, body a,
// body b (-1: the static world), the offset of its constants (mu, d0,
// dmax, width, tc, dampr) in the tables, point 3, normal 3, distance,
// margin, inside, trace bit), then its three rows over the nv dofs and
// kRowFixed floats after them (ROW_FIXED in ops/engine_kernel.py): rhs3,
// rreg3, denom3, f3, mu.  A slot holds kRec + row_floats floats.
constexpr int kRec = 14;
constexpr int kRowFixed = 13;
// SpInertia's floats, and the composite pass's components (C and frc)
constexpr int kSpFloats = 10;
constexpr int kComponents = kSpFloats + 6;

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
  const float* base;   // the staged buffer (a slot's constants offset)
};

__device__ __forceinline__ Tables tables_at(const float* base,
                                            const EngineParams& P) {
  return Tables{base + P.off_body,  base + P.off_jnt,  base + P.off_dof,
                base + P.off_act,   base + P.off_sph,  base + P.off_box,
                base + P.off_dbox,  base + P.off_spair, base + P.off_pair,
                base + P.off_fall,  base + P.off_plat, base + P.off_goal,
                base};
}

// Per-model lists a block derives once from the tables, as ints: each
// dof's row offset in the tree blocks of M, its tree (lo | hi << 8) and
// body (<< 16); each body's parent + 1 | first joint << 8 | joints << 16
// | depth in its tree << 24, and the bit set of the dofs on its root path;
// each joint's type | qpos address << 8 | dof address << 16 | limited <<
// 24; the sphere of each static index; and M's lower-triangle entries (a
// << 8 | b, a's tree's dofs b <= a, row by row).
struct BlockLists {
  const int* rowoff;
  const int* dinfo;
  const int* binfo;
  const int* chain;
  const int* jinfo;
  const int* sphere_of;
  const int* mpairs;
  __device__ __forceinline__ int lo(int d) const { return dinfo[d] & 255; }
  __device__ __forceinline__ int hi(int d) const {
    return (dinfo[d] >> 8) & 255;
  }
  __device__ __forceinline__ int dof_body(int d) const {
    return dinfo[d] >> 16;
  }
  __device__ __forceinline__ int parent(int b) const {
    return (binfo[b] & 255) - 1;
  }
};

// One group's lane and its state.  The warp's groups run the same control
// flow in lockstep (the same syncs, shuffles and rounds; a ragged block's
// spare groups step a copy of the last env and write nothing), so their
// syncs and collectives take the whole warp: groups that each synced on
// their own mask drifted apart and ran slower (PERF.md).
template <int G>
struct Ctx {
  static constexpr unsigned mask = 0xffffffffu;
  int lane;
  float* g;   // the group's fields (EngineParams o_*)
  __device__ __forceinline__ float* at(int off) const { return g + off; }
  __device__ __forceinline__ int* iat(int off) const {
    return reinterpret_cast<int*>(g + off);
  }
};

template <int G>
__device__ __forceinline__ void gsync(const Ctx<G>& cx) {
  __syncwarp(cx.mask);
}

// The group's ballot of p, shifted to the group's lanes.
template <int G>
__device__ __forceinline__ unsigned gballot(const Ctx<G>& cx, bool p) {
  const unsigned b = __ballot_sync(cx.mask, p);
  return G == 32 ? b : (b >> ((threadIdx.x & 31) & ~(G - 1))) &
                           ((1u << G) - 1u);
}

// The largest x over the warp's groups (a bound of warp-uniform rounds).
template <int G>
__device__ __forceinline__ int wmax(const Ctx<G>& cx, int x) {
  return __reduce_max_sync(cx.mask, x);
}

// x of the group's lane src.
template <int G>
__device__ __forceinline__ float gshfl(const Ctx<G>& cx, float x, int src) {
  return __shfl_sync(cx.mask, x, src, G);
}

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

// A spatial inertia about O in compact form (kSpFloats floats): mass,
// h = m c (c the com about O) and the rotational inertia about O, Io = Ic
// + m (|c|^2 I - c c^T), symmetric (xx, yy, zz, xy, xz, yz).
// I s for a motion s = [w; v]: [Io w + h x v; m v - h x w].
__device__ __forceinline__ void sp_mul(const float* S, const float* s,
                                       float* out) {
  const float m = S[0];
  const float* h = S + 1;
  const float* I = S + 4;
  const float* w = s;
  const float* v = s + 3;
  float hv[3], hw[3];
  cross3(h, v, hv);
  cross3(h, w, hw);
  out[0] = I[0] * w[0] + I[3] * w[1] + I[4] * w[2] + hv[0];
  out[1] = I[3] * w[0] + I[1] * w[1] + I[5] * w[2] + hv[1];
  out[2] = I[4] * w[0] + I[5] * w[1] + I[2] * w[2] + hv[2];
  for (int i = 0; i < 3; ++i) out[3 + i] = m * v[i] - hw[i];
}

// Dofs of a joint of type jt.
__device__ __forceinline__ int joint_dofs(int jt) {
  return jt == kFree ? 6 : (jt == kBall ? 3 : 1);
}

// Element (i, j) of a tree block of M or M^-1 (i and j in one tree).
__device__ __forceinline__ float& tree_at(float* M, const BlockLists& bl,
                                          int i, int j) {
  return M[bl.rowoff[i] + (j - bl.lo(i))];
}

// One body of a level (engine.fk, engine.kin_dyn and the RNE forward
// pass): its pose (joints applied in declaration order, each dof's world
// axis and, for a rotation, its anchor taken at its place in the
// sequence), its com, its dofs' cdof about its tree's point, its
// velocity, its dofs' cdof derivatives and its RNE acceleration.  Its
// parent is done.
template <int G>
__device__ void body_level(const Ctx<G>& cx, const Tables& tb,
                           const EngineParams& P, const BlockLists& bl,
                           const float* q, const float* v, int b) {
  const float* row = tb.body + b * kBodyCols;
  const int info = bl.binfo[b];
  const int par = (info & 255) - 1;
  const int j0 = (info >> 8) & 255, nj = (info >> 16) & 255;
  const float* Rall = cx.at(P.o_R);
  const float* pall = cx.at(P.o_p);
  int* root = cx.iat(P.o_root);
  float* ax = cx.at(P.o_ax);
  float* an = cx.at(P.o_an);
  int* rot = cx.iat(P.o_rot);
  float* cdof = cx.at(P.o_cdof);
  float* cdd = cx.at(P.o_cdd);
  const int rb = par < 0 ? b : root[par];
  root[b] = rb;
  float Rb[9], pb[3];
  if (par < 0) {
    for (int i = 0; i < 9; ++i) Rb[i] = row[6 + i];
    for (int i = 0; i < 3; ++i) pb[i] = row[3 + i];
  } else {
    float off[3];
    mat_mul3(Rall + par * 9, row + 6, Rb);
    mat_vec3(Rall + par * 9, row + 3, off);
    for (int i = 0; i < 3; ++i) pb[i] = pall[par * 3 + i] + off[i];
  }
#pragma unroll 1
  for (int j = j0; j < j0 + nj; ++j) {
    const float* jr = tb.jnt + j * kJntCols;
    const int ji = bl.jinfo[j];
    const int jt = ji & 255, qa = (ji >> 8) & 255, va = (ji >> 16) & 255;
    const float* jpos = jr + 6;
    if (jt == kFree) {
      for (int i = 0; i < 3; ++i) pb[i] = q[qa + i];
      quat_to_mat(q + qa + 3, Rb);
      for (int kk = 0; kk < 3; ++kk) {
        rot[va + kk] = 0;
        for (int i = 0; i < 3; ++i)
          ax[(va + kk) * 3 + i] = i == kk ? 1.f : 0.f;
        rot[va + 3 + kk] = 1;
        for (int i = 0; i < 3; ++i) {
          ax[(va + 3 + kk) * 3 + i] = Rb[i * 3 + kk];
          an[(va + 3 + kk) * 3 + i] = pb[i];
        }
      }
    } else if (jt == kBall) {
      float Rj[9], Rn[9], a[3], t[3];
      quat_to_mat(q + qa, Rj);
      mat_vec3(Rb, jpos, t);
      for (int i = 0; i < 3; ++i) a[i] = pb[i] + t[i];
      mat_mul3(Rb, Rj, Rn);
      for (int i = 0; i < 9; ++i) Rb[i] = Rn[i];
      mat_vec3(Rb, jpos, t);
      for (int i = 0; i < 3; ++i) pb[i] = a[i] - t[i];
      for (int kk = 0; kk < 3; ++kk) {
        rot[va + kk] = 1;
        for (int i = 0; i < 3; ++i) {
          ax[(va + kk) * 3 + i] = Rb[i * 3 + kk];
          an[(va + kk) * 3 + i] = a[i];
        }
      }
    } else if (jt == kSlide) {
      float a[3];
      mat_vec3(Rb, jr + 3, a);
      const float qd = q[qa];
      for (int i = 0; i < 3; ++i) pb[i] = pb[i] + a[i] * qd;
      rot[va] = 0;
      for (int i = 0; i < 3; ++i) ax[va * 3 + i] = a[i];
    } else {  // hinge: Rj = I + s K + (1 - c) K K, K = skew(world axis)
      float a[3], t[3], anc[3], Rj[9], Rn[9];
      mat_vec3(Rb, jr + 3, a);
      const float s = sinf(q[qa]), cm = 1.f - cosf(q[qa]);
      const float K[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0],
                          -a[1], a[0], 0.f};
      float KK[9];
      mat_mul3(K, K, KK);
      for (int i = 0; i < 9; ++i)
        Rj[i] = ((i % 4 == 0) ? 1.f : 0.f) + s * K[i] + cm * KK[i];
      mat_vec3(Rb, jpos, t);
      for (int i = 0; i < 3; ++i) anc[i] = pb[i] + t[i];
      mat_mul3(Rj, Rb, Rn);
      for (int i = 0; i < 9; ++i) Rb[i] = Rn[i];
      mat_vec3(Rb, jpos, t);
      for (int i = 0; i < 3; ++i) pb[i] = anc[i] - t[i];
      rot[va] = 1;
      for (int i = 0; i < 3; ++i) {
        ax[va * 3 + i] = a[i];
        an[va * 3 + i] = anc[i];
      }
    }
  }
  for (int i = 0; i < 9; ++i) cx.at(P.o_R)[b * 9 + i] = Rb[i];
  for (int i = 0; i < 3; ++i) cx.at(P.o_p)[b * 3 + i] = pb[i];
  float cw[3];
  mat_vec3(Rb, row + 16, cw);
  for (int i = 0; i < 3; ++i) cx.at(P.o_c)[b * 3 + i] = pb[i] + cw[i];
  // the tree's point: this body's origin if it is the root, else the
  // root's (a level above)
  float O[3];
  for (int i = 0; i < 3; ++i) O[i] = par < 0 ? pb[i] : pall[rb * 3 + i];
  // cdof of the body's dofs, the velocity, cdd (engine.kin_dyn) and the
  // RNE acceleration from the parent's (or gravity as the base's)
  float vel[6], acc[6];
  if (par < 0) {
    for (int i = 0; i < 6; ++i) vel[i] = 0.f;
    acc[0] = acc[1] = acc[2] = 0.f;
    acc[3] = -P.gx; acc[4] = -P.gy; acc[5] = -P.gz;
  } else {
    for (int i = 0; i < 6; ++i) {
      vel[i] = cx.at(P.o_cvel)[par * 6 + i];
      acc[i] = cx.at(P.o_acc)[par * 6 + i];
    }
  }
#pragma unroll 1
  for (int j = j0; j < j0 + nj; ++j) {
    const int ji = bl.jinfo[j];
    const int jt = ji & 255, va = (ji >> 16) & 255;
    const int n = joint_dofs(jt);
    float S[6][6];  // the joint's cdof (at most 6 dofs), in registers
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k >= n) break;
      const int d = va + k;
      float* s = S[k];
      float axd[3];
      for (int i = 0; i < 3; ++i) axd[i] = ax[d * 3 + i];
      if (rot[d]) {
        const float rel[3] = {an[d * 3] - O[0], an[d * 3 + 1] - O[1],
                              an[d * 3 + 2] - O[2]};
        for (int i = 0; i < 3; ++i) s[i] = axd[i];
        cross3(rel, axd, s + 3);
      } else {
        s[0] = s[1] = s[2] = 0.f;
        for (int i = 0; i < 3; ++i) s[3 + i] = axd[i];
      }
      for (int i = 0; i < 6; ++i) cdof[d * 6 + i] = s[i];
    }
    float D[6][6];  // the joint's cdd
    if (jt == kFree || jt == kBall) {
      const int r0 = jt == kFree ? 3 : 0;  // the rotational dofs
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (k >= r0 + 3) break;
        if (k < r0)
          for (int i = 0; i < 6; ++i) D[k][i] = 0.f;
        const float vd = v[va + k];
        for (int i = 0; i < 6; ++i) vel[i] = vel[i] + S[k][i] * vd;
      }
      // the rotational axes turn with every dof of the joint
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k >= r0 && k < r0 + 3) motion_cross(vel, S[k], D[k]);
    } else {
      motion_cross(vel, S[0], D[0]);
      const float vd = v[va];
      for (int i = 0; i < 6; ++i) vel[i] = vel[i] + S[0][i] * vd;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k >= n) break;
      const float vd = v[va + k];
      for (int i = 0; i < 6; ++i) {
        cdd[(va + k) * 6 + i] = D[k][i];
        acc[i] = acc[i] + D[k][i] * vd;
      }
    }
  }
  for (int i = 0; i < 6; ++i) {
    cx.at(P.o_cvel)[b * 6 + i] = vel[i];
    cx.at(P.o_acc)[b * 6 + i] = acc[i];
  }
}

// One body's spatial quantities after the levels: its spatial inertia
// about its tree's point (and the composite pass's copy), its RNE force f
// = I a + v x* (I v), v x* f = [w x m + vl x fl; w x fl], and the fluid's
// spatial force (engine.fluid_force), summed into the dofs later.
template <int G>
__device__ void body_forces(const Ctx<G>& cx, const Tables& tb,
                            const EngineParams& P, int b) {
  const float* row = tb.body + b * kBodyCols;
  float Rb[9], c[3], vel[6], a[6];
  const int rb = cx.iat(P.o_root)[b];
  for (int i = 0; i < 9; ++i) Rb[i] = cx.at(P.o_R)[b * 9 + i];
  for (int i = 0; i < 3; ++i)
    c[i] = cx.at(P.o_c)[b * 3 + i] - cx.at(P.o_p)[rb * 3 + i];
  for (int i = 0; i < 6; ++i) {
    vel[i] = cx.at(P.o_cvel)[b * 6 + i];
    a[i] = cx.at(P.o_acc)[b * 6 + i];
  }
  // Io = R Ic R^T + m (|c|^2 I - c c^T) about the tree's point O
  const float m = row[15];
  const float Ic[9] = {row[19], row[22], row[23], row[22], row[20],
                       row[24], row[23], row[24], row[21]};
  float T[9], Iw[9];
  mat_mul3(Rb, Ic, T);
  for (int r = 0; r < 3; ++r)
    for (int cc = 0; cc < 3; ++cc)
      Iw[r * 3 + cc] = T[r * 3] * Rb[cc * 3] + T[r * 3 + 1] * Rb[cc * 3 + 1] +
                       T[r * 3 + 2] * Rb[cc * 3 + 2];
  float S[kSpFloats];
  S[0] = m;
  for (int i = 0; i < 3; ++i) S[1 + i] = m * c[i];
  const float cxx = m * (c[1] * c[1] + c[2] * c[2]);
  const float cyy = m * (c[0] * c[0] + c[2] * c[2]);
  const float czz = m * (c[0] * c[0] + c[1] * c[1]);
  S[4] = Iw[0] + cxx;
  S[5] = Iw[4] + cyy;
  S[6] = Iw[8] + czz;
  S[7] = Iw[1] - m * (c[0] * c[1]);
  S[8] = Iw[2] - m * (c[0] * c[2]);
  S[9] = Iw[5] - m * (c[1] * c[2]);
  for (int i = 0; i < kSpFloats; ++i) {
    cx.at(P.o_I)[b * kSpFloats + i] = S[i];
    cx.at(P.o_C)[b * kSpFloats + i] = S[i];
  }
  float Ia[6], Iv[6], t[3], fx[6];
  sp_mul(S, a, Ia);
  sp_mul(S, vel, Iv);
  cross3(vel, Iv, fx);
  cross3(vel + 3, Iv + 3, t);
  for (int i = 0; i < 3; ++i) fx[i] = fx[i] + t[i];
  cross3(vel, Iv + 3, fx + 3);
  for (int i = 0; i < 6; ++i) cx.at(P.o_frc)[b * 6 + i] = Ia[i] + fx[i];
  if (P.visc_on || P.rho_on) {
    float* fs = cx.at(P.o_fs) + b * 6;
    if (!(m > 0.f)) {
      for (int i = 0; i < 6; ++i) fs[i] = 0.f;
    } else {
      const float* ww = vel;
      float vw[3], wb[3], vb[3];
      cross3(ww, c, t);
      for (int i = 0; i < 3; ++i) vw[i] = vel[3 + i] + t[i];
      mat_tvec3(Rb, ww, wb);
      mat_tvec3(Rb, vw, vb);
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
      float fw[3], tw[3];
      mat_vec3(Rb, force, fw);
      mat_vec3(Rb, torque, tw);
      cross3(c, fw, t);
      for (int i = 0; i < 3; ++i) {
        fs[i] = tw[i] + t[i];
        fs[3 + i] = fw[i];
      }
    }
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

// The signed distance alone of sphere_box against an axis-aligned box
// (the same operations): the key of the nearest-two picks.
__device__ __forceinline__ float sphere_box_dist(const float* c, float r,
                                                 const float* bc,
                                                 const float* bh) {
  float local[3], delta[3];
  for (int i = 0; i < 3; ++i) {
    local[i] = c[i] - bc[i];
    delta[i] = local[i] - fmaxf(fminf(local[i], bh[i]), -bh[i]);
  }
  const float d_out = sqrtf(delta[0] * delta[0] + delta[1] * delta[1] +
                            delta[2] * delta[2] + 1e-12f);
  const float ex = bh[0] - fabsf(local[0]);
  const float ey = bh[1] - fabsf(local[1]);
  const float ez = bh[2] - fabsf(local[2]);
  const float mmin = fminf(fminf(ex, ey), ez);
  return d_out > 1e-6f ? d_out - r : -mmin - r;
}

// The nearest two boxes by (key, index): the serial scan's strict <
// (first of equal keys wins) is this order; a key that is NaN or never
// below +inf stays out.
struct Near2 {
  float e0, e1;
  int i0, i1;
  __device__ __forceinline__ void init() {
    e0 = e1 = INFINITY;
    i0 = i1 = 0x7fffffff;
  }
  static __device__ __forceinline__ bool less(float e, int i, float f,
                                              int j) {
    return e < f || (e == f && i < j);
  }
  __device__ __forceinline__ void add(float e, int i) {
    if (!(e < INFINITY)) return;
    if (less(e, i, e0, i0)) {
      e1 = e0; i1 = i0;
      e0 = e; i0 = i;
    } else if (less(e, i, e1, i1)) {
      e1 = e; i1 = i;
    }
  }
};

// A candidate slot's record (kRec floats).
__device__ __forceinline__ void put_record(float* rec, bool active,
                                           int body_a, int body_b,
                                           int par_off, const float* pos,
                                           const float* n, float dist,
                                           float margin, bool inside,
                                           int trace_bit) {
  rec[0] = active ? 1.f : 0.f;
  rec[1] = (float)body_a;
  rec[2] = (float)body_b;
  rec[3] = (float)par_off;
  for (int i = 0; i < 3; ++i) {
    rec[4 + i] = pos[i];
    rec[7 + i] = n[i];
  }
  rec[10] = dist;
  rec[11] = margin;
  rec[12] = inside ? 1.f : 0.f;
  rec[13] = (float)trace_bit;
}

// Detection: every candidate's record in its slot (slots sphere by sphere,
// floor then the two picks, then the sphere-sphere pairs, then the
// sphere-vs-moving-box pairs).  The static spheres' box tests split over a
// sub-group of `sub` lanes per sphere; their nearest two merge across the
// sub-group by shuffles.
template <int G>
__device__ void detect(const Ctx<G>& cx, const Tables& tb,
                       const EngineParams& P, const BlockLists& bl) {
  const int slot_floats = kRec + P.row_floats;
  float* slots = cx.at(P.o_slot);
  const float* R = cx.at(P.o_R);
  const float* p = cx.at(P.o_p);
  const int groups = P.has_floor + P.n_pick;
  const int base_off = (int)(tb.sph - tb.base);
  if (P.n_static > 0) {
    // the sub-group width that takes the fewest box tests and merge
    // rounds per lane: rounds of spheres x (boxes a lane + log2 width)
    int sub = 1, best = 1 << 30;
    for (int w = 1, lg = 0; w <= G; w *= 2, ++lg) {
      const int cost = (P.n_static + G / w - 1) / (G / w) *
                       ((P.n_box + w - 1) / w + lg);
      if (cost < best) {
        best = cost;
        sub = w;
      }
    }
    const int per_round = G / sub;
    const int rounds = (P.n_static + per_round - 1) / per_round;
    const int sl = cx.lane % sub;
#pragma unroll 1
    for (int rd = 0; rd < rounds; ++rd) {
      const int ks = rd * per_round + cx.lane / sub;
      const bool valid = ks < P.n_static;
      const int s = valid ? bl.sphere_of[ks] : 0;
      const float* sp = tb.sph + s * kSphCols;
      const int body = (int)sp[0];
      float c[3];
      mat_vec3(R + body * 9, sp + 1, c);
      for (int i = 0; i < 3; ++i) c[i] = p[body * 3 + i] + c[i];
      const float r = sp[4];
      Near2 nb;
      nb.init();
      if (valid) {
#pragma unroll 1
        for (int b = sl; b < P.n_box; b += sub) {
          const float* bx = tb.box + b * kBoxCols;
          nb.add(sphere_box_dist(c, r, bx, bx + 3) - bx[6], b);
        }
      }
      for (int off = 1; off < sub; off <<= 1) {
        const float f0 = __shfl_xor_sync(cx.mask, nb.e0, off);
        const float f1 = __shfl_xor_sync(cx.mask, nb.e1, off);
        const int j0 = __shfl_xor_sync(cx.mask, nb.i0, off);
        const int j1 = __shfl_xor_sync(cx.mask, nb.i1, off);
        nb.add(f0, j0);
        nb.add(f1, j1);
      }
      if (!valid) continue;
      float* srec = slots + (ks * groups) * slot_floats;
      const int par_off = base_off + s * kSphCols + 7;
      if (P.has_floor && sl == 0) {
        const float dist = (c[2] - P.floor_z) - r;
        const float pos[3] = {c[0], c[1], c[2] - r};
        const float up[3] = {0.f, 0.f, 1.f};
        put_record(srec, dist < sp[6], body, -1, par_off, pos, up, dist,
                   sp[6], false, ks);
      }
      // the two nearest static boxes; a pick no box filled stays at an
      // infinite distance, never active
      for (int j = 0; j < P.n_pick; ++j) {
        if (sl != (sub == 1 ? 0 : (j + 1) % sub)) continue;
        const int bi = j == 0 ? nb.i0 : nb.i1;
        float dist = INFINITY, pos[3] = {0.f, 0.f, 0.f};
        float n[3] = {0.f, 0.f, 0.f}, bm = 0.f;
        bool inside = false;
        if (bi < P.n_box) {
          const float* bx = tb.box + bi * kBoxCols;
          sphere_box(c, r, bx, bx + 3, nullptr, &dist, pos, n, &inside);
          bm = bx[6];
        }
        const float margin = sp[5] + bm;
        put_record(srec + (P.has_floor + j) * slot_floats, dist < margin,
                   body, -1, par_off, pos, n, dist, margin, inside,
                   (P.has_floor + j) * P.n_static + ks);
      }
    }
  }
  float* pslots = slots + P.n_static * groups * slot_floats;
  // every sphere-sphere pair: the normal from sphere j's centre to sphere
  // i's, the point midway through the overlap (contact.py _detect)
#pragma unroll 1
  for (int ps = cx.lane; ps < P.n_spair; ps += G) {
    const float* pr = tb.spair + ps * kPairCols;
    const float* si = tb.sph + (int)pr[0] * kSphCols;
    const float* sj = tb.sph + (int)pr[1] * kSphCols;
    const int bi = (int)si[0], bj = (int)sj[0];
    float ci[3], cj[3], d[3];
    mat_vec3(R + bi * 9, si + 1, ci);
    mat_vec3(R + bj * 9, sj + 1, cj);
    for (int i = 0; i < 3; ++i) {
      ci[i] = p[bi * 3 + i] + ci[i];
      cj[i] = p[bj * 3 + i] + cj[i];
      d[i] = ci[i] - cj[i];
    }
    const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12f);
    const float n[3] = {d[0] / dn, d[1] / dn, d[2] / dn};
    const float rj = sj[4];
    const float dist = dn - (si[4] + rj);
    const float margin = pr[2];  // the two spheres' margins summed
    const float reach = rj + dist * 0.5f;
    const float pos[3] = {cj[0] + n[0] * reach, cj[1] + n[1] * reach,
                          cj[2] + n[2] * reach};
    put_record(pslots + ps * slot_floats, dist < margin, bi, bj,
               (int)(pr + 3 - tb.base), pos, n, dist, margin, false,
               groups * P.n_static + ps);
  }
  // every sphere-vs-moving-box pair, in the box's frame
  float* qslots = pslots + P.n_spair * slot_floats;
#pragma unroll 1
  for (int qp = cx.lane; qp < P.n_pair; qp += G) {
    const float* pr = tb.pair + qp * kPairCols;
    const float* sp = tb.sph + (int)pr[0] * kSphCols;
    const float* db = tb.dbox + (int)pr[1] * kDboxCols;
    const int sb = (int)sp[0], bb = (int)db[0];
    float c[3], bc[3];
    mat_vec3(R + sb * 9, sp + 1, c);
    for (int i = 0; i < 3; ++i) c[i] = p[sb * 3 + i] + c[i];
    mat_vec3(R + bb * 9, db + 1, bc);
    for (int i = 0; i < 3; ++i) bc[i] = p[bb * 3 + i] + bc[i];
    float dist, pos[3], n[3];
    bool inside;
    sphere_box(c, sp[4], bc, db + 4, R + bb * 9, &dist, pos, n, &inside);
    put_record(qslots + qp * slot_floats, dist < pr[2], sb, bb,
               (int)(pr + 3 - tb.base), pos, n, dist, pr[2], inside,
               groups * P.n_static + P.n_spair + qp);
  }
}

// Row rr of one active contact, in its slot: the row over the dofs of
// both bodies' root paths (sign + on body a's, the sphere's, - on body
// b's, the second sphere's or the box's, body b -1 for the static world;
// 0 on the dofs the two paths share and off both paths), each path's
// columns with the moment arm about its tree's point, the impedance
// constants, A = J M^-1 J^T, aref - a0, R and the denominator
// (contact.py contact_qfrc); returns the row's first force rhs / denom.
template <int NV, int G>
__device__ float contact_row(const Ctx<G>& cx, const Tables& tb,
                             const EngineParams& P, const BlockLists& bl,
                             float* slot, int rr, const float* v) {
  const int nv = P.nv;
  const float* rec = slot;
  float* J = slot + kRec + rr * nv;
  float* fx = slot + kRec + 3 * nv;  // rhs 0-2, rreg 3-5, denom 6-8, f
                                     // 9-11, mu 12
  const int body_a = (int)rec[1], body_b = (int)rec[2];
  const float* par = tb.base + (int)rec[3];
  const float* pos = rec + 4;
  const float* nrm = rec + 7;
  const float dist = rec[10], margin = rec[11];
  const float mu = par[0], d0 = par[1], dmax = par[2], width = par[3];
  const float tc = par[4], dampr = par[5];
  const bool use_x = fabsf(nrm[0]) < 0.5f;
  const float ref[3] = {use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f};
  float dir[3];
  if (rr == 0) {
    for (int i = 0; i < 3; ++i) dir[i] = nrm[i];
  } else {
    float t1[3];
    cross3(nrm, ref, t1);
    const float tn = sqrtf(dot3(t1, t1) + 1e-12f);
    for (int i = 0; i < 3; ++i) t1[i] = t1[i] / tn;
    if (rr == 1) {
      for (int i = 0; i < 3; ++i) dir[i] = t1[i];
    } else {
      cross3(nrm, t1, dir);
    }
  }
  const int bits_a = bl.chain[body_a];
  const int bits_b = body_b < 0 ? 0 : bl.chain[body_b];
  const float* pall = cx.at(P.o_p);
  const int* root = cx.iat(P.o_root);
  const float* Oa = pall + root[body_a] * 3;
  const float* Ob = pall + root[body_b < 0 ? body_a : body_b] * 3;
  const float rel_a[3] = {pos[0] - Oa[0], pos[1] - Oa[1], pos[2] - Oa[2]};
  const float rel_b[3] = {pos[0] - Ob[0], pos[1] - Ob[1], pos[2] - Ob[2]};
  const int bits = bits_a | bits_b;
  const float r = dist - margin;
  const float b_imp = 2.f / (dmax * tc);
  const float imp = d0 + (dmax - d0) * clampf(-r / width, 0.f, 1.f);
  const float k_imp = imp / (dmax * dmax * tc * tc * dampr * dampr);
  const float rfac = (1.f - imp) / fmaxf(imp, 1e-6f);
  const float* cdof = cx.at(P.o_cdof);
  const float* Minv = cx.at(P.o_Minv);
  const float* qacc0 = cx.at(P.o_qacc0);
  float Fa[6], Fb[6];
  cross3(rel_a, dir, Fa);
  cross3(rel_b, dir, Fb);
  for (int i = 0; i < 3; ++i) Fa[3 + i] = Fb[3 + i] = dir[i];
  float Jr[NV];
  int ro[NV];
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    Jr[d] = 0.f;
    ro[d] = 0;
    if (d >= nv) continue;
    const int sg = (int)bit(bits_a, d) - (int)bit(bits_b, d);
    Jr[d] = sg > 0 ? dot6(Fa, cdof + d * 6)
                   : (sg < 0 ? -dot6(Fb, cdof + d * 6) : 0.f);
    ro[d] = bl.rowoff[d] - bl.lo(d);
  }
  float A = 0.f, vr = 0.f, ar = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i >= nv || !bit(bits, i)) continue;
    const int lo = bl.lo(i), hi = bl.hi(i);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j >= lo && j < hi && bit(bits, j))
        s = s + Jr[j] * Minv[ro[j] + i];
    A = A + s * Jr[i];
    vr = vr + Jr[i] * v[i];
    ar = ar + Jr[i] * qacc0[i];
  }
#pragma unroll
  for (int d = 0; d < NV; ++d)
    if (d < nv) J[d] = Jr[d];
  const float aref = rr == 0 ? -b_imp * vr - k_imp * r : -b_imp * vr;
  const float rreg = rfac * A;
  const float denom = A + rreg + 1e-9f;
  fx[rr] = aref - ar;
  fx[3 + rr] = rreg;
  fx[6 + rr] = denom;
  if (rr == 0) fx[12] = mu;
  return (aref - ar) / denom;
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

// Sum over the active contacts, in list order, of J^T f at dof d.
__device__ __forceinline__ float jt_f(const float* slots, const int* list,
                                      int nc, int sf, int nv, int d) {
  float x = 0.f;
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    const float* J = slots + list[i] * sf + kRec;
    const float* f = J + 3 * nv + 9;
    x = x + (J[d] * f[0] + J[nv + d] * f[1] + J[2 * nv + d] * f[2]);
  }
  return x;
}

// (M^-1 x)[i] within i's tree.
template <int NV>
__device__ __forceinline__ float minv_row(const BlockLists& bl,
                                          const float* Minv, const float* x,
                                          int i) {
  const int lo = bl.lo(i), hi = bl.hi(i);
  const float* row = Minv + bl.rowoff[i] - lo;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (j >= lo && j < hi) s = s + row[j] * x[j];
  return s;
}

// The lanes of the contacts' rows: G / 3 contacts a round, lane 3 c' + rr
// takes row rr of the round's contact c'.  project_rows gives each lane of
// a contact its row of the projected (f0, f1, f2) (lanes past the round's
// rows keep their own f).
template <int G>
__device__ __forceinline__ float project_rows(const Ctx<G>& cx, float f,
                                              float mu, int rr) {
  const int base = cx.lane < 3 * (G / 3) ? cx.lane - rr : cx.lane;
  float fv[3];
  fv[0] = gshfl(cx, f, base);
  fv[1] = gshfl(cx, f, base + (base + 1 < G ? 1 : 0));
  fv[2] = gshfl(cx, f, base + (base + 2 < G ? 2 : 0));
  project(mu, fv);
  return rr == 0 ? fv[0] : (rr == 1 ? fv[1] : fv[2]);
}

// Contact detection's compacted active list and the projected-Jacobi
// solve; leaves the contact force in fc (zeroed before).  Returns the
// active count.
template <int NV, int G>
__device__ int contact_force(const Ctx<G>& cx, const Tables& tb,
                             const EngineParams& P, const BlockLists& bl,
                             const float* v) {
  const int nv = P.nv;
  const int sf = kRec + P.row_floats;
  float* slots = cx.at(P.o_slot);
  int* list = cx.iat(P.o_list);
  // the active list in slot order: a ballot per chunk of G slots
  int nc = 0;
#pragma unroll 1
  for (int s0 = 0; s0 < P.n_cand; s0 += G) {
    const int s = s0 + cx.lane;
    const bool on = s < P.n_cand && slots[s * sf] != 0.f;
    const unsigned b = gballot(cx, on);
    if (on) list[nc + __popc(b & ((1u << cx.lane) - 1u))] = s;
    nc += __popc(b);
  }
  const int nc_max = wmax(cx, nc);  // the warp's groups share the rounds
  if (nc_max == 0) return 0;
  gsync(cx);
  ENG_PHASE_START
  constexpr int per = G / 3;  // contacts a round
  const int rounds = (nc_max + per - 1) / per;
  const int rr = cx.lane % 3;
  constexpr int kRows = 3 * per;
  // the rows and the first projected forces, a round of per contacts at a
  // time
#pragma unroll 1
  for (int rd = 0; rd < rounds; ++rd) {
    const int c = rd * per + cx.lane / 3;
    const bool on = cx.lane < kRows && c < nc;
    float* slot = slots + (on ? list[c] : 0) * sf;
    float f = 0.f, mu = 0.f;
    if (on) {
      f = contact_row<NV, G>(cx, tb, P, bl, slot, rr, v);
      mu = tb.base[(int)slot[3]];  // the friction (fx[12], row 0's lane)
    }
    f = project_rows(cx, f, mu, rr);
    if (on) slot[kRec + 3 * nv + 9 + rr] = f;
  }
  gsync(cx);
  ENG_PHASE(kEngRows)
  // projected Jacobi on (A + R) f = aref - a0, all rows in parallel: J^T f
  // and M^-1 x with lanes over the dofs, each row's J y and update with
  // lanes over the rows
  float* x = cx.at(P.o_x);
  float* y = cx.at(P.o_y);
  const float* Minv = cx.at(P.o_Minv);
#pragma unroll 1
  for (int it = 0; it < P.solver_iters; ++it) {
    for (int d = cx.lane; d < nv; d += G)
      x[d] = jt_f(slots, list, nc, sf, nv, d);
    gsync(cx);
    for (int d = cx.lane; d < nv; d += G)
      y[d] = minv_row<NV>(bl, Minv, x, d);
    gsync(cx);
#pragma unroll 1
    for (int rd = 0; rd < rounds; ++rd) {
      const int c = rd * per + cx.lane / 3;
      const bool on = cx.lane < kRows && c < nc;
      float* fr = slots + (on ? list[c] : 0) * sf + kRec + 3 * nv;
      float fn = 0.f, m = 0.f;
      if (on) {
        const float* J = fr - 3 * nv + rr * nv;
        float af = 0.f;
#pragma unroll
        for (int d = 0; d < NV; ++d)
          if (d < nv) af = af + J[d] * y[d];
        const float cur = fr[9 + rr];
        const float resid = fr[rr] - af - fr[3 + rr] * cur;
        fn = cur + P.omega * resid / fr[6 + rr];
        m = fr[12];
      }
      fn = project_rows(cx, fn, m, rr);
      if (on) fr[9 + rr] = fn;
    }
    gsync(cx);
  }
  float* fc = cx.at(P.o_fc);
  for (int d = cx.lane; d < nv; d += G)
    fc[d] = jt_f(slots, list, nc, sf, nv, d);
  ENG_PHASE(kEngSweeps)
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

// One joint's impedance limit force (engine.limit_force); *on: a side
// violated.
__device__ __forceinline__ float limit_force(const EngineParams& P, float qd,
                                             float vd, float a0, float minv,
                                             float lo, float hi, bool* on) {
  const float m_eff = 1.f / fmaxf(minv, 1e-12f);
  float f = 0.f;
  bool any = false;
  for (int side = 0; side < 2; ++side) {
    const float sign = side == 0 ? 1.f : -1.f;
    const float viol = side == 0 ? fmaxf(qd - hi, 0.f) : fmaxf(lo - qd, 0.f);
    const float dimp =
        P.lim_d0 + P.lim_dd * clampf(viol / P.lim_width, 0.f, 1.f);
    const float kimp = dimp / P.lim_kden;
    const float aref = -P.lim_b * (sign * vd) - kimp * viol;
    const float f_out = fminf(m_eff * dimp * (aref - sign * a0), 0.f);
    f = f + (viol > 0.f ? sign * f_out : 0.f);
    any = any || viol > 0.f;
  }
  *on = any;
  return f;
}

// M^-1 of each kinematic tree by the Cholesky factor (linalg.spd_inverse,
// pivots clamped at 1e-12), tree by tree: lane i holds row i of the
// tree's L in registers (a column's entries of the other rows come by
// shuffles), then column i of the inverse by forward and back
// substitution.  A tree has at most G dofs (the wrapper's lane choice).
template <int NV, int G>
__device__ void tree_inverse(const Ctx<G>& cx, const EngineParams& P,
                             const BlockLists& bl) {
  const float* M = cx.at(P.o_M);
  float* Minv = cx.at(P.o_Minv);
  const int i = cx.lane;
  int lo = 0;
#pragma unroll 1
  while (lo < P.nv) {
    const int hi = bl.hi(lo), n = hi - lo, base = bl.rowoff[lo];
    float L[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      L[k] = i < n && k < n ? M[base + i * n + k] : 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j >= n) break;
      float s = L[j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[k] * gshfl(cx, L[k], j);
      const float d = sqrtf(fmaxf(gshfl(cx, s, j), 1e-12f));
      if (i >= j) L[j] = s / d;
    }
    float z[NV];
#pragma unroll
    for (int r = 0; r < NV; ++r) {
      z[r] = 0.f;
      if (r >= n) break;
      float acc = r == i ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < r; ++k) acc = acc - gshfl(cx, L[k], r) * z[k];
      z[r] = acc / gshfl(cx, L[r], r);
    }
#pragma unroll
    for (int r = NV - 1; r >= 0; --r) {
      if (r >= n) continue;
      float acc = z[r];
#pragma unroll
      for (int k = r + 1; k < NV; ++k) {
        if (k >= n) break;
        acc = acc - gshfl(cx, L[r], k) * z[k];
      }
      z[r] = acc / gshfl(cx, L[r], r);
    }
    if (i < n) {
#pragma unroll
      for (int r = 0; r < NV; ++r)
        if (r < n) Minv[base + r * n + i] = z[r];
    }
    lo = hi;
  }
  gsync(cx);
}

// qacc of one forward evaluation (engine.forward with the contact and
// support forces) into cx.at(P.o_as).  Adds the active-contact count to
// *n_active (lane 0); fills this evaluation's trace words when trace is
// not null.
template <int NV, int NB, int G>
__device__ void forward(const Ctx<G>& cx, const Tables& tb,
                        const EngineParams& P, const BlockLists& bl,
                        int* n_active, int* trace) {
  ENG_PHASE_START
  const int nv = P.nv;
  const float* q = cx.at(P.o_qs);
  const float* v = cx.at(P.o_vs);
  // kinematics, velocities and the RNE forward pass, level by level down
  // the body tree, lanes over a level's bodies; then each body's inertia
  // and forces, lanes over the bodies
#pragma unroll 1
  for (int lev = 0; lev < P.n_levels; ++lev) {
#pragma unroll
    for (int k = 0; k < (NB + G - 1) / G; ++k) {
      const int b = cx.lane + k * G;
      if (b < P.nb && bl.binfo[b] >> 24 == lev)
        body_level(cx, tb, P, bl, q, v, b);
    }
    gsync(cx);
  }
#pragma unroll
  for (int k = 0; k < (NB + G - 1) / G; ++k) {
    const int b = cx.lane + k * G;
    if (b < P.nb) body_forces(cx, tb, P, b);
  }
  gsync(cx);
  ENG_PHASE(kEngKinematics)
  // the composite inertias and the RNE backward sums, lanes over their
  // components, children after their parents
  {
    float* C = cx.at(P.o_C);
    float* frc = cx.at(P.o_frc);
    for (int k = cx.lane; k < kComponents; k += G) {
      float* X = k < kSpFloats ? C + k : frc + (k - kSpFloats);
      const int stride = k < kSpFloats ? kSpFloats : 6;
#pragma unroll 1
      for (int b = P.nb - 1; b >= 1; --b) {
        const int par = bl.parent(b);
        if (par < 0) continue;
        X[par * stride] = X[par * stride] + X[b * stride];
      }
    }
  }
  gsync(cx);
  // the mass matrix, lanes over the lower triangles' entries (M[a][b] =
  // (I^C s_a) . s_b for b on the root path of a's body, 0 elsewhere in
  // the tree's block), plus armature
  {
    float* M = cx.at(P.o_M);
    const float* C = cx.at(P.o_C);
    const float* cdof = cx.at(P.o_cdof);
#pragma unroll 1
    for (int t = cx.lane; t < P.n_mpairs; t += G) {
      const int a = bl.mpairs[t] >> 8, b = bl.mpairs[t] & 255;
      const int ba = bl.dof_body(a);
      float x = 0.f;
      if (bit(bl.chain[ba], b)) {
        float F[6];
        sp_mul(C + ba * kSpFloats, cdof + a * 6, F);
        x = dot6(F, cdof + b * 6);
      }
      if (a == b) {
        tree_at(M, bl, a, a) = x + tb.dof[a * kDofCols + 1];
      } else {
        tree_at(M, bl, a, b) = x;
        tree_at(M, bl, b, a) = x;
      }
    }
  }
  ENG_PHASE(kEngMassMatrix)
  // the bias (qfrc_bias = C(q, v) v + gravity by RNE about each tree's
  // point), actuation, fluid drag and damping, lanes over the dofs; the
  // smooth right-hand side tau - bias into x
  {
    const float* cdof = cx.at(P.o_cdof);
    const float* frc = cx.at(P.o_frc);
    const float* fs = cx.at(P.o_fs);
    const float* ctrl = cx.at(P.o_ctrl);
    for (int d = cx.lane; d < nv; d += G) {
      const float bias = dot6(cdof + d * 6, frc + bl.dof_body(d) * 6);
      float tau = 0.f;
      for (int u = 0; u < P.nu; ++u) {
        const float* a = tb.act + u * kActCols;
        if ((int)a[0] == d) tau = tau + a[1] * clampf(ctrl[u], a[2], a[3]);
      }
      if (P.visc_on || P.rho_on) {
        float fl = 0.f;
        for (int b = 0; b < P.nb; ++b)
          if (tb.body[b * kBodyCols + 15] > 0.f && bit(bl.chain[b], d))
            fl = fl + dot6(cdof + d * 6, fs + b * 6);
        tau = tau + fl;
      }
      tau = tau - tb.dof[d * kDofCols + 2] * v[d];
      cx.at(P.o_bias)[d] = bias;
      cx.at(P.o_tau)[d] = tau;
      cx.at(P.o_y)[d] = tau - bias;
      cx.at(P.o_flim)[d] = 0.f;
      cx.at(P.o_fsup)[d] = 0.f;
      cx.at(P.o_fc)[d] = 0.f;
    }
  }
  gsync(cx);
  ENG_PHASE(kEngBias)
  tree_inverse<NV, G>(cx, P, bl);
  const float* Minv = cx.at(P.o_Minv);
  float* qacc0 = cx.at(P.o_qacc0);
  for (int d = cx.lane; d < nv; d += G)
    qacc0[d] = minv_row<NV>(bl, Minv, cx.at(P.o_y), d);
  gsync(cx);
  ENG_PHASE(kEngFactor)
  // joint limits (engine.limit_force), lanes over the joints; the falling
  // blocks' support against the highest platform top their body's origin
  // overlaps (else the floor), lanes over the blocks
  int* flags = cx.iat(P.o_flags);  // per joint its limit's switch, then
                                   // per falling block its rows
#pragma unroll 1
  for (int j = cx.lane; j < P.nj; j += G) {
    const float* jr = tb.jnt + j * kJntCols;
    const int ji = bl.jinfo[j];
    bool on = false;
    if (ji >> 24) {
      const int qa = (ji >> 8) & 255, d = (ji >> 16) & 255;
      cx.at(P.o_flim)[d] = limit_force(P, q[qa], v[d], qacc0[d],
                                       tree_at(cx.at(P.o_Minv), bl, d, d),
                                       jr[10], jr[11], &on);
    }
    flags[j] = on ? 1 : 0;
  }
#pragma unroll 1
  for (int f = cx.lane; f < P.n_fall; f += G) {
    const float* fr = tb.fall + f * kFallCols;
    const int b = (int)fr[0], zd = (int)fr[1];
    const float bpz = fr[5];
    const float* c = cx.at(P.o_p) + b * 3;
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
    float* fsup = cx.at(P.o_fsup);
    fsup[zd] = fsup[zd] + falling_support(
                              P, z, bottom, s, v[zd], qacc0[zd],
                              tree_at(cx.at(P.o_Minv), bl, zd, zd) +
                                  1e-12f,
                              &rows);
    flags[P.nj + f] = rows;
  }
  ENG_PHASE(kEngLimits)
  detect(cx, tb, P, bl);
  gsync(cx);
  ENG_PHASE(kEngDetect)
  const int nc = contact_force<NV, G>(cx, tb, P, bl, v);
  ENG_PHASE_RESTART
  if (cx.lane == 0) *n_active += nc;
  // qacc = M^-1 ((tau + (flim + (fc + fsup))) - bias)
  {
    float* x = cx.at(P.o_x);
    for (int d = cx.lane; d < nv; d += G)
      x[d] = (cx.at(P.o_tau)[d] +
              (cx.at(P.o_flim)[d] + (cx.at(P.o_fc)[d] + cx.at(P.o_fsup)[d]))) -
             cx.at(P.o_bias)[d];
    gsync(cx);
    for (int d = cx.lane; d < nv; d += G)
      cx.at(P.o_as)[d] = minv_row<NV>(bl, Minv, x, d);
  }
  if (trace && cx.lane == 0) {
    // the trace bits of the active candidates: active, centre inside its
    // box, tangent frame off the x axis; then the limits and the support
    const int nw = (P.n_cand + 31) >> 5;
    for (int w = 0; w < P.trace_words; ++w) trace[w] = 0;
    const int sf = kRec + P.row_floats;
    const float* slots = cx.at(P.o_slot);
    for (int s = 0; s < P.n_cand; ++s) {
      const float* rec = slots + s * sf;
      if (rec[0] == 0.f) continue;
      const int id = (int)rec[13];
      const int w = id >> 5;
      const int m = (int)(1u << (id & 31));
      trace[w] |= m;
      if (rec[12] != 0.f) trace[nw + w] |= m;
      if (fabsf(rec[7]) < 0.5f) trace[2 * nw + w] |= m;
    }
    uint32_t lim_bits = 0u;
    int n_lim = 0;
    for (int j = 0; j < P.nj; ++j) {
      if (!(bl.jinfo[j] >> 24)) continue;
      if (flags[j]) lim_bits |= 1u << n_lim;
      ++n_lim;
    }
    for (int f = 0; f < P.n_fall; ++f)
      lim_bits |= (uint32_t)flags[P.nj + f] << (24 + 2 * f);
    trace[3 * nw] = (int)lim_bits;
  }
  gsync(cx);
  ENG_PHASE(kEngQacc)
  ENG_COUNT_EVAL
}

// q + v h per joint (engine.integrate_pos): the free joint's position
// linear and its quaternion by the body-frame exponential, a ball joint's
// quaternion likewise, hinges and slides linear.  out may be q.
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

// Lanes over the joints.
template <int G>
__device__ void integrate(const Ctx<G>& cx, const BlockLists& bl,
                          const EngineParams& P, const float* q,
                          const float* v, float h, float* out) {
#pragma unroll 1
  for (int j = cx.lane; j < P.nj; j += G) {
    const int ji = bl.jinfo[j];
    const int jt = ji & 255, qa = (ji >> 8) & 255, va = (ji >> 16) & 255;
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

// One RK4 step (engine.rk4_step: the four stages in order).  The stage's
// velocity and acceleration (vs, as) are the next stage's prev_v, prev_a.
template <int NV, int NB, int G>
__device__ void rk4(const Ctx<G>& cx, const Tables& tb, const EngineParams& P,
                    const BlockLists& bl, int* n_active, int* trace) {
  const int nv = P.nv;
  float* q = cx.at(P.o_q);
  float* v = cx.at(P.o_v);
  float* qs = cx.at(P.o_qs);
  float* vs = cx.at(P.o_vs);
  float* as = cx.at(P.o_as);
  float* accv = cx.at(P.o_accv);
  float* acca = cx.at(P.o_acca);
  for (int d = cx.lane; d < nv; d += G) {
    vs[d] = v[d];
    as[d] = 0.f;
    accv[d] = 0.f;
    acca[d] = 0.f;
  }
  gsync(cx);
#pragma unroll 1
  for (int st = 0; st < 4; ++st) {
    ENG_PHASE_START
    const float hs = st == 0 ? 0.f : (st == 3 ? P.h : P.h_half);
    const float w = (st == 0 || st == 3) ? 1.f : 2.f;
    integrate(cx, bl, P, q, vs, hs, qs);
    gsync(cx);
    for (int d = cx.lane; d < nv; d += G) vs[d] = v[d] + as[d] * hs;
    gsync(cx);
    ENG_PHASE(kEngIntegrate)
    forward<NV, NB, G>(cx, tb, P, bl, n_active,
                       trace ? trace + st * P.trace_words : nullptr);
    ENG_PHASE_RESTART
    for (int d = cx.lane; d < nv; d += G) {
      accv[d] = accv[d] + w * vs[d];
      acca[d] = acca[d] + w * as[d];
    }
    ENG_PHASE(kEngIntegrate)
  }
  ENG_PHASE_START
  for (int d = cx.lane; d < nv; d += G) accv[d] = accv[d] / 6.f;
  gsync(cx);
  integrate(cx, bl, P, q, accv, P.h, q);
  for (int d = cx.lane; d < nv; d += G) v[d] = v[d] + (acca[d] / 6.f) * P.h;
  gsync(cx);
  ENG_PHASE(kEngIntegrate)
}

// One env step: frame_skip RK4 steps, the inner reward, t + 1 and the
// task heads on the anchor (first hit wins), the scalars in lane 0.  No
// reset.
template <int NV, int NB, int G>
__device__ void engine_step(const Ctx<G>& cx, const Tables& tb,
                            const EngineParams& P, const BlockLists& bl,
                            int* t, float* reward, bool* term, int* n_active,
                            int* trace) {
  const float* q = cx.at(P.o_q);
  const float x0 = q[0], y0 = q[1];
#pragma unroll 1
  for (int fs = 0; fs < P.frame_skip; ++fs)
    rk4<NV, NB, G>(cx, tb, P, bl, n_active,
                   trace ? trace + fs * 4 * P.trace_words : nullptr);
  if (cx.lane != 0) return;
  const float* ctrl = cx.at(P.o_ctrl);
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

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Stage the tables and derive the block's lists (thread 0), then a block
// barrier.
__device__ BlockLists stage_block(float* smem, const float* tables,
                                  const EngineParams& P, Tables* tb) {
  for (int i = threadIdx.x; i < P.n_floats; i += blockDim.x)
    smem[i] = tables[i];
  __syncthreads();
  *tb = tables_at(smem, P);
  int* lists = reinterpret_cast<int*>(smem + round4(P.n_floats));
  const BlockLists bl{lists + P.b_rowoff, lists + P.b_dinfo,
                      lists + P.b_binfo,  lists + P.b_chain,
                      lists + P.b_jinfo,  lists + P.b_static,
                      lists + P.b_mpairs};
  if (threadIdx.x == 0) {
    int* rowoff = lists + P.b_rowoff;
    int* dinfo = lists + P.b_dinfo;
    int* binfo = lists + P.b_binfo;
    int* chain = lists + P.b_chain;
    int* jinfo = lists + P.b_jinfo;
    int* sphere_of = lists + P.b_static;
    int* mpairs = lists + P.b_mpairs;
    int t = 0, off = 0;
    for (int d = 0; d < P.nv; ++d) {
      const float* dr = tb->dof + d * kDofCols;
      const int lo = (int)dr[3], hi = (int)dr[4];
      rowoff[d] = off;
      off += hi - lo;
      dinfo[d] = lo | hi << 8 | (int)dr[0] << 16;
      for (int b = lo; b <= d; ++b) mpairs[t++] = d << 8 | b;
    }
    for (int b = 0; b < P.nb; ++b) {
      const float* row = tb->body + b * kBodyCols;
      const int par = (int)row[0];
      const int depth = par < 0 ? 0 : (binfo[par] >> 24) + 1;
      binfo[b] = (par + 1) | (int)row[1] << 8 | (int)row[2] << 16 |
                 depth << 24;
      chain[b] = (int)row[25];
    }
    for (int j = 0; j < P.nj; ++j) {
      const float* jr = tb->jnt + j * kJntCols;
      jinfo[j] = (int)jr[0] | (int)jr[1] << 8 | (int)jr[2] << 16 |
                 (jr[9] != 0.f ? 1 : 0) << 24;
    }
    for (int s = 0; s < P.n_sph; ++s) {
      const int ks = (int)tb->sph[s * kSphCols + 13];
      if (ks >= 0) sphere_of[ks] = s;
    }
  }
  __syncthreads();
  return bl;
}

template <int NV, int NB, int G>
__global__ void __launch_bounds__(kMaxThreads) engine_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    int* __restrict__ active_out, int* __restrict__ trace_out,
    const float* __restrict__ tables, EngineParams P, int n) {
  extern __shared__ float smem[];
  Tables tb;
  const BlockLists bl = stage_block(smem, tables, P, &tb);
  const int gi = threadIdx.x / G;
  const int env = blockIdx.x * (blockDim.x / G) + gi;
  const bool live = env < n;    // a spare group steps env n - 1 unseen
  const int i = live ? env : n - 1;
  Ctx<G> cx;
  cx.lane = threadIdx.x % G;
  cx.g = smem + round4(P.n_floats) + P.blk_floats + gi * P.g_floats;
  for (int j = cx.lane; j < P.nq; j += G)
    cx.at(P.o_q)[j] = qpos[(size_t)i * q_stride + j];
  for (int j = cx.lane; j < P.nv; j += G)
    cx.at(P.o_v)[j] = qvel[(size_t)i * v_stride + j];
  for (int j = cx.lane; j < P.nu; j += G)
    cx.at(P.o_ctrl)[j] = act[(size_t)i * a_stride + j];
  gsync(cx);
  int t = t_in[i], n_active = 0;
  float rew = 0.f;
  bool done = false;
  int* trace = trace_out ? trace_out + (size_t)i * P.frame_skip * 4 *
                                           P.trace_words
                         : nullptr;
  engine_step<NV, NB, G>(cx, tb, P, bl, &t, &rew, &done, &n_active,
                         live ? trace : nullptr);
  if (!live) return;
  for (int j = cx.lane; j < P.nq; j += G)
    qpos_out[(size_t)i * P.nq + j] = cx.at(P.o_q)[j];
  for (int j = cx.lane; j < P.nv; j += G)
    qvel_out[(size_t)i * P.nv + j] = cx.at(P.o_v)[j];
  if (cx.lane == 0) {
    t_out[i] = t;
    reward[i] = rew;
    term[i] = done;
    if (active_out) active_out[i] = n_active;
  }
}

}  // namespace mmt_eng
}  // namespace

// Dynamic shared memory of one launch of `groups` envs a block: the staged
// tables, the block's lists, then each group's fields.
inline int engine_smem_bytes(const EngineParams& p, int groups) {
  return (int)sizeof(float) *
         (mmt_eng::round4(p.n_floats) + p.blk_floats + groups * p.g_floats);
}

// Launch of one instantiation: `groups` envs a block (G lanes each, whole
// warps) with `smem` bytes of dynamic shared memory (refused unless it is
// engine_smem_bytes), on the given stream; returns cudaGetLastError().
template <int NV, int NB, int G>
int launch_engine_step(const float* qpos, const float* qvel, const int* t,
                       const float* act, int q_stride, int v_stride,
                       int a_stride, float* qpos_out, float* qvel_out,
                       int* t_out, float* reward, bool* term,
                       int* active_out, int* trace_out, const float* tables,
                       EngineParams p, int n, int groups, int smem,
                       void* stream) {
  if (groups < 1 || groups * G > mmt_eng::kMaxThreads ||
      groups * G % 32 != 0 || p.nv > NV ||
      p.nb > NB || p.tree_max > G || smem != engine_smem_bytes(p, groups))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mmt_eng::engine_step_kernel<NV, NB, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    mmt_eng::engine_step_kernel<NV, NB, G>
        <<<(n + groups - 1) / groups, groups * G, smem,
           (cudaStream_t)stream>>>(qpos, qvel, t, act, q_stride, v_stride,
                                   a_stride, qpos_out, qvel_out, t_out,
                                   reward, term, active_out, trace_out,
                                   tables, p, n);
  }
  return (int)cudaGetLastError();
}

// Blocks of `groups` envs an SM holds at once with `smem` bytes of dynamic
// shared memory (registers and shared memory both counted); -1 on an
// error.
template <int NV, int NB, int G>
int engine_blocks_per_sm(int groups, int smem) {
  int blocks = -1;
  cudaError_t e = smem > 48 * 1024
                      ? cudaFuncSetAttribute(
                            mmt_eng::engine_step_kernel<NV, NB, G>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                      : cudaSuccess;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mmt_eng::engine_step_kernel<NV, NB, G>, groups * G, smem);
  return e == cudaSuccess ? blocks : -1;
}

// Each .cu file's instantiation (NV dofs, NB bodies, G lanes an env): its
// launch, or with groups_per_sm set its occupancy query into it.
// engine_lane.cu holds the smallest class, engine_mid.cu the middle one
// (both G 8), engine_large.cu the largest (G 32).
#define ENGINE_CLASS_DISPATCH(name, NV, NB, G)                               \
  int name(const float* qpos, const float* qvel, const int* t,             \
           const float* act, int q_stride, int v_stride, int a_stride,     \
           float* qpos_out, float* qvel_out, int* t_out, float* reward,    \
           bool* term, int* active_out, int* trace_out,                    \
           const float* tables, EngineParams p, int n, int groups,         \
           int smem, void* stream, int* groups_per_sm) {                   \
    if (groups_per_sm) {                                                   \
      *groups_per_sm = engine_blocks_per_sm<NV, NB, G>(groups, smem);      \
      return (int)cudaSuccess;                                             \
    }                                                                      \
    return launch_engine_step<NV, NB, G>(                                  \
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out,        \
        qvel_out, t_out, reward, term, active_out, trace_out, tables, p,   \
        n, groups, smem, stream);                                          \
  }

#define ENGINE_CLASS_DECL(name)                                              \
  int name(const float* qpos, const float* qvel, const int* t,             \
           const float* act, int q_stride, int v_stride, int a_stride,     \
           float* qpos_out, float* qvel_out, int* t_out, float* reward,    \
           bool* term, int* active_out, int* trace_out,                    \
           const float* tables, EngineParams p, int n, int groups,         \
           int smem, void* stream, int* groups_per_sm);

ENGINE_CLASS_DECL(engine_small_step)
ENGINE_CLASS_DECL(engine_mid_step)
ENGINE_CLASS_DECL(engine_large_step)
