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
// Design.  One warp steps one env: a group of kLanes lanes, the env index
// the group's, `groups` groups a block (ops/lane_env.py ant_geometry picks
// the count from the spec's counts).  The public (B, nq) / (B, nv)
// row-major tensors are read in place with their row strides.  The
// per-spec data are runtime tables, packed into one float32 buffer that
// each block stages into shared memory: the bodies, the dofs, the
// actuators, the test spheres, the static boxes, the goals, the reset
// pose, for the block worlds the world dofs, the blocks, the platforms
// under falling blocks and the pair-mixed constants of every sphere-vs-
// block pair, and for the ball worlds the ball and the pair-mixed
// constants of every sphere-vs-ball pair.  So one build of each
// instantiation serves every Ant maze of its kind: the counts (blocks,
// world dofs, spheres, boxes) arrive at run time and only their maxima are
// compile-time.  The scalars come by value in AntParams.  Each group's
// state lives in shared memory after the tables (struct Group: the pose
// and velocity, the RK4 stages, the body poses, M and its inverse, the
// ball's block, the force vectors), followed by its contact region: a slot
// of kConStride floats for every candidate contact of the spec (S x (3 +
// blocks + balls) + 3 balls; a slot keeps the contact's bodies, point,
// frame, constants and forces, not its Jacobian), the list of the active
// ones, and a row T of nv + 1 floats for each lane.  The lanes share the
// work:
//   * the spheres: lane s tests sphere s (s + 32, ...) against the floor,
//     its two nearest boxes within reach (by distance alone; the two
//     winners' point and normal come after), the blocks and the ball, and
//     writes each candidate's slot; a ballot over the slots and a prefix
//     count list the active ones in slot order, sphere by sphere; the trace
//     words are ballots over the candidates' bits;
//   * the mass matrix: lanes over its 105 entries (the free joint's 21,
//     on all 13 bodies, first), each summing in body order over the bodies
//     whose root paths hold both dofs, from per (body, dof) vectors J, W and
//     Iw W that the lanes computed before; the Cholesky factor with lane i
//     holding row i in registers (each column's pivot broadcast by a
//     shuffle), the inverse with lane c holding column c in registers;
//   * the kinematics and the RNE recursions level by level down the legs
//     (lanes over bodies), the subtree sums with lanes over the six
//     spatial components;
//   * the rows: lane c builds active contact c's tangent frame, its
//     Jacobian (three rows on its entries: the sphere body's root-path
//     dofs, the block's slides or the ball's six) and A = J Minv J^T over
//     the blocks of Minv that couple them, and keeps J (and, but in the
//     ball worlds, the entries' dofs) in registers through the sweeps
//     (with more contacts than lanes, it recomputes them where it needs
//     them);
//   * the projected Jacobi sweeps: each lane writes its contact's J^T f
//     over its row of T (+0 where the contact has no entry), lane d sums
//     column d over the contacts in list order, lanes over rows take y =
//     Minv x, and lane c updates and projects contact c's forces;
//   * the RK4 stages and the integration with lanes over dofs; the
//     rollout's Philox blocks with lanes over blocks.
// Every sum keeps the order of the one-thread-per-env version of this
// kernel that preceded it (its per-thread loops are the lanes' loops
// here; an added +0 leaves a sum that is never -0 as it is, and a product
// with an entry Minv does not couple is an exact 0 left out), so the two
// compute the same float32 operations in the same order.  A group leaves
// together: a ragged last block's spare groups return after the tables
// are staged, and no block-wide barrier follows.  All of the ball's code
// sits behind `if constexpr (NBALL > 0)`.  A group of 16 lanes (two envs
// a warp) also builds (every lane loop strides by kLanes; barriers,
// ballots and shuffles take the group's mask), but measured slower on the
// card, as did a cap of 168 registers (spills); see PERF.md.
//
// What bounds it on an H100.  About 270 bytes per env and step move
// (1.1 MB at B = 4096), against some 7 x 10^5 fp32 operations per
// env-step (ant_step_flops in chip_smoke.py): the work is bound by fp32
// operations, and the kernel is far from that bound.  Each warp runs a
// chain of dependent steps through shared memory and warp barriers (the
// factor's 14 columns and the two substitutions' 28 divisions, the level
// by level recursions, each contact's rows and the four sweeps), and an SM
// holds 8 warps (the registers, 230-255 a lane; shared memory would take
// 8-10), so 4096 envs run in four waves of warps that each wait on their
// own chain.
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

// Phase counters of a profiling build (nvcc -DMMT_ANT_PHASES; chip_smoke.py
// --ant-phases): lane 0 of each group adds the clock64() cycles of each
// phase of a forward evaluation into g_ant_phases[phase], and counts the
// evaluations in g_ant_phases[kPhaseCount]; each .cu file reads its own
// counters through ANT_PHASES_READER.  Without the macro they compile to
// nothing.
enum AntPhase {
  kPhaseKinematics, kPhaseMassMatrix, kPhaseBias, kPhaseFactor, kPhaseQacc0,
  kPhaseLimits, kPhaseDetect, kPhaseCompact, kPhaseRows, kPhaseSweeps,
  kPhaseSupport, kPhaseQacc, kPhaseCount
};
#ifdef MMT_ANT_PHASES
static __device__ unsigned long long g_ant_phases[kPhaseCount + 1];
#define ANT_PHASE_START long long phase_t0_ = clock64();
#define ANT_PHASE(i)                                                   \
  {                                                                    \
    const long long phase_t1_ = clock64();                             \
    if (cx.lane == 0)                                                  \
      atomicAdd(&g_ant_phases[i],                                      \
                (unsigned long long)(phase_t1_ - phase_t0_));          \
    phase_t0_ = phase_t1_;                                             \
  }
#define ANT_PHASE_RESTART phase_t0_ = clock64();
static const unsigned long long kAntPhasesZero[kPhaseCount + 1] = {};
// name(out) copies the counters to out, or zeroes them where out is null
#define ANT_PHASES_READER(name)                                        \
  extern "C" int name(unsigned long long* out) {                       \
    return out ? (int)cudaMemcpyFromSymbol(out, g_ant_phases,          \
                                           sizeof(g_ant_phases))       \
               : (int)cudaMemcpyToSymbol(g_ant_phases, kAntPhasesZero, \
                                         sizeof(g_ant_phases));        \
  }
#else
#define ANT_PHASE_START
#define ANT_PHASE(i)
#define ANT_PHASE_RESTART
#define ANT_PHASES_READER(name)
#endif

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

// Lanes of the group that steps one env: a full warp (ops/lane_env.py
// ANT_LANES).  16 would also do: every lane loop strides by kLanes, and a
// group's barriers, ballots and shuffles take its own lane mask; the
// factor needs a lane for each of the 14 rows.
constexpr int kLanes = 32;
static_assert(kLanes == 32 || kLanes == 16, "a warp or half of one");
constexpr int kMaxThreads = 256;   // 8 groups a block at most

// A contact slot (kConStride floats; ints stored as their bits).  Odd, so
// that lanes reading one field of consecutive slots hit distinct banks.
constexpr int kCFlags = 0;    // bit 0 active, 1 the sphere centre inside its
                              // box, 2 the ball the contact's first body,
                              // 3 its second
constexpr int kCBody = 1;     // the ant body of the sphere, or -1
constexpr int kCBlk = 2;      // the pair's block, or -1
constexpr int kCPar = 3;      // (mu, d0, dmax, width, tc, dampr): its offset
                              // in the tables
constexpr int kCPos = 4;      // contact point (3)
constexpr int kCDir = 7;      // normal, tangent 1, tangent 2 (9)
constexpr int kCMu = 16;
constexpr int kCRhs = 17;     // aref - a0 (3)
constexpr int kCReg = 20;     // R (3)
constexpr int kCDen = 23;     // A + R + 1e-9 (3)
constexpr int kCF = 26;       // the forces (3); until the rows are built,
                              // dist and margin
constexpr int kConStride = 29;
// The scratch that the contact region lends to the mass matrix (a J, W and
// Iw W vector for each body and root-path dof) and to the RNE recursions
// (the bodies' spatial velocity, acceleration and force), both dead before
// the spheres are tested.
constexpr int kRecFloats = kNb * kBodyDofs * 9;
constexpr int kScratchFloats = kRecFloats + kNb * 18;

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
  static_assert(kMaxSph * (3 + NBLK) + NBALL * (3 + kMaxSph) <= 32 * 8,
                "trace bits");
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

// The ball's tree and its 6x6 block before the factor, or a stand-in.
template <int NBALL>
struct BallSlot {
  float unused;
};
template <>
struct BallSlot<1> {
  Ball b;
  float M[6][6];
};

// One group's state in shared memory (every member 4 bytes: its size is
// group_floats() floats, which ops/lane_env.py ant_group_floats mirrors).
template <int W, int NBLK, int NBALL>
struct Group {
  static constexpr int kNv = Dims<W, NBLK, NBALL>::kNv;
  static constexpr int kNq = Dims<W, NBLK, NBALL>::kNq;
  float q[kNq], qs[kNq];                  // the state, an RK4 stage's pose
  float v[kNv], vs[kNv], as[kNv];         // the velocity, a stage's v, qacc
  float prev_v[kNv], prev_a[kNv], acc_v[kNv], acc_a[kNv];
  float bias[kNv], tau[kNv], rhs[kNv], qacc0[kNv], fcon[kNv], x[kNv],
      y[kNv];
  float ctrl[kNu];
  Kin k;
  float M[kNa][kNa], Minv[kNa][kNa];      // M, then its factor; M^-1
  float Iw[kNb][9];                       // the bodies' world inertias
  float bc[NBLK > 0 ? NBLK : 1][6];       // the blocks' boxes
  BallSlot<NBALL> ball;
  uint32_t words[44];                     // the rollout's reset draws
};

template <int W, int NBLK, int NBALL>
__host__ __device__ constexpr int group_floats() {
  return 2 * Dims<W, NBLK, NBALL>::kNq + 14 * Dims<W, NBLK, NBALL>::kNv +
         kNu + (kNb * 9 + 2 * kNb * 3 + 2 * kNa * 3) + 2 * kNa * kNa +
         kNb * 9 + 6 * (NBLK > 0 ? NBLK : 1) + (NBALL > 0 ? 89 + 36 : 1) + 44;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Candidate contacts of a spec: each sphere's floor, two box picks, blocks
// and ball, then the ball's floor and two box picks.
__host__ __device__ inline int ant_slots(const AntParams& P) {
  return P.n_sph * (3 + P.n_blk + P.n_ball) + 3 * P.n_ball;
}

// Floats of one group: its Group, then its contact region (the slots, the
// list of active ones and a J^T f row T for each lane, or the scratch
// where that is larger).
template <int W, int NBLK, int NBALL>
__host__ __device__ inline int group_stride(const AntParams& P) {
  const int s = ant_slots(P);
  const int con = s * kConStride + s +
                  kLanes * (Dims<W, NBLK, NBALL>::kNv + 1);
  return round4(group_floats<W, NBLK, NBALL>()) +
         round4(con > kScratchFloats ? con : kScratchFloats);
}

struct Tables {
  const float* base;     // the staged buffer (a slot's kCPar counts from it)
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

// Dofs a lane sums J^T f over (nv <= 24).
constexpr int kDofSlots = (24 + kLanes - 1) / kLanes;

// Entries of the 14x14 mass matrix's upper triangle, and a lane's share.
constexpr int kMmEntries = kNa * (kNa + 1) / 2;
constexpr int kMmPerLane = (kMmEntries + kLanes - 1) / kLanes;

// A lane's place in its group, and what it computes of the ant's tree.
struct Ctx {
  int lane;              // 0 .. kLanes - 1
  unsigned mask;         // the group's lanes in its warp
  int shift;             // the group's first lane in its warp
  int depth;             // depth of body `lane` (0: the torso, or none)
  int max_depth;         // of the tree
  int hbody;             // the body whose hinge is dof `lane`, or -1
  // the mass-matrix entries lane + k kLanes: lo | hi << 4 | the two dofs'
  // places in a root-path list << 8, << 12 (a dof's place is the same in
  // every body below it), and the bodies whose lists hold both
  int mm_entry[kMmPerLane];
  uint32_t mm_bodies[kMmPerLane];
};

__device__ __forceinline__ void gsync(const Ctx& cx) { __syncwarp(cx.mask); }

__device__ __forceinline__ unsigned gballot(const Ctx& cx, bool p) {
  return (__ballot_sync(cx.mask, p) & cx.mask) >> cx.shift;
}

__device__ __forceinline__ int geti(const float* ct, int f) {
  return __float_as_int(ct[f]);
}

__device__ __forceinline__ void seti(float* ct, int f, int x) {
  ct[f] = __int_as_float(x);
}

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

// The entry of dof d (>= 0) in a body's row list, or -1.
__device__ __forceinline__ int dof_pos(const float* body, int d) {
  if (d < 6) return d;
  if ((int)body[2] == d) return 6;
  if ((int)body[3] == d) return 7;
  return -1;
}

// ---------------------------------------------------------------------------
// kinematics (engine.fk): torso from the free joint, hinges pre-multiply;
// the bodies of one depth at once
// ---------------------------------------------------------------------------
__device__ void body_pose(const Tables& tb, const float* q, Kin& k, int b) {
  const float* row = tb.body + b * kBodyCols;
  const int par = (int)row[0];
  const int hd = (int)row[1];
  float* R = k.R[b];
  float* p = k.p[b];
  const float* Rp = k.R[par];
  float off[3];
  mat_vec3(Rp, row + 4, off);
  for (int i = 0; i < 3; ++i) p[i] = k.p[par][i] + off[i];
  if (hd >= 0) {
    float a[3];
    mat_vec3(Rp, row + 7, a);
    // Rj = I + s K + (1 - c) K K, K = skew(a)
    const float ang = q[hd + 1];
    const float s = sinf(ang), cm = 1.f - cosf(ang);
    const float K[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0], -a[1], a[0], 0.f};
    float Rj[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float kk = K[r * 3] * K[cc] + K[r * 3 + 1] * K[3 + cc] +
                         K[r * 3 + 2] * K[6 + cc];
        Rj[r * 3 + cc] = (r == cc ? 1.f : 0.f) + s * K[r * 3 + cc] + cm * kk;
      }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        R[r * 3 + cc] = Rj[r * 3] * Rp[cc] + Rj[r * 3 + 1] * Rp[3 + cc] +
                        Rj[r * 3 + 2] * Rp[6 + cc];
    for (int i = 0; i < 3; ++i) {
      k.w[hd][i] = a[i];
      k.anc[hd][i] = p[i];  // the joint sits at the body origin
    }
  } else {
    for (int i = 0; i < 9; ++i) R[i] = Rp[i];
  }
}

__device__ void fk_group(const Ctx& cx, const Tables& tb, const float* q,
                         Kin& k) {
  if (cx.lane == 0) {
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
  gsync(cx);
  for (int lvl = 1; lvl <= cx.max_depth; ++lvl) {
    if (cx.depth == lvl) body_pose(tb, q, k, cx.lane);
    gsync(cx);
  }
  if (cx.lane < kNb) {
    const int b = cx.lane;
    float cw[3];
    mat_vec3(k.R[b], tb.body + b * kBodyCols + 11, cw);
    for (int i = 0; i < 3; ++i) k.c[b][i] = k.p[b][i] + cw[i];
  }
  gsync(cx);
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
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      T[r * 3 + cc] = R[r * 3] * Ic[cc] + R[r * 3 + 1] * Ic[3 + cc] +
                      R[r * 3 + 2] * Ic[6 + cc];
  for (int r = 0; r < 3; ++r)
    for (int cc = 0; cc < 3; ++cc)
      Iw[r * 3 + cc] = T[r * 3] * R[cc * 3] + T[r * 3 + 1] * R[cc * 3 + 1] +
                       T[r * 3 + 2] * R[cc * 3 + 2];
}

// (lo, hi) of entry idx of the upper triangle of the 14x14 mass matrix:
// the 21 entries of the free joint (13 bodies each) first, then the rows
// of the rest.
__device__ __forceinline__ void mm_entry(int idx, int* lo, int* hi) {
  int r = 0;
  if (idx < 21) {
    while (idx >= 6 - r) {
      idx -= 6 - r;
      ++r;
    }
    *lo = r;
    *hi = r + idx;
    return;
  }
  idx -= 21;
  for (;;) {
    const int c0 = r < 6 ? 6 : r;
    if (idx < kNa - c0) {
      *lo = r;
      *hi = c0 + idx;
      return;
    }
    idx -= kNa - c0;
    ++r;
  }
}

__device__ Ctx make_ctx(const Tables& tb) {
  Ctx cx;
  cx.lane = (int)(threadIdx.x % kLanes);
  cx.shift = (int)(threadIdx.x % 32) & ~(kLanes - 1);
  cx.mask = kLanes == 32 ? 0xffffffffu : ((1u << kLanes) - 1u) << cx.shift;
  cx.depth = 0;
  cx.max_depth = 0;
  cx.hbody = -1;
  for (int b = 1; b < kNb; ++b) {
    int dep = 0;
    for (int x = b; x > 0; x = (int)tb.body[x * kBodyCols]) ++dep;
    cx.max_depth = max(cx.max_depth, dep);
    if (b == cx.lane) cx.depth = dep;
    if ((int)tb.body[b * kBodyCols + 1] == cx.lane) cx.hbody = b;
  }
#pragma unroll
  for (int k = 0; k < kMmPerLane; ++k) {
    const int idx = cx.lane + k * kLanes;
    int lo = 0, hi = 0, pi = 0, pj = 0;
    uint32_t bodies = 0u;
    if (idx < kMmEntries) {
      mm_entry(idx, &lo, &hi);
      for (int b = 0; b < kNb; ++b) {
        const float* row = tb.body + b * kBodyCols;
        const int pl = dof_pos(row, lo), ph = dof_pos(row, hi);
        if (pl < 0 || ph < 0) continue;
        bodies |= 1u << b;
        pi = min(pl, ph);
        pj = max(pl, ph);
      }
    }
    cx.mm_entry[k] = lo | hi << 4 | pi << 8 | pj << 12;
    cx.mm_bodies[k] = bodies;
  }
  return cx;
}

// Mass matrix in Jacobian form (ant_math.mass_matrix), plus armature:
// M[lo][hi] sums m J_i . J_j + W_j . Iw W_i (i before j in the body's list)
// over the bodies whose lists hold both dofs, in body order.
__device__ void mass_matrix_group(const Ctx& cx, const Tables& tb,
                                  const Kin& k, float (*Iw)[9],
                                  float (*M)[kNa], float* rec) {
  if (cx.lane < kNb)
    world_inertia(k.R[cx.lane], tb.body + cx.lane * kBodyCols, Iw[cx.lane]);
  gsync(cx);
  for (int t = cx.lane; t < kNb * kBodyDofs; t += kLanes) {
    const int b = t / kBodyDofs;
    const int d = row_dof(tb.body + b * kBodyCols, t % kBodyDofs);
    if (d < 0) continue;
    float* r = rec + 9 * t;  // J, W, Iw W
    dof_basis(k, d, k.c[b], r, r + 3);
    mat_vec3(Iw[b], r + 3, r + 6);
  }
  gsync(cx);
#pragma unroll
  for (int k = 0; k < kMmPerLane; ++k) {
    if (cx.lane + k * kLanes >= kMmEntries) continue;
    const int e = cx.mm_entry[k];
    const int lo = e & 15, hi = (e >> 4) & 15;
    const int pi = (e >> 8) & 15, pj = (e >> 12) & 15;
    float s = 0.f;
    uint32_t m = cx.mm_bodies[k];
#pragma unroll 1
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1u;
      const float* ri = rec + 9 * (b * kBodyDofs + pi);
      const float* rj = rec + 9 * (b * kBodyDofs + pj);
      const float term =
          dot3(ri, rj) * tb.body[b * kBodyCols + 10] + dot3(rj + 3, ri + 6);
      s = s + term;
    }
    if (lo == hi) s = s + tb.dof[lo * kDofCols];
    M[lo][hi] = s;
    M[hi][lo] = s;
  }
  gsync(cx);
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
// origin p0 (engine.rne_bias, which takes the same reference point): the
// recursions level by level, the bodies' forces one a lane, the subtree
// sums one spatial component a lane.
__device__ void rne_bias_group(const Ctx& cx, const Tables& tb,
                               const AntParams& P, const Kin& k,
                               const float* v, const float (*Iw)[9],
                               float* bias, float* scratch) {
  float (*vel)[6] = reinterpret_cast<float (*)[6]>(scratch);
  float (*acc)[6] = vel + kNb;
  float (*frc)[6] = acc + kNb;
  // torso: free dofs in order; angular cdofdot uses the full torso velocity
  if (cx.lane == 0) {
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
  gsync(cx);
  for (int lvl = 1; lvl <= cx.max_depth; ++lvl) {
    if (cx.depth == lvl) {
      const int b = cx.lane;
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
    gsync(cx);
  }
  if (cx.lane < kNb) {
    const int b = cx.lane;
    const float* row = tb.body + b * kBodyCols;
    const float crel[3] = {k.c[b][0] - k.p[0][0], k.c[b][1] - k.p[0][1],
                           k.c[b][2] - k.p[0][2]};
    float Ia[6], Iv[6], t[3];
    inertia_mul(Iw[b], row[10], crel, acc[b], Ia);
    inertia_mul(Iw[b], row[10], crel, vel[b], Iv);
    // v x* (I v) = [w x m + v x f; w x f]
    float fx[6];
    cross3(vel[b], Iv, fx);
    cross3(vel[b] + 3, Iv + 3, t);
    for (int i = 0; i < 3; ++i) fx[i] = fx[i] + t[i];
    cross3(vel[b], Iv + 3, fx + 3);
    for (int i = 0; i < 6; ++i) frc[b][i] = Ia[i] + fx[i];
  }
  gsync(cx);
  // subtree sums: children come after their parents in the body order
  if (cx.lane < 6) {
    const int i = cx.lane;
    for (int b = kNb - 1; b >= 1; --b) {
      const int par = (int)tb.body[b * kBodyCols];
      frc[par][i] = frc[par][i] + frc[b][i];
    }
  }
  gsync(cx);
  if (cx.lane < kNa) {
    const int d = cx.lane;
    const int b = d < 6 ? 0 : cx.hbody;
    if (b >= 0) {
      float s[6];
      cdof(k, d, s);
      bias[d] = dot3(s, frc[b]) + dot3(s + 3, frc[b] + 3);
    }
  }
}

// Minv = M^-1 by the Cholesky factor (linalg.spd_inverse): M is
// overwritten with L.  N = 14 for the ant, 6 for the ball.  Lane i keeps
// row i in registers and factors it column by column (the pivot's sum
// broadcast by a shuffle, the other rows' L read from shared memory), then
// lane c keeps column c of the inverse in registers through the two
// substitutions.
template <int N>
__device__ void spd_inverse_group(const Ctx& cx, float (*M)[N],
                                  float (*Minv)[N]) {
  static_assert(N <= kLanes, "a lane for each row");
  const int i = cx.lane;
  const bool row = i < N;
  float a[N];
#pragma unroll
  for (int kk = 0; kk < N; ++kk) a[kk] = row ? M[i][kk] : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
    if (row && i >= j) {
      s = a[j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s = s - a[kk] * M[j][kk];
    }
    const float sj = __shfl_sync(cx.mask, s, j, kLanes);
    const float d = sqrtf(fmaxf(sj, 1e-12f));
    if (row && i >= j) {
      a[j] = s / d;
      M[i][j] = a[j];
    }
    gsync(cx);
  }
  // forward substitution L Y = I, then back substitution L^T X = Y
  if (row) {
    const int c = i;
    float x[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float acc = r == c ? 1.f : 0.f;
#pragma unroll
      for (int kk = 0; kk < r; ++kk) acc = acc - M[r][kk] * x[kk];
      x[r] = acc / M[r][r];
    }
#pragma unroll
    for (int r = N - 1; r >= 0; --r) {
      float acc = x[r];
#pragma unroll
      for (int kk = r + 1; kk < N; ++kk) acc = acc - M[kk][r] * x[kk];
      x[r] = acc / M[r][r];
    }
#pragma unroll
    for (int r = 0; r < N; ++r) Minv[r][c] = x[r];
  }
  gsync(cx);
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
// o; the sphere sits at the body-frame com.  One lane computes the tree
// and its bias, the lanes the 21 entries of the block and its inverse.
__device__ void ball_dynamics_group(const Ctx& cx, const Tables& tb,
                                    const AntParams& P, const float* q,
                                    const float* v, Ball& bl, float (*Mb)[6],
                                    float* bias) {
  if (cx.lane == 0) {
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
  }
  gsync(cx);
  // M = (I s_a) . s_b over the tree (b <= a), then its inverse
  for (int t = cx.lane; t < 21; t += kLanes) {
    int a = 0, b = t;
    while (b > a) {
      b -= a + 1;
      ++a;
    }
    float F[6];
    ball_inertia_mul(bl, bl.cdof[a], F);
    const float x = dot6(F, bl.cdof[b]);
    Mb[a][b] = x;
    Mb[b][a] = x;
  }
  gsync(cx);
  spd_inverse_group<6>(cx, Mb, bl.Minv);
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

// sphere_box's signed distance alone (the same operations).
__device__ __forceinline__ float sphere_box_dist(const float* c, float r,
                                                 const float* bx) {
  float local[3], delta[3];
  for (int i = 0; i < 3; ++i) {
    local[i] = c[i] - bx[i];
    delta[i] = local[i] - fmaxf(fminf(local[i], bx[3 + i]), -bx[3 + i]);
  }
  const float d_out = sqrtf(delta[0] * delta[0] + delta[1] * delta[1] +
                            delta[2] * delta[2] + 1e-12f);
  const float ex = bx[3] - fabsf(local[0]);
  const float ey = bx[4] - fabsf(local[1]);
  const float ez = bx[5] - fabsf(local[2]);
  const float pen_in = -fminf(fminf(ex, ey), ez);
  return d_out > 1e-6f ? d_out - r : pen_in - r;
}

// The two nearest static boxes of a sphere by dist - box margin (strict
// <: the first of equal keys wins); a pick no box filled stays at an
// infinite distance, never active.  Only the distances decide: a pick's
// point and normal come from sphere_box on its box afterwards.
struct Nearest2 {
  float e[2] = {INFINITY, INFINITY}, d[2] = {INFINITY, INFINITY};
  float m[2] = {0.f, 0.f};
  int box[2] = {0, 0};

  __device__ __forceinline__ void test(const float* c, float r,
                                       const float* boxes, int b) {
    const float* bx = boxes + b * kBoxCols;
    const float dist = sphere_box_dist(c, r, bx);
    const float ee = dist - bx[6];
    const bool b1 = ee < e[0];
    const bool b2 = !b1 && ee < e[1];
    if (b1) {
      e[1] = e[0]; d[1] = d[0]; m[1] = m[0]; box[1] = box[0];
      e[0] = ee; d[0] = dist; m[0] = bx[6]; box[0] = b;
    } else if (b2) {
      e[1] = ee; d[1] = dist; m[1] = bx[6]; box[1] = b;
    }
  }
};

// Row i of y = Minv x over the ant's and the slides' ns dofs and the
// ball's six.
template <int NBALL>
__device__ __forceinline__ float minv_row(const Tables& tb,
                                          const float (*Minv)[kNa],
                                          const Ball* bl, int ns,
                                          const float* x, int i) {
  if (i < kNa) {
    float s = 0.f;
    for (int j = 0; j < kNa; ++j) s = s + Minv[i][j] * x[j];
    return s;
  }
  if (i < ns) return tb.wdof[(i - kNa) * kWdofCols + 6] * x[i];
  float s = 0.f;
  if constexpr (NBALL > 0) {
    const int va = bl->va;
    for (int j = 0; j < 6; ++j) s = s + bl->Minv[i - va][j] * x[va + j];
  }
  return s;
}

// The dof of entry e of a contact's row list: the sphere body's root-path
// dofs, then the block's slide dofs, then the ball's six (-1 where there
// are fewer, or where that body is not in the contact).
template <int NBLK, int NBALL>
__device__ __forceinline__ int con_dof(const Tables& tb, const float* ct,
                                       int e) {
  if (e < kBodyDofs) {
    const int body = geti(ct, kCBody);
    if (body < 0) return -1;
    return row_dof(tb.body + body * kBodyCols, e);
  }
  if constexpr (NBALL > 0) {
    constexpr int kBall = Rows<NBLK, NBALL>::kBall;
    if (e >= kBall)
      return geti(ct, kCFlags) & 12 ? (int)tb.ball[1] + (e - kBall) : -1;
  }
  const int blk = geti(ct, kCBlk);
  if (blk < 0) return -1;
  const float* br = tb.blk + blk * kBlkCols;
  const int k = e - kBodyDofs;
  return k < (int)br[7] ? (int)br[6] + k : -1;
}

// The dofs of a contact's row entries (con_dof), in registers.
template <int NBLK, int NBALL>
__device__ __forceinline__ void con_dofs(const Tables& tb, const float* ct,
                                         int* dof) {
#pragma unroll
  for (int e = 0; e < Rows<NBLK, NBALL>::kR; ++e)
    dof[e] = con_dof<NBLK, NBALL>(tb, ct, e);
}

// The contact's three rows (normal, tangent 1, tangent 2) on its entries:
// a sphere body's dof, dir . (w x (x - anchor)) or dir[d]; a block's slide,
// -dir[axis] (the block is the contact's second body); the ball's dof,
// +-[(x - o) x dir; dir] . cdof (+ as the contact's first body); 0 where
// the list has no dof.
template <int NBLK, int NBALL>
__device__ __forceinline__ void contact_jac(
    const Tables& tb, const Kin& k, const Ball* bl, const float* ct,
    const int* dof, float (*J)[Rows<NBLK, NBALL>::kR]) {
#pragma unroll
  for (int e = 0; e < Rows<NBLK, NBALL>::kR; ++e) {
    const int d = dof[e];
    if (d < 0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) J[r][e] = 0.f;
    } else if (e < kBodyDofs) {
      float Jl[3], W[3];
      dof_basis(k, d, ct + kCPos, Jl, W);
#pragma unroll
      for (int r = 0; r < 3; ++r) J[r][e] = dot3(Jl, ct + kCDir + 3 * r);
    } else if constexpr (NBALL > 0) {
      const float* pos = ct + kCPos;
      const float rel[3] = {pos[0] - bl->o[0], pos[1] - bl->o[1],
                            pos[2] - bl->o[2]};
      const bool second = geti(ct, kCFlags) & 8;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* dir = ct + kCDir + 3 * r;
        float Fb[6];
        cross3(rel, dir, Fb);
        for (int i = 0; i < 3; ++i) Fb[3 + i] = dir[i];
        const float x = dot6(Fb, bl->cdof[d - bl->va]);
        J[r][e] = second ? -x : x;
      }
    } else {
      const int ax = (int)tb.wdof[(d - kNa) * kWdofCols];
#pragma unroll
      for (int r = 0; r < 3; ++r) J[r][e] = -ct[kCDir + 3 * r + ax];
    }
  }
}

// Write one candidate into its slot: flags (active, inside, the ball's
// role), bodies, constants, point, normal, and dist and margin until the
// rows are built.
__device__ __forceinline__ void put_contact(float* ct, int flags, int body,
                                            int blk, int par, float p0,
                                            float p1, float p2, float n0,
                                            float n1, float n2, float dist,
                                            float margin) {
  seti(ct, kCFlags, flags);
  seti(ct, kCBody, body);
  seti(ct, kCBlk, blk);
  seti(ct, kCPar, par);
  ct[kCPos] = p0;
  ct[kCPos + 1] = p1;
  ct[kCPos + 2] = p2;
  ct[kCDir] = n0;
  ct[kCDir + 1] = n1;
  ct[kCDir + 2] = n2;
  ct[kCF] = dist;
  ct[kCF + 1] = margin;
}

// Test sphere s against the floor, its two nearest boxes within reach (the
// bit set near), every block and the ball, writing the slots s K .. s K +
// K - 1: floor, picks, blocks, ball.
template <int NBLK, int NBALL>
__device__ void detect_sphere(const Tables& tb, const AntParams& P,
                              const Kin& k, const Ball* bl,
                              const float (*bc)[6], const uint32_t* near,
                              int s, int K, float* con) {
  const int S = P.n_sph;
  const float* sp = tb.sph + s * kSphCols;
  const int body = (int)sp[0];
  float c[3];
  mat_vec3(k.R[body], sp + 1, c);
  for (int i = 0; i < 3; ++i) c[i] = k.p[body][i] + c[i];
  const float r = sp[4];
  float* slot = con + s * K * kConStride;
  const int par_sph = (int)(sp + 7 - tb.base);
  {  // floor plane z = 0
    const float dist = c[2] - r;
    if (dist < sp[6]) {
      put_contact(slot, 1, body, -1, par_sph, c[0], c[1], c[2] - r, 0.f, 0.f,
                  1.f, dist, sp[6]);
    } else {
      seti(slot, kCFlags, 0);
    }
  }
  // the two nearest boxes within reach
  Nearest2 pick;
#pragma unroll
  for (int w = 0; w < kBoxWords; ++w) {
    uint32_t m = near[w];
#pragma unroll 1
    while (m) {
      const int b = (w << 5) + __ffs(m) - 1;
      m &= m - 1u;
      pick.test(c, r, tb.box, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* ct = slot + (1 + j) * kConStride;
    const float margin = sp[5] + pick.m[j];
    if (pick.d[j] < margin) {
      float dist, pos[3], n[3];
      bool inside;
      sphere_box(c, r, tb.box + pick.box[j] * kBoxCols, &dist, pos, n,
                 &inside);
      put_contact(ct, 1 | (inside ? 2 : 0), body, -1, par_sph, pos[0],
                  pos[1], pos[2], n[0], n[1], n[2], dist, margin);
    } else {
      seti(ct, kCFlags, 0);
    }
  }
  // every movable block (the box frame is the world's: slides only)
#pragma unroll 1
  for (int b = 0; b < P.n_blk; ++b) {
    const float* pr = tb.qpair + (b * S + s) * kPairCols;
    float* ct = slot + (3 + b) * kConStride;
    float dist, pos[3], n[3];
    bool inside;
    sphere_box(c, r, bc[b], &dist, pos, n, &inside);
    if (dist < pr[0])
      put_contact(ct, 1 | (inside ? 2 : 0), body, b, (int)(pr + 1 - tb.base),
                  pos[0], pos[1], pos[2], n[0], n[1], n[2], dist, pr[0]);
    else
      seti(ct, kCFlags, 0);
  }
  // the ball, the pair's second body: the normal from its centre to the
  // sphere's, the point midway through the overlap
  if constexpr (NBALL > 0) {
    const float* pr = tb.bpair + s * kPairCols;
    float* ct = slot + (3 + P.n_blk) * kConStride;
    const float rb = tb.ball[2];
    const float d[3] = {c[0] - bl->c[0], c[1] - bl->c[1], c[2] - bl->c[2]};
    const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12f);
    const float n[3] = {d[0] / dn, d[1] / dn, d[2] / dn};
    const float dist = dn - (r + rb);
    if (dist < pr[0]) {
      const float reach = rb + dist * 0.5f;
      put_contact(ct, 1 | 8, body, -1, (int)(pr + 1 - tb.base),
                  bl->c[0] + n[0] * reach, bl->c[1] + n[1] * reach,
                  bl->c[2] + n[2] * reach, n[0], n[1], n[2], dist, pr[0]);
    } else {
      seti(ct, kCFlags, 0);
    }
  }
}

// The ball against the floor and the two nearest of all static boxes: the
// slots after the spheres'.
__device__ void detect_ball(const Tables& tb, const AntParams& P,
                            const Ball* bl, float* slot) {
  const float* br = tb.ball;
  const float* c = bl->c;
  const float rb = br[2];
  const int par = (int)(br + kBallPar - tb.base);
  const float dist = c[2] - rb;
  if (dist < br[9]) {
    put_contact(slot, 1 | 4, -1, -1, par, c[0], c[1], c[2] - rb, 0.f, 0.f,
                1.f, dist, br[9]);
  } else {
    seti(slot, kCFlags, 0);
  }
  Nearest2 pick;
#pragma unroll 1
  for (int b = 0; b < P.n_box; ++b) pick.test(c, rb, tb.box, b);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* ct = slot + (1 + j) * kConStride;
    const float margin = br[8] + pick.m[j];
    if (pick.d[j] < margin) {
      float dist, pos[3], n[3];
      bool inside;
      sphere_box(c, rb, tb.box + pick.box[j] * kBoxCols, &dist, pos, n,
                 &inside);
      put_contact(ct, 1 | 4 | (inside ? 2 : 0), -1, -1, par, pos[0], pos[1],
                  pos[2], n[0], n[1], n[2], dist, margin);
    } else {
      seti(ct, kCFlags, 0);
    }
  }
}

// The slot of trace bit b (kind * S + sphere; then, from (3 + blocks) S,
// the ball against the floor, its first and second box pick, then each
// sphere against the ball), or -1 past the candidates.
__device__ __forceinline__ int bit_slot(const AntParams& P, int b) {
  const int S = P.n_sph, K = 3 + P.n_blk + P.n_ball;
  const int ball_bit = (3 + P.n_blk) * S;
  if (b < ball_bit) return (b % S) * K + b / S;
  b -= ball_bit;
  if (P.n_ball == 0 || b >= 3 + S) return -1;
  return b < 3 ? S * K + b : (b - 3) * K + 3 + P.n_blk;
}

// An active contact's tangent frame (reference x if |n.x| < 0.5, else
// y) and friction, into its slot.
__device__ __forceinline__ void contact_frame(const Tables& tb, float* ct) {
  ct[kCMu] = tb.base[geti(ct, kCPar)];
  const float* nrm = ct + kCDir;
  const bool use_x = fabsf(nrm[0]) < 0.5f;
  const float ref[3] = {use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f};
  float t1[3], t2[3];
  cross3(nrm, ref, t1);
  const float tn = sqrtf(dot3(t1, t1) + 1e-12f);
  for (int i = 0; i < 3; ++i) t1[i] = t1[i] / tn;
  cross3(nrm, t1, t2);
  for (int i = 0; i < 3; ++i) {
    ct[kCDir + 3 + i] = t1[i];
    ct[kCDir + 6 + i] = t2[i];
  }
}

// An active contact's rows from its Jacobian J: the impedance constants,
// A = J Minv J^T, aref - a0, R and the denominator (contact.py
// contact_qfrc, row by row).  The slot's (mu, d0, dmax, width, tc, dampr)
// are those of the sphere, of the sphere-block or sphere-ball pair, or of
// the ball.
template <int NBLK, int NBALL>
__device__ void contact_rows(const Tables& tb, const float (*Minv)[kNa],
                             const Ball* bl, const float* v,
                             const float* qacc0, const int* dof,
                             const float (*J)[Rows<NBLK, NBALL>::kR],
                             float* ct) {
  constexpr int R = Rows<NBLK, NBALL>::kR;
  const float* par = tb.base + geti(ct, kCPar);
  const float d0 = par[1], dmax = par[2], width = par[3];
  const float tc = par[4], dampr = par[5];
  const float r = ct[kCF] - ct[kCF + 1];  // dist - margin
  const float b_imp = 2.f / (dmax * tc);
  const float imp = d0 + (dmax - d0) * clampf(-r / width, 0.f, 1.f);
  const float k_imp = imp / (dmax * dmax * tc * tc * dampr * dampr);
  const float rfac = (1.f - imp) / fmaxf(imp, 1e-6f);
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    float A = 0.f, vr = 0.f, ar = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (dof[i] < 0) continue;
      // (J Minv)_i over the entries that M^-1 couples to entry i: the
      // body's (the ant's block), the ball's (its block), or a slide's own
      // (a diagonal); the other products are exact zeros, which leave the
      // sum as it is
      float s = 0.f;
      if (i < kBodyDofs) {
#pragma unroll
        for (int j = 0; j < kBodyDofs; ++j)
          if (dof[j] >= 0) s = s + J[rr][j] * Minv[dof[j]][dof[i]];
      } else if constexpr (NBALL > 0) {
        constexpr int kBall = Rows<NBLK, NBALL>::kBall;
        const int va = bl->va;
#pragma unroll
        for (int j = kBall; j < R; ++j)
          if (dof[j] >= 0)
            s = s + J[rr][j] * bl->Minv[dof[j] - va][dof[i] - va];
      } else {
        s = s + J[rr][i] * tb.wdof[(dof[i] - kNa) * kWdofCols + 6];
      }
      A = A + s * J[rr][i];
      vr = vr + J[rr][i] * v[dof[i]];
      ar = ar + J[rr][i] * qacc0[dof[i]];
    }
    const float aref = rr == 0 ? -b_imp * vr - k_imp * r : -b_imp * vr;
    const float reg = rfac * A;
    ct[kCRhs + rr] = aref - ar;
    ct[kCReg + rr] = reg;
    ct[kCDen + rr] = A + reg + 1e-9f;
  }
}

// Friction-cone projection of one contact's (f_n, f_t1, f_t2), in
// registers.
__device__ __forceinline__ void project(float mu, float* f) {
  const float fn = fmaxf(f[0], 0.f);
  const float ftn = sqrtf(f[1] * f[1] + f[2] * f[2] + 1e-12f);
  const float scale = fminf(mu * fn / ftn, 1.f);
  f[0] = fn;
  f[1] = f[1] * scale;
  f[2] = f[2] * scale;
}

// One Jacobi update of one contact from y = M^-1 J^T f: A f = J y, the
// residual, the relaxed step and the projection.
template <int NBLK, int NBALL>
__device__ __forceinline__ void sweep_contact(
    const AntParams& P, const int* dof,
    const float (*J)[Rows<NBLK, NBALL>::kR], const float* y, float* ct) {
  float af[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < Rows<NBLK, NBALL>::kR; ++e) {
    if (dof[e] < 0) continue;
    const float yd = y[dof[e]];
#pragma unroll
    for (int r = 0; r < 3; ++r) af[r] = af[r] + J[r][e] * yd;
  }
  float f[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float resid = ct[kCRhs + r] - af[r] - ct[kCReg + r] * ct[kCF + r];
    f[r] = ct[kCF + r] + P.omega * resid / ct[kCDen + r];
  }
  project(ct[kCMu], f);
#pragma unroll
  for (int r = 0; r < 3; ++r) ct[kCF + r] = f[r];
}

// A contact's entries of J^T f written over its lane's row of T (nv
// floats): +0 where the contact has no entry.
template <int NV, int NBLK, int NBALL>
__device__ __forceinline__ void jt_f_row(
    const int* dof, const float (*J)[Rows<NBLK, NBALL>::kR], const float* ct,
    int nv, float* row) {
#pragma unroll
  for (int d = 0; d < NV; ++d)
    if (d < nv) row[d] = 0.f;
  const float* f = ct + kCF;
#pragma unroll
  for (int e = 0; e < Rows<NBLK, NBALL>::kR; ++e)
    if (dof[e] >= 0)
      row[dof[e]] = J[0][e] * f[0] + J[1][e] * f[1] + J[2][e] * f[2];
}

// Contact detection, compacted active list and the projected-Jacobi
// solve; adds the contact force into fcon.  bc holds each block's box
// (center3, half3), bl the ball's tree.  Writes the trace's contact words
// (kind 0 the floor, 1-2 the first and second static-box pick, 3 + b block
// b, bit kind * S + sphere; then, from (3 + blocks) * S, the ball against
// the floor, its first and second box pick, then each sphere against the
// ball) when trace is not null.  Returns the active count.
template <int W, int NBLK, int NBALL>
__device__ int contact_force_group(const Ctx& cx, const Tables& tb,
                                   const AntParams& P, const Kin& k,
                                   const float (*Minv)[kNa], const Ball* bl,
                                   const float* v, const float* qacc0,
                                   const float (*bc)[6], float* fcon,
                                   float* x, float* y, float* con,
                                   int* trace) {
  const int ns = kNa + P.n_w;
  const int nv = ns + 6 * NBALL;
  const int S = P.n_sph, K = 3 + P.n_blk + P.n_ball;
  const int n_slots = ant_slots(P);
  int* list = reinterpret_cast<int*>(con + n_slots * kConStride);
  ANT_PHASE_START
  // the static boxes within reach of the torso, as a bit set
  uint32_t near[kBoxWords];
#pragma unroll
  for (int w = 0; w < kBoxWords; ++w) {
    near[w] = 0u;
#pragma unroll
    for (int h = 0; h < 32; h += kLanes) {
      const int b = 32 * w + h + cx.lane;
      bool in = false;
      if (b < P.n_box) {
        const float* bx = tb.box + b * kBoxCols;
        float d = 0.f;
        for (int i = 0; i < 3; ++i) {
          const float di = fmaxf(fabsf(k.p[0][i] - bx[i]) - bx[3 + i], 0.f);
          d = d + di * di;
        }
        in = d <= P.reach2;
      }
      near[w] |= gballot(cx, in) << h;
    }
  }
#pragma unroll 1
  for (int s = cx.lane; s < S; s += kLanes)
    detect_sphere<NBLK, NBALL>(tb, P, k, bl, bc, near, s, K, con);
  if constexpr (NBALL > 0) {
    if (cx.lane == 0) detect_ball(tb, P, bl, con + S * K * kConStride);
  }
  gsync(cx);
  ANT_PHASE(kPhaseDetect)
  // the active slots, in slot order
  int nc = 0;
#pragma unroll 1
  for (int base = 0; base < n_slots; base += kLanes) {
    const int slot = base + cx.lane;
    const bool act =
        slot < n_slots && (geti(con + slot * kConStride, kCFlags) & 1);
    const unsigned bal = gballot(cx, act);
    if (act) list[nc + __popc(bal & ((1u << cx.lane) - 1u))] = slot;
    nc += __popc(bal);
  }
  if (trace) {
    // active, inside, tangent frame off the x axis: one ballot a word
#pragma unroll 1
    for (int w = 0; w < 8; ++w) {
      unsigned words[3] = {0u, 0u, 0u};
#pragma unroll
      for (int h = 0; h < 32; h += kLanes) {
        const int slot = bit_slot(P, 32 * w + h + cx.lane);
        const float* ct = con + (slot < 0 ? 0 : slot) * kConStride;
        const int fl = slot < 0 ? 0 : geti(ct, kCFlags);
        const bool act = fl & 1;
        words[0] |= gballot(cx, act) << h;
        words[1] |= gballot(cx, act && (fl & 2)) << h;
        words[2] |= gballot(cx, act && fabsf(ct[kCDir]) < 0.5f) << h;
      }
      if (cx.lane == 0) {
        trace[w] = (int)words[0];
        trace[8 + w] = (int)words[1];
        trace[16 + w] = (int)words[2];
      }
    }
  }
  gsync(cx);
  ANT_PHASE(kPhaseCompact)
  if (nc == 0) return 0;
  // the rows: lane c builds contact c's (c + kLanes, ...) and keeps its J
  // and its entries' dofs in registers when nc <= kLanes, else recomputes
  // them where it needs them; then its first Jacobi forces.  The ball
  // worlds read the dofs again each time: their 14 would spill the
  // rollout kernel's registers.
  constexpr int R = Rows<NBLK, NBALL>::kR;
  constexpr bool kRereadDofs = NBALL > 0;
  const bool cached = nc <= kLanes;
  int dof[R];
  float J[3][R];
#pragma unroll 1
  for (int c = cx.lane; c < nc; c += kLanes) {
    float* ct = con + list[c] * kConStride;
    contact_frame(tb, ct);
    con_dofs<NBLK, NBALL>(tb, ct, dof);
    contact_jac<NBLK, NBALL>(tb, k, bl, ct, dof, J);
    contact_rows<NBLK, NBALL>(tb, Minv, bl, v, qacc0, dof, J, ct);
    float f[3];
    for (int r = 0; r < 3; ++r) f[r] = ct[kCRhs + r] / ct[kCDen + r];
    project(ct[kCMu], f);
    for (int r = 0; r < 3; ++r) ct[kCF + r] = f[r];
  }
  gsync(cx);
  ANT_PHASE(kPhaseRows)
  // projected Jacobi on (A + R) f = aref - a0, all rows in parallel: x =
  // J^T f summed over the contacts in list order (each contact's lane
  // writes its row of T, lane d adds up column d), y = M^-1 x, then each
  // contact's update; the pass after the last sweep adds J^T f into fcon
  float* T = con + n_slots * (kConStride + 1);
  constexpr int kT = Group<W, NBLK, NBALL>::kNv + 1;
#pragma unroll 1
  for (int it = 0;; ++it) {
    const bool last = it == P.solver_iters;
    float acc[kDofSlots];
#pragma unroll
    for (int j = 0; j < kDofSlots; ++j) {
      const int d = cx.lane + j * kLanes;
      acc[j] = last && d < nv ? fcon[d] : 0.f;
    }
#pragma unroll 1
    for (int base = 0; base < nc; base += kLanes) {
      const int c = base + cx.lane;
      if (c < nc) {
        const float* ct = con + list[c] * kConStride;
        if (!cached || kRereadDofs) con_dofs<NBLK, NBALL>(tb, ct, dof);
        if (!cached) contact_jac<NBLK, NBALL>(tb, k, bl, ct, dof, J);
        jt_f_row<kT - 1, NBLK, NBALL>(dof, J, ct, nv, T + cx.lane * kT);
      }
      gsync(cx);
      const int n = min(kLanes, nc - base);
#pragma unroll
      for (int j = 0; j < kDofSlots; ++j) {
        const int d = cx.lane + j * kLanes;
        if (d < nv) {
#pragma unroll 4
          for (int cc = 0; cc < n; ++cc) acc[j] = acc[j] + T[cc * kT + d];
        }
      }
      if (base + kLanes < nc) gsync(cx);  // T read before the next chunk's
    }
#pragma unroll
    for (int j = 0; j < kDofSlots; ++j) {
      const int d = cx.lane + j * kLanes;
      if (d < nv) (last ? fcon : x)[d] = acc[j];
    }
    if (last) break;
    gsync(cx);
    for (int d = cx.lane; d < nv; d += kLanes)
      y[d] = minv_row<NBALL>(tb, Minv, bl, ns, x, d);
    gsync(cx);
#pragma unroll 1
    for (int c = cx.lane; c < nc; c += kLanes) {
      float* ct = con + list[c] * kConStride;
      if (!cached || kRereadDofs) con_dofs<NBLK, NBALL>(tb, ct, dof);
      if (!cached) contact_jac<NBLK, NBALL>(tb, k, bl, ct, dof, J);
      sweep_contact<NBLK, NBALL>(P, dof, J, y, ct);
    }
    // a contact's forces are read next by its own lane; T and y are
    // rewritten only after the barriers ahead
  }
  gsync(cx);
  ANT_PHASE(kPhaseSweeps)
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
__device__ void forward_group(const Ctx& cx, const Tables& tb,
                              const AntParams& P, Group<W, NBLK, NBALL>& G,
                              float* region, const float* q, const float* v,
                              float* qacc, int* n_active, int* trace) {
  const int ns = kNa + P.n_w;         // the ant's and the slides' dofs
  const int nv = ns + 6 * NBALL;
  const Kin& k = G.k;
  ANT_PHASE_START
#ifdef MMT_ANT_PHASES
  if (cx.lane == 0) atomicAdd(&g_ant_phases[kPhaseCount], 1ull);
#endif
  fk_group(cx, tb, q, G.k);
  ANT_PHASE(kPhaseKinematics)
  mass_matrix_group(cx, tb, k, G.Iw, G.M, region);
  ANT_PHASE(kPhaseMassMatrix)
  rne_bias_group(cx, tb, P, k, v, G.Iw, G.bias, region + kRecFloats);
  for (int d = cx.lane; d < nv; d += kLanes) {
    float s = 0.f;
    if (d < kNa) {
      for (int u = 0; u < kNu; ++u) {
        const float* a = tb.act + u * kActCols;
        if ((int)a[0] == d) s = s + a[1] * clampf(G.ctrl[u], a[2], a[3]);
      }
      s = s - tb.dof[d * kDofCols + 1] * v[d];
    } else if (d < ns) {
      // world dofs: gravity on the z slides (pure translation: no
      // velocity products), no actuation or damping
      const float* wr = tb.wdof + (d - kNa) * kWdofCols;
      G.bias[d] = (int)wr[0] == 2 ? wr[1] * P.gravity : 0.f;
    }
    G.tau[d] = s;
  }
  // the ball's tree: its bias and its 6x6 block's inverse (no actuation,
  // damping or limits)
  const Ball* bl = nullptr;
  if constexpr (NBALL > 0) {
    ball_dynamics_group(cx, tb, P, q, v, G.ball.b, G.ball.M, G.bias);
    bl = &G.ball.b;
  }
  gsync(cx);
  ANT_PHASE(kPhaseBias)
  spd_inverse_group<kNa>(cx, G.M, G.Minv);
  ANT_PHASE(kPhaseFactor)
  for (int d = cx.lane; d < nv; d += kLanes) {
    G.rhs[d] = G.tau[d] - G.bias[d];
    G.fcon[d] = 0.f;
  }
  gsync(cx);
  for (int d = cx.lane; d < nv; d += kLanes)
    G.qacc0[d] = minv_row<NBALL>(tb, G.Minv, bl, ns, G.rhs, d);
  gsync(cx);
  ANT_PHASE(kPhaseQacc0)
  // joint limits: the hinges, then the limited slides
  uint32_t lim_bits = 0u;
  for (int d = cx.lane; d < ns; d += kLanes) {
    if (d < 6) continue;
    float m_eff, lo, hi;
    if (d < kNa) {
      const float* dr = tb.dof + d * kDofCols;
      if (dr[2] == 0.f) continue;
      m_eff = 1.f / fmaxf(G.Minv[d][d], 1e-12f);
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
    G.fcon[d] = G.fcon[d] + limit_force(P, q[d + 1], v[d], G.qacc0[d], m_eff,
                                        lo, hi, &on);
    if (on) lim_bits |= 1u << d;
  }
  lim_bits = __reduce_or_sync(cx.mask, lim_bits);
  // the blocks' boxes
  for (int b = cx.lane; b < P.n_blk; b += kLanes) {
    const float* br = tb.blk + b * kBlkCols;
    for (int i = 0; i < 6; ++i) G.bc[b][i] = br[i];
    for (int j = 0; j < (int)br[7]; ++j) {
      const int d = (int)br[6] + j;
      const int ax = (int)tb.wdof[(d - kNa) * kWdofCols];
      G.bc[b][ax] = G.bc[b][ax] + q[d + 1];
    }
  }
  gsync(cx);
  ANT_PHASE(kPhaseLimits)
  *n_active += contact_force_group<W, NBLK, NBALL>(
      cx, tb, P, k, G.Minv, bl, v, G.qacc0, G.bc, G.fcon, G.x, G.y, region,
      trace);
  ANT_PHASE_RESTART
  // falling blocks: the coupled support, against the highest platform top
  // the block's center overlaps (else the floor, z = 0)
  if (cx.lane == 0) {
    uint32_t word = lim_bits;
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
        const bool over = fabsf(G.bc[b][0] - pl[0]) < pl[2] &&
                          fabsf(G.bc[b][1] - pl[1]) < pl[3];
        s = fmaxf(s, over ? pl[4] : 0.f);
      }
      const float w = tb.wdof[(zd - kNa) * kWdofCols + 6] + 1e-12f;
      int rows;
      G.fcon[zd] = G.fcon[zd] + falling_support(P, z, bottom, s, v[zd],
                                                G.qacc0[zd], w, &rows);
      word |= (uint32_t)rows << (24 + 2 * b);
    }
    if (trace) trace[kTraceWords - 1] = (int)word;
  }
  gsync(cx);
  ANT_PHASE(kPhaseSupport)
  for (int d = cx.lane; d < nv; d += kLanes)
    G.rhs[d] = G.tau[d] + G.fcon[d] - G.bias[d];
  gsync(cx);
  for (int d = cx.lane; d < nv; d += kLanes)
    qacc[d] = minv_row<NBALL>(tb, G.Minv, bl, ns, G.rhs, d);
  gsync(cx);
  ANT_PHASE(kPhaseQacc)
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
// slide dofs, then the ball's free joint (its qpos after theirs).  Lanes
// over dofs; a free joint's first angular dof's lane turns its quaternion.
template <int NBALL>
__device__ void integrate_group(const Ctx& cx, const float* q, const float* v,
                                float h, int ns, float* out) {
  const int nv = ns + 6 * NBALL;
  for (int d = cx.lane; d < nv; d += kLanes) {
    if (d < 3) {
      out[d] = q[d] + v[d] * h;
    } else if (d == 3) {
      quat_step(q + 3, v + 3, h, out + 3);
    } else if (d >= 6 && d < ns) {
      out[d + 1] = q[d + 1] + v[d] * h;
    } else if (d >= ns) {
      const int qa = ns + 1;
      if (d < ns + 3)
        out[qa + d - ns] = q[qa + d - ns] + v[d] * h;
      else if (d == ns + 3)
        quat_step(q + qa + 3, v + ns + 3, h, out + qa + 3);
    }
  }
}

// One RK4 step (engine.rk4_step: the four stages in order) of the state
// in G.q, G.v.
template <int W, int NBLK, int NBALL>
__device__ void rk4_group(const Ctx& cx, const Tables& tb, const AntParams& P,
                          Group<W, NBLK, NBALL>& G, float* region,
                          int* n_active, int* trace) {
  const int ns = kNa + P.n_w;
  const int nv = ns + 6 * NBALL, nq = nv + 1 + NBALL;
  for (int d = cx.lane; d < nv; d += kLanes) {
    G.prev_v[d] = G.v[d];
    G.prev_a[d] = 0.f;
    G.acc_v[d] = 0.f;
    G.acc_a[d] = 0.f;
  }
  gsync(cx);
#pragma unroll 1
  for (int st = 0; st < 4; ++st) {
    const float hs = st == 0 ? 0.f : (st == 3 ? P.h : P.h_half);
    const float w = (st == 0 || st == 3) ? 1.f : 2.f;
    integrate_group<NBALL>(cx, G.q, G.prev_v, hs, ns, G.qs);
    for (int d = cx.lane; d < nv; d += kLanes)
      G.vs[d] = G.v[d] + G.prev_a[d] * hs;
    gsync(cx);
    forward_group<W, NBLK, NBALL>(cx, tb, P, G, region, G.qs, G.vs, G.as,
                                  n_active,
                                  trace ? trace + st * kTraceWords : nullptr);
    for (int d = cx.lane; d < nv; d += kLanes) {
      G.prev_v[d] = G.vs[d];
      G.prev_a[d] = G.as[d];
      G.acc_v[d] = G.acc_v[d] + w * G.vs[d];
      G.acc_a[d] = G.acc_a[d] + w * G.as[d];
    }
    gsync(cx);
  }
  // the average velocity (in prev_v, free now), then the step
  for (int d = cx.lane; d < nv; d += kLanes) G.prev_v[d] = G.acc_v[d] / 6.f;
  gsync(cx);
  integrate_group<NBALL>(cx, G.q, G.prev_v, P.h, ns, G.qs);
  gsync(cx);
  for (int i = cx.lane; i < nq; i += kLanes) G.q[i] = G.qs[i];
  for (int d = cx.lane; d < nv; d += kLanes)
    G.v[d] = G.v[d] + (G.acc_a[d] / 6.f) * P.h;
  gsync(cx);
}

// One Ant env step of the state in G (G.ctrl the actions): frame_skip RK4
// steps, then the inner reward and the task heads on (x, y, z) of the
// torso, or of the first observed object where the task observes it first
// (obs_offset 3): the first block's center, or the ball's body origin.
// t + 1; no reset.  Every lane computes the heads, alike.
template <int W, int NBLK, int NBALL>
__device__ void ant_step_group(const Ctx& cx, const Tables& tb,
                               const AntParams& P, Group<W, NBLK, NBALL>& G,
                               float* region, int* t, float* reward,
                               bool* term, int* n_active, int* trace) {
  const float x0 = G.q[0], y0 = G.q[1];
#pragma unroll 1
  for (int fs = 0; fs < P.frame_skip; ++fs)
    rk4_group<W, NBLK, NBALL>(cx, tb, P, G, region, n_active,
                              trace ? trace + fs * 4 * kTraceWords : nullptr);
  const float* q = G.q;
  const float vx = (q[0] - x0) / P.dt_outer, vy = (q[1] - y0) / P.dt_outer;
  const float fwd = sqrtf(vx * vx + vy * vy);
  float csq = 0.f;
  for (int u = 0; u < kNu; ++u) csq = csq + G.ctrl[u] * G.ctrl[u];
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
  return Tables{smem,               smem + P.off_body,  smem + P.off_dof,
                smem + P.off_act,   smem + P.off_sph,   smem + P.off_box,
                smem + P.off_goal,  smem + P.off_qpos0, smem + P.off_wdof,
                smem + P.off_blk,   smem + P.off_plat,  smem + P.off_qpair,
                smem + P.off_ball,  smem + P.off_bpair};
}

// The group's state and contact region in the block's shared memory,
// after the staged tables.
template <int W, int NBLK, int NBALL>
__device__ Group<W, NBLK, NBALL>& group_state(float* smem, const AntParams& P,
                                              float** region) {
  float* g = smem + round4(P.n_floats) +
             (threadIdx.x / kLanes) * group_stride<W, NBLK, NBALL>(P);
  *region = g + round4(group_floats<W, NBLK, NBALL>());
  return *reinterpret_cast<Group<W, NBLK, NBALL>*>(g);
}

template <int W, int NBLK, int NBALL>
__global__ void __launch_bounds__(kMaxThreads) ant_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    int* __restrict__ active_out, int* __restrict__ trace_out,
    const float* __restrict__ tables, AntParams P, int n) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, tables, P);
  const int i = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  if (i >= n) return;  // the whole group: i is the group's env
  const Ctx cx = make_ctx(tb);
  float* region;
  Group<W, NBLK, NBALL>& G = group_state<W, NBLK, NBALL>(smem, P, &region);
  const int nv = kNa + P.n_w + 6 * NBALL, nq = nv + 1 + NBALL;
  for (int j = cx.lane; j < nq; j += kLanes)
    G.q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = cx.lane; j < nv; j += kLanes)
    G.v[j] = qvel[(size_t)i * v_stride + j];
  for (int j = cx.lane; j < kNu; j += kLanes)
    G.ctrl[j] = act[(size_t)i * a_stride + j];
  gsync(cx);
  int t = t_in[i], n_active = 0;
  float rew;
  bool done;
  int* trace = trace_out ? trace_out + (size_t)i * P.frame_skip * 4 *
                                           kTraceWords
                         : nullptr;
  ant_step_group<W, NBLK, NBALL>(cx, tb, P, G, region, &t, &rew, &done,
                                 &n_active, trace);
  for (int j = cx.lane; j < nq; j += kLanes)
    qpos_out[(size_t)i * nq + j] = G.q[j];
  for (int j = cx.lane; j < nv; j += kLanes)
    qvel_out[(size_t)i * nv + j] = G.v[j];
  if (cx.lane == 0) {
    t_out[i] = t;
    reward[i] = rew;
    term[i] = done;
    if (active_out) active_out[i] = n_active;
  }
}

template <int W, int NBLK, int NBALL>
__global__ void __launch_bounds__(kMaxThreads) ant_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, int* __restrict__ active_out,
    const float* __restrict__ tables, AntParams P, int n, int num_steps,
    uint32_t seed) {
  extern __shared__ float smem[];
  const Tables tb = stage_tables(smem, tables, P);
  const int i = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  if (i >= n) return;  // the whole group: i is the group's env
  const Ctx cx = make_ctx(tb);
  float* region;
  Group<W, NBLK, NBALL>& G = group_state<W, NBLK, NBALL>(smem, P, &region);
  const int nv = kNa + P.n_w + 6 * NBALL, nq = nv + 1 + NBALL;
  for (int j = cx.lane; j < nq; j += kLanes)
    G.q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = cx.lane; j < nv; j += kLanes)
    G.v[j] = qvel[(size_t)i * v_stride + j];
  int t = t_in[i], n_active = 0, eps = 0;
  float rew_sum = 0.f;
#pragma unroll 1
  for (int s = 0; s < num_steps; ++s) {
    // words 0-7 (blocks 0, 1): ctrl ~ U(+-30)
    if (cx.lane < 2) {
      const uint4 b = mmt::philox_block((uint32_t)i, (uint32_t)s,
                                        (uint32_t)cx.lane, seed);
      float* c = G.ctrl + 4 * cx.lane;
      c[0] = mmt::uniform24(b.x, -30.f, 30.f);
      c[1] = mmt::uniform24(b.y, -30.f, 30.f);
      c[2] = mmt::uniform24(b.z, -30.f, 30.f);
      c[3] = mmt::uniform24(b.w, -30.f, 30.f);
    }
    gsync(cx);
    float rew;
    bool term;
    ant_step_group<W, NBLK, NBALL>(cx, tb, P, G, region, &t, &rew, &term,
                                   &n_active, nullptr);
    rew_sum = rew_sum + rew;
    if (term || t >= P.episode_limit) {
      // words 8-51 (blocks 2-12): the ant's qpos0 + U(+-0.1) with the
      // quaternion renormalised, then its qvel = 0.1 N(0, 1) by
      // Box-Muller (lane_env.normal); the world dofs (slides, or the
      // ball's position and quaternion) go back to qpos0 at rest and draw
      // nothing
      uint32_t* w = G.words;
      for (int b = cx.lane; b < 11; b += kLanes) {
        const uint4 bb = mmt::philox_block((uint32_t)i, (uint32_t)s,
                                           (uint32_t)(2 + b), seed);
        w[4 * b] = bb.x; w[4 * b + 1] = bb.y;
        w[4 * b + 2] = bb.z; w[4 * b + 3] = bb.w;
      }
      gsync(cx);
      for (int j = cx.lane; j < kNa + 1; j += kLanes)
        G.q[j] = tb.qpos0[j] + mmt::uniform24(w[j], -0.1f, 0.1f);
      gsync(cx);
      if (cx.lane == 0) {
        float* q = G.q;
        const float qn = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] +
                               q[6] * q[6]);
        for (int j = 3; j < 7; ++j) q[j] = q[j] / qn;
      }
      for (int d = cx.lane; d < kNa; d += kLanes) {
        const float u1 = mmt::uniform24(w[15 + 2 * d], 1e-7f, 1.f);
        const float u2 = mmt::uniform24(w[16 + 2 * d], 0.f, 1.f);
        const float z = sqrtf(-2.f * logf(u1)) * cosf(6.2831854820251465f * u2);
        G.v[d] = z * 0.1f;
      }
      for (int j = kNa + 1 + cx.lane; j < nq; j += kLanes) G.q[j] = tb.qpos0[j];
      for (int d = kNa + cx.lane; d < nv; d += kLanes) G.v[d] = 0.f;
      t = 0;
      eps = eps + 1;
    }
    gsync(cx);
  }
  for (int j = cx.lane; j < nq; j += kLanes)
    qpos_out[(size_t)i * nq + j] = G.q[j];
  for (int j = cx.lane; j < nv; j += kLanes)
    qvel_out[(size_t)i * nv + j] = G.v[j];
  if (cx.lane == 0) {
    t_out[i] = t;
    reward_sum[i] = rew_sum;
    episodes[i] = eps;
    if (active_out) active_out[i] = n_active;
  }
}

}  // namespace

// Dynamic shared memory of one launch: the staged tables, then `groups`
// groups' state and contact regions.
template <int W, int NBLK, int NBALL = 0>
int ant_smem_bytes(const AntParams& p, int groups) {
  static_assert(sizeof(Group<W, NBLK, NBALL>) ==
                    sizeof(float) * group_floats<W, NBLK, NBALL>(),
                "Group holds only 4-byte members");
  return (int)sizeof(float) *
         (round4(p.n_floats) + groups * group_stride<W, NBLK, NBALL>(p));
}

// Launchers of one instantiation: each launches `groups` envs a block (one
// group of kLanes lanes each) on the given stream with `smem` bytes of
// dynamic shared memory (refused unless it is ant_smem_bytes) and returns
// cudaGetLastError().
template <int W, int NBLK, int NBALL, typename Kernel>
int prepare_ant_launch(Kernel kernel, const AntParams& p, int groups,
                       int smem) {
  if (groups < 1 || groups * kLanes > kMaxThreads ||
      smem != ant_smem_bytes<W, NBLK, NBALL>(p, groups))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)cudaSuccess;
}

template <int W, int NBLK, int NBALL = 0>
int launch_ant_step(const float* qpos, const float* qvel, const int* t,
                    const float* act, int q_stride, int v_stride,
                    int a_stride, float* qpos_out, float* qvel_out,
                    int* t_out, float* reward, bool* term, int* active_out,
                    int* trace_out, const float* tables, AntParams p, int n,
                    int groups, int smem, void* stream) {
  const int rc = prepare_ant_launch<W, NBLK, NBALL>(
      ant_step_kernel<W, NBLK, NBALL>, p, groups, smem);
  if (rc != (int)cudaSuccess) return rc;
  if (n > 0) {
    ant_step_kernel<W, NBLK, NBALL><<<(n + groups - 1) / groups,
                                      groups * kLanes, smem,
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
                       int groups, int smem, void* stream) {
  const int rc = prepare_ant_launch<W, NBLK, NBALL>(
      ant_rollout_kernel<W, NBLK, NBALL>, p, groups, smem);
  if (rc != (int)cudaSuccess) return rc;
  if (n > 0) {
    ant_rollout_kernel<W, NBLK, NBALL><<<(n + groups - 1) / groups,
                                         groups * kLanes, smem,
                                         (cudaStream_t)stream>>>(
        qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
        reward_sum, episodes, active_out, tables, p, n, num_steps, seed);
  }
  return (int)cudaGetLastError();
}

// Blocks of `groups` envs that an SM holds at once with `smem` bytes of
// dynamic shared memory (registers and shared memory both counted), for
// the step (rollout = 0) or the rollout kernel; -1 on an error.
template <int W, int NBLK, int NBALL = 0>
int ant_blocks_per_sm(int groups, int smem, int rollout) {
  int blocks = -1;
  cudaError_t e;
  if (rollout) {
    e = smem > 48 * 1024 ? cudaFuncSetAttribute(
                               ant_rollout_kernel<W, NBLK, NBALL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem)
                         : cudaSuccess;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ant_rollout_kernel<W, NBLK, NBALL>, groups * kLanes, smem);
  } else {
    e = smem > 48 * 1024 ? cudaFuncSetAttribute(
                               ant_step_kernel<W, NBLK, NBALL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem)
                         : cudaSuccess;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ant_step_kernel<W, NBLK, NBALL>, groups * kLanes, smem);
  }
  return e == cudaSuccess ? blocks : -1;
}

// The block-world instantiation, compiled in ant_blocks.cu.
constexpr int kBlockWorldDofs = 6;
constexpr int kBlockWorldBlocks = 3;
int launch_ant_blocks_step(const float* qpos, const float* qvel, const int* t,
                           const float* act, int q_stride, int v_stride,
                           int a_stride, float* qpos_out, float* qvel_out,
                           int* t_out, float* reward, bool* term,
                           int* active_out, int* trace_out,
                           const float* tables, AntParams p, int n,
                           int groups, int smem, void* stream);
int launch_ant_blocks_rollout(const float* qpos, const float* qvel,
                              const int* t, int q_stride, int v_stride,
                              float* qpos_out, float* qvel_out, int* t_out,
                              float* reward_sum, int* episodes,
                              int* active_out, const float* tables,
                              AntParams p, int n, int num_steps,
                              unsigned int seed, int groups, int smem,
                              void* stream);
int ant_blocks_blocks_per_sm(int groups, int smem, int rollout);

// The ball-world instantiation (one free object ball, no blocks or
// slides), compiled in ant_balls.cu.
constexpr int kBallWorldBalls = 1;
int launch_ant_balls_step(const float* qpos, const float* qvel, const int* t,
                          const float* act, int q_stride, int v_stride,
                          int a_stride, float* qpos_out, float* qvel_out,
                          int* t_out, float* reward, bool* term,
                          int* active_out, int* trace_out,
                          const float* tables, AntParams p, int n, int groups,
                          int smem, void* stream);
int launch_ant_balls_rollout(const float* qpos, const float* qvel,
                             const int* t, int q_stride, int v_stride,
                             float* qpos_out, float* qvel_out, int* t_out,
                             float* reward_sum, int* episodes,
                             int* active_out, const float* tables,
                             AntParams p, int n, int num_steps,
                             unsigned int seed, int groups, int smem,
                             void* stream);
int ant_balls_blocks_per_sm(int groups, int smem, int rollout);
