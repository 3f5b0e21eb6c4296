// Swimmer and Reacher mazes: the step and rollout kernels.
//
// Replaces the TPU kernels of the JAX package:
//   swimmer_step    <- mujoco_maze_tpu/ops/swimmer_pallas.py build_step_kernel
//                      (_make_kernel.env_step, swimmer_math.rk4_step_swimmer,
//                      forward_swimmer, lane_env.goal_heads)
//   swimmer_rollout <- mujoco_maze_tpu/ops/swimmer_pallas.py build_rollout_kernel
//                      (sample_ctrl / sample_reset, lane_env.uniform)
//
// What it computes.  One env step is frame_skip (4) RK4 steps of the
// closed-form planar chain — slide x, slide y, hinge θ and one hinge per
// further link, 3 links for the Swimmer and 2 for the Reacher — each RK4
// step four forward evaluations: the mass matrix, the velocity-product
// bias, MuJoCo's inertia-box fluid drag, gear actuators and the impedance
// joint limits, solved with one Cholesky factor.  Then the inner reward
// (planar speed minus control cost), the task heads on (x, y, θ) and t + 1.
// The swimmer never meets the walls (the reference model has no contact
// pairs), so there is no collision stage, and the world dofs of the block
// worlds (SwimmerPush, SwimmerFall, SwimmerMultiFall) pass through.
//
// Design.  One thread is one env; its state stays in registers for the
// whole step (or rollout).  The link count NL (2 or 3) is the one template
// argument, so the n x n matrices (n = NL + 2) are unrolled register
// arrays; the world dofs (0 to kMaxWorld, after the robot's n) are a
// runtime count: the step copies them through, the rollout only resets
// them.  The two instantiations of one build serve all 52 IDs.  The goals
// come in a runtime table (goals (G, 9), staged into shared memory, as in
// point_lane.cu) and the constants by value in SwimmerParams.  The kernels
// read and write the public (B, nq) row-major tensors in place, with the
// row strides passed in.
//
// What bounds them on an H100.  A step moves about 100 bytes per env
// (qpos, qvel, t, actions in; qpos, qvel, t, reward, terminated out):
// 0.4 MB at B = 4096, a tenth of a microsecond of HBM3 time, against the
// 16 x 481 fp32 operations per env that the closed form needs
// (swimmer_forward_flops in chip_smoke.py; this kernel does more, see
// "Arithmetic"), about half a microsecond at the fp32 peak if every lane
// were busy.  At B = 4096 one thread per env fills 32 blocks of 128
// threads, a quarter of the 132 SMs with four warps each, and a forward
// evaluation is a serial chain (the Cholesky factor, the solves), so the
// step kernel is bound by latency and the launch, not by either roof.  The
// rollout keeps the state in registers over all its steps; it is bound the
// same way.  This version is the simple one that is right.
//
// Arithmetic.  ops/swimmer_math.py (the plain version) and this file do
// the same float32 operations in the same order: sums of a few terms left
// to right, Jacobian entries that are constant 1 or 0 taking part in the
// products as there (x * 1, x * 0 and x + 0 are exact), divisions by
// constants as products with the float32 reciprocals passed in
// SwimmerParams (PyTorch's CUDA division by a Python scalar is such a
// product), right-looking triangular solves.  The library is built
// without fast-math flags and with -fmad=false, so no multiply-add is
// contracted, and sinf, cosf and sqrtf are the precise ones that PyTorch's
// CUDA kernels call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

struct SwimmerParams {
  float mass, iz, armature, gear;
  float kv_f, kv_t, kq_fx, kq_fy, kq_t;           // fluid drag
  float lim_lo, lim_hi, lim_b, lim_d0, lim_dd;    // joint limits
  float lim_inv_width, lim_inv_kden;
  float h, h_half, inv6;                          // RK4
  float inv_dt, ctrl_weight, inner_scale;         // inner reward
  float penalty, inv_scale;                       // task heads
  int frame_skip, reward_type, episode_limit;     // reward_type: 0 none,
                                                  // 1 dist, 2 goal
};

namespace {

constexpr int kBlock = 128;
constexpr int kGoalCols = 9;  // pos(3) dim_mask(3) threshold^2 reward_scale valid
constexpr int kMaxWorld = 2;  // world dofs: one block on two slides at most

// Link geometry (swimmer_math.COM, ATTACH): each link's CoM and the next
// link's attachment along the link's own x axis.
__device__ __forceinline__ float com_len(int k) { return k == 0 ? 1.f : -0.5f; }
__device__ __forceinline__ float att_len(int k) { return k == 0 ? 0.5f : -1.f; }

// Whether generalized coordinate i turns link k (θ .. φ_{k+1}).
__device__ __forceinline__ bool turns(int k, int i) { return i >= 2 && i <= 2 + k; }

// qacc of the NL-link chain (swimmer_math.forward_swimmer).
template <int NL>
__device__ void forward(const SwimmerParams& P, const float* q, const float* v,
                        const float* ctrl, float* qacc) {
  constexpr int N = NL + 2, NU = NL - 1;
  float c[NL], s[NL], comx[NL], comy[NL], attx[NL], atty[NL];
  {
    float a = q[2];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      if (k) a = a + q[2 + k];
      c[k] = cosf(a);
      s[k] = sinf(a);
      comx[k] = com_len(k) * c[k];
      comy[k] = com_len(k) * s[k];
      attx[k] = att_len(k) * c[k];
      atty[k] = att_len(k) * s[k];
    }
  }
  // CoM Jacobians: columns x, y, then the perp of the lever from joint i
  // to the CoM of link k, att[i] + ... + att[k-1] + com[k]
  float jx[NL][N], jy[NL][N];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    jx[k][0] = 1.f; jy[k][0] = 0.f;
    jx[k][1] = 0.f; jy[k][1] = 1.f;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (i > k) {
        jx[k][2 + i] = 0.f; jy[k][2 + i] = 0.f;
        continue;
      }
      float px = 0.f, py = 0.f;
#pragma unroll
      for (int m = i; m < k; ++m) {
        px = m == i ? attx[m] : px + attx[m];
        py = m == i ? atty[m] : py + atty[m];
      }
      px = i == k ? comx[k] : px + comx[k];
      py = i == k ? comy[k] : py + comy[k];
      jx[k][2 + i] = -py;
      jy[k][2 + i] = px;
    }
  }

  // mass matrix
  float M[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) M[i][j] = 0.f;
#pragma unroll
  for (int k = 0; k < NL; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dot = jx[k][i] * jx[k][j] + jy[k][i] * jy[k][j];
        const float term = P.mass * dot + (turns(k, i) && turns(k, j) ? P.iz : 0.f);
        M[i][j] = M[i][j] + term;
      }
#pragma unroll
  for (int i = 0; i < N; ++i) M[i][i] = M[i][i] + P.armature;

  // angular velocities, velocity-product CoM accelerations, bias
  float w[NL], nw2[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    w[k] = k ? w[k - 1] + v[2 + k] : v[2];
    nw2[k] = (-w[k]) * w[k];
  }
  float bias[N], tau[N];
#pragma unroll
  for (int j = 0; j < N; ++j) { bias[j] = 0.f; tau[j] = 0.f; }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int m = 0; m < k; ++m) {
      const float tx = nw2[m] * attx[m], ty = nw2[m] * atty[m];
      ax = m ? ax + tx : tx;
      ay = m ? ay + ty : ty;
    }
    const float tx = nw2[k] * comx[k], ty = nw2[k] * comy[k];
    ax = k ? ax + tx : tx;
    ay = k ? ay + ty : ty;
#pragma unroll
    for (int j = 0; j < N; ++j)
      bias[j] = bias[j] + P.mass * (jx[k][j] * ax + jy[k][j] * ay);
  }

  // fluid drag on each link's inertia box, in the link frame at its CoM
  float fwx[NL], fwy[NL], tz[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    float vwx = jx[k][0] * v[0], vwy = jy[k][0] * v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) {
      vwx = vwx + jx[k][i] * v[i];
      vwy = vwy + jy[k][i] * v[i];
    }
    const float vbx = c[k] * vwx + s[k] * vwy;
    const float vby = (-s[k]) * vwx + c[k] * vwy;
    float fbx = P.kv_f * vbx, fby = P.kv_f * vby, t = P.kv_t * w[k];
    fbx = fbx - (P.kq_fx * fabsf(vbx)) * vbx;
    fby = fby - (P.kq_fy * fabsf(vby)) * vby;
    t = t - (P.kq_t * fabsf(w[k])) * w[k];
    fwx[k] = c[k] * fbx - s[k] * fby;
    fwy[k] = s[k] * fbx + c[k] * fby;
    tz[k] = t;
  }
#pragma unroll
  for (int k = 0; k < NL; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      tau[j] = (tau[j] + jx[k][j] * fwx[k]) + jy[k][j] * fwy[k];
      if (turns(k, j)) tau[j] = tau[j] + tz[k];
    }
  // gear actuators on φ2[, φ3]
#pragma unroll
  for (int a = 0; a < NU; ++a)
    tau[3 + a] = tau[3 + a] + P.gear * fminf(fmaxf(ctrl[a], -1.f), 1.f);

  // Cholesky factor (lower), column by column
  float L[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float sc[N];
#pragma unroll
    for (int i = j; i < N; ++i) {
      sc[i] = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) sc[i] = sc[i] - L[i][k] * L[j][k];
    }
    const float d = sqrtf(fmaxf(sc[j], 1e-12f));
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) L[i][j] = sc[i] / d;
  }

  // L L^T x = b, right-looking forward and backward substitution
  auto solve = [&](float* b, float* x) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      b[k] = b[k] / L[k][k];
#pragma unroll
      for (int i = k + 1; i < N; ++i) b[i] = b[i] - L[i][k] * b[k];
    }
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      x[k] = b[k] / L[k][k];
#pragma unroll
      for (int i = 0; i < k; ++i) b[i] = b[i] - L[k][i] * x[k];
    }
  };
  float rhs[N], qacc0[N];
#pragma unroll
  for (int j = 0; j < N; ++j) rhs[j] = tau[j] - bias[j];
  solve(rhs, qacc0);

  // joint limits of φ2[, φ3]: impedance on the unconstrained acceleration,
  // with diag(M^-1) = |L^-1 e_d|^2 from the factor
  float flim[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    const int dof = 3 + a;
    float y[N];
    y[dof] = 1.f / L[dof][dof];
#pragma unroll
    for (int i = dof + 1; i < N; ++i) {
      float sm = L[i][dof] * y[dof];
#pragma unroll
      for (int k = dof + 1; k < i; ++k) sm = sm + L[i][k] * y[k];
      y[i] = (-sm) / L[i][i];
    }
    float minv = y[dof] * y[dof];
#pragma unroll
    for (int i = dof + 1; i < N; ++i) minv = minv + y[i] * y[i];
    const float m_eff = 1.f / fmaxf(minv, 1e-12f);
    const float qq = q[dof], qv = v[dof], a0 = qacc0[dof];
    float f = 0.f;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float sgn = side ? -1.f : 1.f;
      const float viol = side ? fmaxf(P.lim_lo - qq, 0.f) : fmaxf(qq - P.lim_hi, 0.f);
      const float d = P.lim_d0 + P.lim_dd * fminf(fmaxf(viol * P.lim_inv_width, 0.f), 1.f);
      const float k_imp = d * P.lim_inv_kden;
      const float aref = (-P.lim_b) * (sgn * qv) - k_imp * viol;
      const float f_out = fminf((m_eff * d) * (aref - sgn * a0), 0.f);
      f = f + (viol > 0.f ? sgn * f_out : 0.f);
    }
    flim[a] = f;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    rhs[j] = (tau[j] + (j >= 3 ? flim[j - 3] : 0.f)) - bias[j];
  solve(rhs, qacc);
}

// One RK4 step of the robot coordinates (swimmer_math.rk4_step_swimmer).
template <int NL>
__device__ void rk4_step(const SwimmerParams& P, float* q, float* v,
                         const float* ctrl) {
  constexpr int N = NL + 2;
  float a1[N], a2[N], a3[N], a4[N], qs[N], v2[N], v3[N], v4[N];
  forward<NL>(P, q, v, ctrl, a1);
#pragma unroll
  for (int i = 0; i < N; ++i) { qs[i] = q[i] + P.h_half * v[i]; v2[i] = v[i] + P.h_half * a1[i]; }
  forward<NL>(P, qs, v2, ctrl, a2);
#pragma unroll
  for (int i = 0; i < N; ++i) { qs[i] = q[i] + P.h_half * v2[i]; v3[i] = v[i] + P.h_half * a2[i]; }
  forward<NL>(P, qs, v3, ctrl, a3);
#pragma unroll
  for (int i = 0; i < N; ++i) { qs[i] = q[i] + P.h * v3[i]; v4[i] = v[i] + P.h * a3[i]; }
  forward<NL>(P, qs, v4, ctrl, a4);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float v_avg = (((v[i] + 2.f * v2[i]) + 2.f * v3[i]) + v4[i]) * P.inv6;
    const float a_avg = (((a1[i] + 2.f * a2[i]) + 2.f * a3[i]) + a4[i]) * P.inv6;
    q[i] = q[i] + P.h * v_avg;
    v[i] = v[i] + P.h * a_avg;
  }
}

// One env step (MazeEnvSpec.step through _step_dynamic): frame_skip RK4
// steps of the robot dofs (the world dofs after them are left alone), the
// inner reward, t + 1, the task heads on obs[:3] = (x, y, θ).  No reset.
template <int NL>
__device__ void env_step(const SwimmerParams& P, const float* goals,
                         int n_goals, float* q, float* v, int* t,
                         const float* ctrl, float* reward, bool* term) {
  constexpr int NU = NL - 1;
  const float x0 = q[0], y0 = q[1];
  for (int f = 0; f < P.frame_skip; ++f) rk4_step<NL>(P, q, v, ctrl);
  const float vx = (q[0] - x0) * P.inv_dt, vy = (q[1] - y0) * P.inv_dt;
  const float fwd = sqrtf(vx * vx + vy * vy);
  float csq = ctrl[0] * ctrl[0];
#pragma unroll
  for (int a = 1; a < NU; ++a) csq = csq + ctrl[a] * ctrl[a];
  const float inner = fwd - P.ctrl_weight * csq;
  *t = *t + 1;

  // heads (tasks/core.py, lane_env.goal_heads): first hit wins; the third
  // component is θ, which meets a 3-D goal's z in the Fall worlds, as in
  // the reference
  float rew = P.reward_type == 2 ? P.penalty : 0.f;
  bool hit_any = false;
  for (int gi = n_goals - 1; gi >= 0; --gi) {
    const float* gr = goals + gi * kGoalCols;
    const float ddx = (q[0] - gr[0]) * gr[3];
    const float ddy = (q[1] - gr[1]) * gr[4];
    const float ddz = (q[2] - gr[2]) * gr[5];
    const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
    if (gi == 0 && P.reward_type == 1) rew = -(sqrtf(d2) * P.inv_scale);
    const bool near = gr[8] != 0.f && d2 <= gr[6];
    hit_any = hit_any || near;
    if (near && P.reward_type == 2) rew = gr[7];
  }
  *reward = P.inner_scale * inner + rew;
  *term = hit_any;
}

__device__ const float* stage_goals(float* smem, const float* goals,
                                    int n_goals) {
  for (int i = threadIdx.x; i < n_goals * kGoalCols; i += blockDim.x)
    smem[i] = goals[i];
  __syncthreads();
  return smem;
}

template <int NL>
__global__ void swimmer_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    const float* __restrict__ goals_g, int n_goals, SwimmerParams p,
    int n_world, int n) {
  constexpr int NR = NL + 2, NU = NL - 1;
  const int nq = NR + n_world;
  extern __shared__ float smem[];
  const float* goals = stage_goals(smem, goals_g, n_goals);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* qi = qpos + (size_t)i * q_stride;
  const float* vi = qvel + (size_t)i * v_stride;
  float* qo = qpos_out + (size_t)i * nq;
  float* vo = qvel_out + (size_t)i * nq;
  float q[NR], v[NR], ctrl[NU];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    q[k] = qi[k];
    v[k] = vi[k];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) ctrl[a] = act[(size_t)i * a_stride + a];
  int t = t_in[i];
  float rew;
  bool done;
  env_step<NL>(p, goals, n_goals, q, v, &t, ctrl, &rew, &done);
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    qo[k] = q[k];
    vo[k] = v[k];
  }
  // the world dofs pass through
  for (int k = NR; k < nq; ++k) {
    qo[k] = qi[k];
    vo[k] = vi[k];
  }
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
}

template <int NL>
__global__ void swimmer_rollout_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, int q_stride, int v_stride,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    int* __restrict__ t_out, float* __restrict__ reward_sum,
    int* __restrict__ episodes, const float* __restrict__ goals_g,
    int n_goals, SwimmerParams p, int n_world, int n, int num_steps,
    uint32_t seed) {
  constexpr int NR = NL + 2, NU = NL - 1, kMaxQ = NR + kMaxWorld;
  // words per step: 2 actions, then nq qpos and nq qvel reset values
  constexpr int kMaxBlocks = (2 + 2 * kMaxQ + 3) / 4;
  const int nq = NR + n_world, n_blocks = (2 + 2 * nq + 3) / 4;
  extern __shared__ float smem[];
  const float* goals = stage_goals(smem, goals_g, n_goals);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // q[k], v[k] for k >= nq stay 0 and are never stored
  float q[kMaxQ], v[kMaxQ];
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) {
    q[k] = k < nq ? qpos[(size_t)i * q_stride + k] : 0.f;
    v[k] = k < nq ? qvel[(size_t)i * v_stride + k] : 0.f;
  }
  int t = t_in[i];
  float rew_sum = 0.f;
  int eps = 0;
  for (int st = 0; st < num_steps; ++st) {
    uint32_t words[4 * kMaxBlocks];
#pragma unroll
    for (int b = 0; b < kMaxBlocks; ++b) {
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (b < n_blocks)
        r = mmt::philox_block((uint32_t)i, (uint32_t)st, (uint32_t)b, seed);
      words[4 * b] = r.x; words[4 * b + 1] = r.y;
      words[4 * b + 2] = r.z; words[4 * b + 3] = r.w;
    }
    float ctrl[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) ctrl[a] = mmt::uniform24(words[a], -1.f, 1.f);
    float rew;
    bool term;
    env_step<NL>(p, goals, n_goals, q, v, &t, ctrl, &rew, &term);
    // branch-free auto-reset: the swimmer's law, U(+-0.1) on the full
    // state, world dofs included; t = 0.  The qvel draws start at word
    // 2 + nq: a select over the world-dof counts keeps every index a
    // constant (a register, not the stack).
    const bool done = term || t >= p.episode_limit;
#pragma unroll
    for (int k = 0; k < kMaxQ; ++k) {
      const uint32_t wv = n_world == 0   ? words[2 + NR + k]
                          : n_world == 1 ? words[3 + NR + k]
                                         : words[4 + NR + k];
      const float qr = mmt::uniform24(words[2 + k], -0.1f, 0.1f);
      const float vr = mmt::uniform24(wv, -0.1f, 0.1f);
      q[k] = done ? qr : q[k];
      v[k] = done ? vr : v[k];
    }
    t = done ? 0 : t;
    rew_sum = rew_sum + rew;
    eps = eps + (done ? 1 : 0);
  }
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) {
    if (k < nq) {
      qpos_out[(size_t)i * nq + k] = q[k];
      qvel_out[(size_t)i * nq + k] = v[k];
    }
  }
  t_out[i] = t;
  reward_sum[i] = rew_sum;
  episodes[i] = eps;
}

size_t goal_bytes(int n_goals) {
  return sizeof(float) * (size_t)(n_goals * kGoalCols);
}

int grid(int n) { return (n + kBlock - 1) / kBlock; }

template <int NL>
void launch_step(const float* qpos, const float* qvel, const int* t,
                 const float* act, int q_stride, int v_stride, int a_stride,
                 float* qpos_out, float* qvel_out, int* t_out, float* reward,
                 bool* term, const float* goals, int n_goals,
                 const SwimmerParams& p, int n_world, int n,
                 cudaStream_t stream) {
  swimmer_step_kernel<NL><<<grid(n), kBlock, goal_bytes(n_goals), stream>>>(
      qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
      t_out, reward, term, goals, n_goals, p, n_world, n);
}

template <int NL>
void launch_rollout(const float* qpos, const float* qvel, const int* t,
                    int q_stride, int v_stride, float* qpos_out,
                    float* qvel_out, int* t_out, float* reward_sum,
                    int* episodes, const float* goals, int n_goals,
                    const SwimmerParams& p, int n_world, int n, int num_steps,
                    uint32_t seed, cudaStream_t stream) {
  swimmer_rollout_kernel<NL><<<grid(n), kBlock, goal_bytes(n_goals), stream>>>(
      qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
      reward_sum, episodes, goals, n_goals, p, n_world, n, num_steps, seed);
}

}  // namespace

// C entry points: each launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape no instantiation
// serves), which the Python wrapper checks.
extern "C" int mmt_swimmer_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term,
    const float* goals, int n_goals, SwimmerParams p, int n_links,
    int n_world, int n, void* stream) {
  if (n_world < 0 || n_world > kMaxWorld || (n_links != 2 && n_links != 3))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    auto launch = n_links == 2 ? launch_step<2> : launch_step<3>;
    launch(qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out,
           qvel_out, t_out, reward, term, goals, n_goals, p, n_world, n,
           (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int mmt_swimmer_rollout(
    const float* qpos, const float* qvel, const int* t, int q_stride,
    int v_stride, float* qpos_out, float* qvel_out, int* t_out,
    float* reward_sum, int* episodes, const float* goals, int n_goals,
    SwimmerParams p, int n_links, int n_world, int n, int num_steps,
    unsigned int seed, void* stream) {
  if (n_world < 0 || n_world > kMaxWorld || (n_links != 2 && n_links != 3))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    auto launch = n_links == 2 ? launch_rollout<2> : launch_rollout<3>;
    launch(qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
           reward_sum, episodes, goals, n_goals, p, n_world, n, num_steps,
           seed, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
