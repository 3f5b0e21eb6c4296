// The generic engine step kernel (custom robots through the extension
// API) and its C entry point: engine_lane.cuh holds the per-env device
// code and says what it computes and what bounds it.

#include <cuda_runtime.h>

#include "engine_lane.cuh"

namespace {

__global__ void engine_step_kernel(
    const float* __restrict__ qpos, const float* __restrict__ qvel,
    const int* __restrict__ t_in, const float* __restrict__ act, int q_stride,
    int v_stride, int a_stride, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, int* __restrict__ t_out,
    float* __restrict__ reward, bool* __restrict__ term,
    int* __restrict__ active_out, int* __restrict__ trace_out,
    float* __restrict__ scratch, const float* __restrict__ tables,
    EngineParams P, int n) {
  using namespace mmt_eng;
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < P.n_floats; i += blockDim.x)
    smem[i] = tables[i];
  __syncthreads();
  const Tables tb = tables_at(smem, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float q[kMaxNq], v[kMaxNv], ctrl[kMaxNu];
  for (int j = 0; j < P.nq; ++j) q[j] = qpos[(size_t)i * q_stride + j];
  for (int j = 0; j < P.nv; ++j) v[j] = qvel[(size_t)i * v_stride + j];
  for (int j = 0; j < P.nu; ++j) ctrl[j] = act[(size_t)i * a_stride + j];
  int t = t_in[i], n_active = 0;
  float rew;
  bool done;
  int* trace = trace_out ? trace_out + (size_t)i * P.frame_skip * 4 *
                                           P.trace_words
                         : nullptr;
  const Scratch S{scratch, (int64_t)n, i, P.row_floats};
  engine_step(tb, P, q, v, &t, ctrl, &rew, &done, S, &n_active, trace);
  for (int j = 0; j < P.nq; ++j) qpos_out[(size_t)i * P.nq + j] = q[j];
  for (int j = 0; j < P.nv; ++j) qvel_out[(size_t)i * P.nv + j] = v[j];
  t_out[i] = t;
  reward[i] = rew;
  term[i] = done;
  if (active_out) active_out[i] = n_active;
}

}  // namespace

// C entry point: launches on the given stream with `block` threads per
// block and returns cudaGetLastError(), which the Python wrapper checks.
// scratch holds max(n_cand, 1) x row_floats floats per env; active_out and
// trace_out may be null.
extern "C" int mmt_engine_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term, int* active_out,
    int* trace_out, float* scratch, const float* tables, EngineParams p,
    int n, int block, void* stream) {
  if (n > 0) {
    engine_step_kernel<<<(n + block - 1) / block, block,
                         sizeof(float) * (size_t)p.n_floats,
                         (cudaStream_t)stream>>>(
        qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
        t_out, reward, term, active_out, trace_out, scratch, tables, p, n);
  }
  return (int)cudaGetLastError();
}

// The compile-time caps the wrapper checks a spec against: bodies, dofs,
// coordinates, actuators, table floats.
extern "C" void mmt_engine_caps(int* out) {
  out[0] = mmt_eng::kMaxBodies;
  out[1] = mmt_eng::kMaxNv;
  out[2] = mmt_eng::kMaxNq;
  out[3] = mmt_eng::kMaxNu;
  out[4] = mmt_eng::kMaxTableFloats;
}
