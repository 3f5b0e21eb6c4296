// The generic engine step kernel (custom robots through the extension
// API): the smallest size class's instantiations and the C entry points.
// engine_lane.cuh holds the device code and says what it computes and what
// bounds it; engine_mid.cu and engine_large.cu instantiate the other two
// classes.

#include "engine_lane.cuh"

// The smallest class (kSmallNv dofs, kSmallNb bodies): 8 lanes an env.
ENGINE_CLASS_DISPATCH(engine_small_step, mmt_eng::kSmallNv, mmt_eng::kSmallNb,
                      8)

namespace {

// The launch (or the occupancy query) of size class cls (0 small, 1 mid,
// 2 large), each at its own lanes an env.
int engine_dispatch(const float* qpos, const float* qvel, const int* t,
                    const float* act, int q_stride, int v_stride,
                    int a_stride, float* qpos_out, float* qvel_out,
                    int* t_out, float* reward, bool* term, int* active_out,
                    int* trace_out, const float* tables, EngineParams p,
                    int n, int cls, int groups, int smem, void* stream,
                    int* groups_per_sm) {
  auto* fn = cls == 0 ? engine_small_step
             : cls == 1 ? engine_mid_step
             : cls == 2 ? engine_large_step
                        : nullptr;
  if (!fn) return (int)cudaErrorInvalidValue;
  return fn(qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out,
            qvel_out, t_out, reward, term, active_out, trace_out, tables, p,
            n, groups, smem, stream, groups_per_sm);
}

}  // namespace

// C entry point: launches size class cls with `groups` envs a block on the
// given stream, with `smem` bytes of dynamic shared memory
// (ops/lane_env.py engine_geometry; any other byte count or a model past
// the class's bounds is refused with cudaErrorInvalidValue), and returns
// cudaGetLastError(), which the Python wrapper checks.  active_out and
// trace_out may be null.
extern "C" int mmt_engine_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term, int* active_out,
    int* trace_out, const float* tables, EngineParams p, int n, int cls,
    int groups, int smem, void* stream) {
  return engine_dispatch(qpos, qvel, t, act, q_stride, v_stride, a_stride,
                         qpos_out, qvel_out, t_out, reward, term, active_out,
                         trace_out, tables, p, n, cls, groups, smem, stream,
                         nullptr);
}

// Envs an SM holds at once for class cls at `groups` envs a block with
// `smem` bytes (registers and shared memory counted, CUDA's occupancy
// calculator); -1 on an error.
extern "C" int mmt_engine_groups_per_sm(EngineParams p, int cls, int groups,
                                        int smem) {
  int blocks = -1;
  const int rc = engine_dispatch(nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
                                 nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, p, 0, cls, groups,
                                 smem, nullptr, &blocks);
  return rc == 0 && blocks >= 0 ? blocks * groups : -1;
}

// The phase counters of a profiling build (-DMMT_ENGINE_PHASES), or nothing.
ENGINE_PHASES_READER(mmt_engine_small_phases)
