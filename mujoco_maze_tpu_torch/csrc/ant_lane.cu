// The Ant kernels for the object-free mazes (no world dofs), and the C
// entry points of both Ant instantiations: ant_lane.cuh holds the kernels
// and says what they compute; ant_blocks.cu instantiates the block worlds.

#include "ant_lane.cuh"

// C entry points: each launches on the given stream with `block` threads
// per block and returns cudaGetLastError(), which the Python wrapper
// checks.  active_out and trace_out may be null.  A world with world dofs
// (p.n_w > 0) goes to the block-world instantiation.
extern "C" int mmt_ant_step(
    const float* qpos, const float* qvel, const int* t, const float* act,
    int q_stride, int v_stride, int a_stride, float* qpos_out,
    float* qvel_out, int* t_out, float* reward, bool* term, int* active_out,
    int* trace_out, const float* tables, AntParams p, int n, int block,
    void* stream) {
  if (p.n_w > 0)
    return launch_ant_blocks_step(qpos, qvel, t, act, q_stride, v_stride,
                                  a_stride, qpos_out, qvel_out, t_out, reward,
                                  term, active_out, trace_out, tables, p, n,
                                  block, stream);
  return launch_ant_step<0, 0>(qpos, qvel, t, act, q_stride, v_stride,
                               a_stride, qpos_out, qvel_out, t_out, reward,
                               term, active_out, trace_out, tables, p, n,
                               block, stream);
}

extern "C" int mmt_ant_rollout(
    const float* qpos, const float* qvel, const int* t, int q_stride,
    int v_stride, float* qpos_out, float* qvel_out, int* t_out,
    float* reward_sum, int* episodes, int* active_out, const float* tables,
    AntParams p, int n, int num_steps, unsigned int seed, int block,
    void* stream) {
  if (p.n_w > 0)
    return launch_ant_blocks_rollout(qpos, qvel, t, q_stride, v_stride,
                                     qpos_out, qvel_out, t_out, reward_sum,
                                     episodes, active_out, tables, p, n,
                                     num_steps, seed, block, stream);
  return launch_ant_rollout<0, 0>(qpos, qvel, t, q_stride, v_stride, qpos_out,
                                  qvel_out, t_out, reward_sum, episodes,
                                  active_out, tables, p, n, num_steps, seed,
                                  block, stream);
}

// The world's compile-time bounds the wrappers check a spec against.
extern "C" int mmt_ant_max_world_dofs() { return kBlockWorldDofs; }
extern "C" int mmt_ant_max_blocks() { return kBlockWorldBlocks; }
