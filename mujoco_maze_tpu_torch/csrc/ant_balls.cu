// The Ant kernels for the ball worlds: one free object ball, no blocks
// (AntSmallBilliard).  ant_lane.cuh holds the kernels and says what they
// compute; this file compiles the instantiation beside ant_lane.cu and
// ant_blocks.cu.

#include "ant_lane.cuh"

int launch_ant_balls_step(const float* qpos, const float* qvel, const int* t,
                          const float* act, int q_stride, int v_stride,
                          int a_stride, float* qpos_out, float* qvel_out,
                          int* t_out, float* reward, bool* term,
                          int* active_out, int* trace_out,
                          const float* tables, AntParams p, int n, int block,
                          void* stream) {
  return launch_ant_step<0, 0, kBallWorldBalls>(
      qpos, qvel, t, act, q_stride, v_stride, a_stride, qpos_out, qvel_out,
      t_out, reward, term, active_out, trace_out, tables, p, n, block, stream);
}

int launch_ant_balls_rollout(const float* qpos, const float* qvel,
                             const int* t, int q_stride, int v_stride,
                             float* qpos_out, float* qvel_out, int* t_out,
                             float* reward_sum, int* episodes,
                             int* active_out, const float* tables,
                             AntParams p, int n, int num_steps,
                             unsigned int seed, int block, void* stream) {
  return launch_ant_rollout<0, 0, kBallWorldBalls>(
      qpos, qvel, t, q_stride, v_stride, qpos_out, qvel_out, t_out,
      reward_sum, episodes, active_out, tables, p, n, num_steps, seed, block,
      stream);
}

// The ball world's compile-time bound the wrappers check a spec against.
extern "C" int mmt_ant_max_balls() { return kBallWorldBalls; }
