// Philox4x32-10 and 24-bit uniforms: the random stream of the rollout
// kernels (point_lane.cu, ant_lane.cu).
//
// Counter (env, step, block, 0), key (seed, 0): every env and step draws
// its own blocks of four 32-bit words, so a rollout's draws do not depend
// on the launch shape.  ops/point_kernel.py philox4x32 computes the same
// words in int64 torch arithmetic for the plain versions.

#pragma once

#include <stdint.h>

namespace mmt {

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The block-th four words of (env, step) under seed.
__device__ __forceinline__ uint4 philox_block(uint32_t env, uint32_t step,
                                              uint32_t block, uint32_t seed) {
  return philox4x32_10(make_uint4(env, step, block, 0u), make_uint2(seed, 0u));
}

// U(lo, hi) from the top 24 bits, as lane_env.uniform (lane_env.py:40):
// lo + u * (hi - lo), with hi - lo rounded to float32 first.
__device__ __forceinline__ float uniform24(uint32_t bits, float lo, float hi) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
  return lo + u * (hi - lo);
}

}  // namespace mmt
