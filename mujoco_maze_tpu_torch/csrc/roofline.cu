// The card's measured fp32 ceiling: independent FMA chains in registers.
//
// Replaces the TPU kernel of the JAX package:
//   fma_peak <- mujoco_maze_tpu/utils/roofline.py vpu_peak_flops / _peak_kernel
//               (an unrolled x = a*x + b chain over a block resident in VMEM)
//
// Each thread carries kChains independent chains x = fma(x, a, b) in
// registers for `iters` steps: element c * n_threads + t of the input is
// chain c of thread t, read once before the loop and written once after
// it, so the timed loop touches no memory.  With `iters` in the thousands
// the loads and stores are a rounding error of the time and the kernel is
// bound by the fp32 pipes alone: its FLOP/s (2 per FMA) is the ceiling the
// port's fp32 bounds are read against, beside the data sheet's 67e12.
//
// Arithmetic.  The library is built with -fmad=false, which would split an
// a * x + b written out into a multiply and an add (two instructions, half
// the rate), so the chain calls __fmaf_rn explicitly.  The plain version
// (utils/roofline.py fma_chain_plain) rounds the product and the sum
// separately: the two agree to a relative 1e-5 over a short chain, not to
// the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kBlock = 256;

__global__ void fma_peak_kernel(const float* __restrict__ x0,
                                float* __restrict__ out, int n, int iters,
                                float a, float b) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const long idx = (long)c * nt + t;
    x[c] = idx < n ? x0[idx] : 0.f;
  }
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = __fmaf_rn(x[c], a, b);
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const long idx = (long)c * nt + t;
    if (idx < n) out[idx] = x[c];
  }
}

}  // namespace

// Launches on the given stream and returns cudaGetLastError(), which the
// Python wrapper checks.
extern "C" int mmt_fma_peak(const float* x0, float* out, int n, int iters,
                            float a, float b, void* stream) {
  if (n > 0) {
    const int threads = (n + kChains - 1) / kChains;
    fma_peak_kernel<<<(threads + kBlock - 1) / kBlock, kBlock, 0,
                      (cudaStream_t)stream>>>(x0, out, n, iters, a, b);
  }
  return (int)cudaGetLastError();
}
