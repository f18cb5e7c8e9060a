// Latency of the synchronisation one diagonal costs in the sweep kernels
// of banded_fb.cu, repeated `iters` times, each step depending on the
// last. Two steps:
// - two barriers (`one_barrier` 0, the P > 2 instances): a block-wide max
//   reduction (warp shuffles, partials in shared memory, one barrier)
//   followed by a second barrier;
// - one barrier (`one_barrier` 1, the per-pair instances, and the floor
//   of banded_fb_prob.cu's, which reduce the partials with shuffles
//   instead): the warp shuffles, partials double-buffered by step parity,
//   one barrier, and every thread's max over the partials; a block of one
//   warp uses __syncwarp and the shuffles alone.
// It ports no TPU kernel: chip_smoke.py times it to give the sweeps'
// serial-diagonal floor (a problem's n_diag times this latency at the
// block's warp count), which neither bytes nor arithmetic bound.

#include <cuda_runtime.h>

namespace {

__global__ void barrier_probe_kernel(int iters, int one_barrier, float* out) {
  __shared__ float part[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float v = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    float r;
    if (one_barrier) {
      if (nw == 1) {
        __syncwarp();
        r = v;
      } else {
        if (lane == 0) part[i & 1][warp] = v;
        __syncthreads();
        r = part[i & 1][0];
        for (int w = 1; w < nw; ++w) r = fmaxf(r, part[i & 1][w]);
      }
    } else {
      if (lane == 0) part[0][warp] = v;
      __syncthreads();
      r = part[0][0];
      for (int w = 1; w < nw; ++w) r = fmaxf(r, part[0][w]);
      __syncthreads();
    }
    v = r - (float)threadIdx.x;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace

// `blocks` blocks of `threads` threads (a multiple of 32, at most 1024)
// on `stream`, the one- or two-barrier step; out holds one float per
// block. Returns cudaGetLastError().
extern "C" int sa_barrier_probe(int blocks, int threads, int iters,
                                int one_barrier, float* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  barrier_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      iters, one_barrier, out);
  return (int)cudaGetLastError();
}
