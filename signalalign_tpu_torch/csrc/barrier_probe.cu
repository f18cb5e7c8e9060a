// Latency of the synchronisation one diagonal costs in the sweep kernels
// of banded_fb.cu: a block-wide max reduction (warp shuffles, partials in
// shared memory, one barrier) followed by a second barrier, repeated
// `iters` times, each step depending on the last. It ports no TPU kernel:
// chip_smoke.py times it to give the sweeps' serial-diagonal floor (a
// problem's n_diag times this latency), which neither bytes nor
// arithmetic bound.

#include <cuda_runtime.h>

namespace {

__global__ void barrier_probe_kernel(int iters, float* out) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float v = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) part[warp] = v;
    __syncthreads();
    float r = part[0];
    for (int w = 1; w < nw; ++w) r = fmaxf(r, part[w]);
    v = r - (float)threadIdx.x;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace

// `blocks` blocks of `threads` threads (a multiple of 32, at most 1024)
// on `stream`; out holds one float per block. Returns cudaGetLastError().
extern "C" int sa_barrier_probe(int blocks, int threads, int iters,
                                float* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  barrier_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(iters,
                                                                     out);
  return (int)cudaGetLastError();
}
