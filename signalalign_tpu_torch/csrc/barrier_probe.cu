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
//   warp uses __syncwarp and the shuffles alone;
// - a cluster's diagonal (sa_barrier_probe_cluster, the cluster instance
//   of banded_fb.cu at C blocks): the warp shuffles, each warp's max
//   stored to its slot in every block of the cluster (distributed shared
//   memory), one cluster barrier, every warp's max over the C x warps
//   slots, and a second cluster barrier.
// It ports no TPU kernel: chip_smoke.py times it to give the sweeps'
// serial-diagonal floor (a problem's n_diag times this latency at the
// block's warp count), which neither bytes nor arithmetic bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ float probe_warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void cluster_probe_kernel(int iters, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float part[8 * 32];
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float v = (float)threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    v = probe_warp_max(v);
    if (lane < C)
      *cl.map_shared_rank(part + rank * nw + warp, (unsigned)lane) = v;
    asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" :::
                 "memory");
    float r = -INFINITY;
    for (int j = lane; j < C * nw; j += 32) r = fmaxf(r, part[j]);
    r = probe_warp_max(r);
    asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" :::
                 "memory");
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

// `clusters` clusters of C blocks (C <= 8) of `threads` threads on
// `stream`, the cluster step; out holds one float per block. Returns the
// launch's error, else cudaGetLastError().
extern "C" int sa_barrier_probe_cluster(int clusters, int threads, int iters,
                                        int C, float* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || clusters < 1 ||
      C < 1 || C > 8)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, cluster_probe_kernel, iters, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
