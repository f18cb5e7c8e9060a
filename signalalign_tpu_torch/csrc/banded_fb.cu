// Hand-written Hopper kernels for the canonical banded forward-backward
// (P=1 paths, MODE_MEAN_ONLY Gaussian emissions) of signalalign_tpu_torch.
//
// sa_fwd_sweep replaces the TPU forward kernels
//   signalalign_tpu/ops/banded_fb_pallas.py        _fwd_kernel      (pallas_forward)
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _fwd_kernel_log  (pallas_forward_b, PP=1)
// sa_bwd_sweep_compact replaces the TPU backward kernels
//   signalalign_tpu/ops/banded_fb_pallas.py        _bwd_kernel      (fuse_post)
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _bwd_kernel_log  (fuse_post + fuse_compact, PP=1)
// Both keep the output contract of the plain DP in
// signalalign_tpu_torch/ops/banded_fb.py (sweep_forward / sweep_backward):
// max-normalised diagonals plus per-diagonal offset increments. They do
// not copy the TPU layout (x-frame lanes, 128-lane stripes, ring
// re-basing, TwoSum scans): cells are addressed in the band-offset frame,
// cell (d, o) is x = x0[d] + o, y = d - x, and the backward offset is a
// plain double.
//
// What bounds them on this card: the serial chain of anti-diagonals. A
// diagonal depends on the two before it, so one problem is one block that
// walks its own n_diag diagonals in order, with two block barriers per
// diagonal (one inside the max reduction, one before the next diagonal
// reads the ring). The work per diagonal is small (W cells, ~10
// transcendentals each), so the barrier latency, not device-memory
// bandwidth or arithmetic, sets the time of one problem; throughput comes
// from many problems in flight (one block each, several per SM).
//
// What the design does about it: the three live diagonals (d, d-1, d-2)
// of all three states sit in a shared-memory ring (9 W floats, 36 KB at
// W = 1024), emissions are computed inline from the per-position tables
// (no emission stack in device memory), and each block stops at its own
// n_diag instead of the bucket's padded length. The backward kernel folds
// the posterior, the threshold and the survivor compaction into the sweep
// (a warp ballot + per-warp counts published by the diagonal's second
// barrier), so the posterior band is never written to device memory.
//
// Numerics: float32 values with precise expf/logf/log1pf (no fast math),
// built with --fmad=false so each operation rounds as in the plain twin,
// and the logaddexp formulation of torch.logaddexp; the backward running
// offset and the forward normaliser stream cvecf are float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
// state indices, transition slots (signalalign_tpu/models/pore_model.py)
constexpr int MATCH = 0, GAP_X = 1, GAP_Y = 2;
constexpr int T_MM = 0, T_MX = 1, T_MY = 2, T_XM = 3, T_XX = 4, T_YM = 6,
              T_YY = 8;
// ProblemTensors layout (signalalign_tpu_torch/ops/banded_fb.py)
constexpr int NREF = 5, NEV = 2, NMETA = 8, NPACK = 16;
constexpr int M_LX = 0, M_LY = 1, M_NDIAG = 2, M_EVPAD = 3, M_REFLEN = 4,
              M_EVLEN = 5;
constexpr int PACK_TRANS = 0, PACK_START = 9, PACK_END = 12, PACK_GAPX = 15;
constexpr int MAX_CHUNKS = 4;   // backward: W <= MAX_CHUNKS * 1024

__device__ __forceinline__ float lae(float a, float b) {
  float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Block-wide max or sum; blockDim.x is a multiple of 32. Contains one
// barrier; the caller separates a reuse of `part` from earlier readers.
template <bool SUM>
__device__ float block_reduce(float v, float* part) {
  for (int off = 16; off > 0; off >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, off);
    v = SUM ? v + u : fmaxf(v, u);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float r = part[0];
  for (int i = 1; i < nw; ++i) r = SUM ? r + part[i] : fmaxf(r, part[i]);
  return r;
}

// logsumexp over the 3 states x W cells of a normalised ring slot,
// weighted by logs[3] (torch.logsumexp of clamp(cur + logs, NEG)).
__device__ float block_lse(const float* slot, const float* logs, int W,
                           float* part) {
  float mx = NEG;
  for (int o = threadIdx.x; o < W; o += blockDim.x)
    for (int s = 0; s < 3; ++s)
      mx = fmaxf(mx, fmaxf(slot[s * W + o] + logs[s], NEG));
  __syncthreads();
  mx = block_reduce<false>(mx, part);
  float sm = 0.f;
  for (int o = threadIdx.x; o < W; o += blockDim.x)
    for (int s = 0; s < 3; ++s)
      sm += expf(fmaxf(slot[s * W + o] + logs[s], NEG) - mx);
  __syncthreads();
  sm = block_reduce<true>(sm, part);
  return logf(sm) + mx;
}

struct Problem {
  const int* x0;
  const int* width;
  const float* ref;   // (NREF, LX)
  const float* ev;    // (NEV, LE)
  int lX, lY, nd, efp, reflen, evlen, LX, LE;
  float t[9], start[3], end[3], gapx;

  __device__ void load(const int* x0_, const int* width_, const float* ref_,
                       const float* ev_, const int* meta_, const float* par_,
                       int D1, int LX_, int LE_) {
    const int b = blockIdx.x;
    x0 = x0_ + (size_t)b * D1;
    width = width_ + (size_t)b * D1;
    ref = ref_ + (size_t)b * NREF * LX_;
    ev = ev_ + (size_t)b * NEV * LE_;
    LX = LX_;
    LE = LE_;
    const int* meta = meta_ + (size_t)b * NMETA;
    const float* par = par_ + (size_t)b * NPACK;
    lX = meta[M_LX];
    lY = meta[M_LY];
    nd = meta[M_NDIAG];
    efp = meta[M_EVPAD];
    reflen = meta[M_REFLEN];
    evlen = meta[M_EVLEN];
    for (int i = 0; i < 9; ++i) t[i] = par[PACK_TRANS + i];
    for (int i = 0; i < 3; ++i) {
      start[i] = par[PACK_START + i];
      end[i] = par[PACK_END + i];
    }
    gapx = par[PACK_GAPX];
  }
};

__device__ __forceinline__ float rd(const float* slot, int s, int i, int W) {
  return (i >= 0 && i < W) ? slot[s * W + i] : NEG;
}

// ---------------------------------------------------------------- forward

__global__ void sa_fwd_sweep_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const float* __restrict__ ev_,
    const int* __restrict__ meta_, const float* __restrict__ par_,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, int D1, int W, int LX, int LE) {
  extern __shared__ float smem[];
  float* ring = smem;              // [3 slots][3 states][W]
  float* part = smem + 9 * W;      // [32] reduction partials
  __shared__ Problem P;
  if (threadIdx.x == 0) P.load(x0_, width_, ref_, ev_, meta_, par_, D1, LX, LE);
  for (int i = threadIdx.x; i < 9 * W; i += blockDim.x) ring[i] = NEG;
  __syncthreads();

  const int b = blockIdx.x;
  float* fs = fstack + (size_t)b * D1 * W;
  float* inc = f_incr + (size_t)b * D1;
  const int nd = P.nd;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;

  // diagonal 0: the single start cell (0, 0)
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) ring[s * W] = P.start[s];
    inc[0] = 0.f;
  }
  for (int o = threadIdx.x; o < W; o += blockDim.x)
    fs[o] = o == 0 ? P.start[MATCH] : NEG;
  __syncthreads();

  const float* tr = P.t;
  float m_prev = 0.f;
  for (int d = 1; d <= nd; ++d) {
    float* cur = ring + (d % 3) * 3 * W;
    const float* p1 = ring + ((d - 1) % 3) * 3 * W;
    const float* p2 = ring + ((d + 1) % 3) * 3 * W;   // == (d - 2) % 3
    const int xd = P.x0[d];
    const int wd = P.width[d];
    const int s1 = xd - P.x0[d - 1] - 1;
    const int s2 = d >= 2 ? xd - P.x0[d - 2] - 1 : W + 5;
    const int rs = clampi(xd, 0, P.reflen - W);
    const int es = clampi(P.lY - d + xd + P.efp, 0, P.evlen - W);

    float tmax = NEG;
    for (int o = threadIdx.x; o < W; o += blockDim.x) {
      float mm = NEG, gx = NEG, gy = NEG;
      if (o < wd) {
        const int xr = rs + o, je = es + o;
        const float m_hat = P.ref[xr], inv_m = P.ref[P.LX + xr],
                    c_m = P.ref[2 * P.LX + xr], inv_y = P.ref[3 * P.LX + xr],
                    c_y = P.ref[4 * P.LX + xr];
        const float ev_mean = P.ev[je];
        const bool kvalid = inv_m > 0.f;
        const bool ok = kvalid && P.ev[P.LE + je] > 0.5f;
        const bool legal = xr >= 1 && xr <= P.lX;
        const float am = (ev_mean - m_hat) * inv_m;
        const float ay = (ev_mean - m_hat) * inv_y;
        const float e_match = ok ? c_m - 0.5f * am * am : NEG;
        const float e_stay = ok ? c_y - 0.5f * ay * ay : NEG;
        const float e_gapx = kvalid ? P.gapx : NEG;

        const int il = o + s1, im = o + s2;
        const float src_x = lae(rd(p1, MATCH, il, W) + tr[T_MX],
                                rd(p1, GAP_X, il, W) + tr[T_XX]);
        gx = (legal ? src_x : NEG) + e_gapx;
        const float src_m = lae(lae(rd(p2, MATCH, im, W) + tr[T_MM],
                                    rd(p2, GAP_X, im, W) + tr[T_XM]),
                                rd(p2, GAP_Y, im, W) + tr[T_YM]) - m_prev;
        mm = (legal ? src_m : NEG) + e_match;
        gy = lae(rd(p1, MATCH, il + 1, W) + tr[T_MY],
                 rd(p1, GAP_Y, il + 1, W) + tr[T_YY]) + e_stay;
      }
      cur[MATCH * W + o] = mm;
      cur[GAP_X * W + o] = gx;
      cur[GAP_Y * W + o] = gy;
      tmax = fmaxf(tmax, fmaxf(mm, fmaxf(gx, gy)));
    }
    float m = block_reduce<false>(tmax, part);
    m = m > NEG * 0.5f ? m : 0.f;
    for (int o = threadIdx.x; o < W; o += blockDim.x) {
      for (int s = 0; s < 3; ++s)
        cur[s * W + o] = fmaxf(cur[s * W + o] - m, NEG);
      fs[(size_t)d * W + o] = cur[MATCH * W + o];
    }
    if (threadIdx.x == 0) inc[d] = m;
    m_prev = m;
    __syncthreads();
  }
  const float l = block_lse(ring + (nd % 3) * 3 * W, P.end, W, part);
  if (threadIdx.x == 0) lse_f[b] = l;
}


// ----------------------------------------------- backward + compaction

__global__ void sa_bwd_sweep_compact_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const float* __restrict__ ev_,
    const int* __restrict__ meta_, const float* __restrict__ par_,
    const float* __restrict__ fstack, const double* __restrict__ cvecf,
    float* __restrict__ b_incr, float* __restrict__ lse_b,
    int* __restrict__ slot_off, float* __restrict__ slot_val,
    int* __restrict__ cnt, int D1, int W, int LX, int LE, int R,
    float threshold) {
  extern __shared__ float smem[];
  float* ring = smem;                               // [3 slots][3 states][W]
  float* part = smem + 9 * W;                       // [32] reduction partials
  int* wcnt = reinterpret_cast<int*>(part + 32);    // [MAX_CHUNKS][32] survivors
  __shared__ Problem P;
  if (threadIdx.x == 0) P.load(x0_, width_, ref_, ev_, meta_, par_, D1, LX, LE);
  for (int i = threadIdx.x; i < 9 * W; i += blockDim.x) ring[i] = NEG;
  __syncthreads();

  const int b = blockIdx.x;
  const float* fs = fstack + (size_t)b * D1 * W;
  const double* cv = cvecf + (size_t)b * D1;
  float* inc = b_incr + (size_t)b * D1;
  int* so = slot_off + (size_t)b * D1 * R;
  float* sv = slot_val + (size_t)b * D1 * R;
  int* cn = cnt + (size_t)b * D1;
  const int nd = P.nd;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) {
    inc[d] = 0.f;
    cn[d] = 0;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nchunk = (W + blockDim.x - 1) / blockDim.x;
  const float* tr = P.t;
  float m_prev = 0.f;
  double bo = 0.0;   // running backward offset: Bo(d) = sum of m over >= d
  for (int d = nd; d >= 0; --d) {
    float* cur = ring + (d % 3) * 3 * W;
    const float* b1 = ring + ((d + 1) % 3) * 3 * W;
    const float* b2 = ring + ((d + 2) % 3) * 3 * W;
    const int xd = P.x0[d];
    const int wd = P.width[d];
    const bool fin = d == nd;
    const int u1 = d + 1 < D1 ? xd - P.x0[d + 1] : W + 5;
    const int u2 = d + 2 < D1 ? xd + 1 - P.x0[d + 2] : W + 5;
    const int r1 = clampi(xd + 1, 0, P.reflen - W);
    const int r0 = clampi(xd, 0, P.reflen - W);
    const int es = clampi(P.lY - d + xd + P.efp - 1, 0, P.evlen - W);
    float tmax = NEG;
    for (int o = threadIdx.x; o < W; o += blockDim.x) {
      float bm = NEG, bx = NEG, by = NEG;
      if (o < wd) {
        if (fin) {
          bm = P.end[MATCH];
          bx = P.end[GAP_X];
          by = P.end[GAP_Y];
        } else {
          const int xr1 = r1 + o, xr0 = r0 + o, je = es + o;
          const float ev_mean = P.ev[je];
          const bool evok = P.ev[P.LE + je] > 0.5f;
          // match TO cell (x+1, y+1)
          const float m_hat1 = P.ref[xr1], inv_m1 = P.ref[P.LX + xr1],
                      c_m1 = P.ref[2 * P.LX + xr1];
          const float am = (ev_mean - m_hat1) * inv_m1;
          const float e_match_to =
              (inv_m1 > 0.f && evok) ? c_m1 - 0.5f * am * am : NEG;
          // gapY TO cell (x, y+1)
          const float m_hat0 = P.ref[xr0], inv_m0 = P.ref[P.LX + xr0],
                      inv_y0 = P.ref[3 * P.LX + xr0],
                      c_y0 = P.ref[4 * P.LX + xr0];
          const float ay = (ev_mean - m_hat0) * inv_y0;
          const float e_stay_same =
              (inv_m0 > 0.f && evok) ? c_y0 - 0.5f * ay * ay : NEG;
          const float gapx_valid = inv_m1 > 0.f ? P.gapx : NEG;
          const bool legal1 = xr1 >= 1 && xr1 <= P.lX;

          const float gx_red =
              legal1 ? rd(b1, GAP_X, o + u1 + 1, W) + gapx_valid : NEG;
          const float mm_red =
              legal1 ? rd(b2, MATCH, o + u2, W) + e_match_to - m_prev : NEG;
          const float gy_term = rd(b1, GAP_Y, o + u1, W) + e_stay_same;
          bm = lae(lae(gx_red + tr[T_MX], mm_red + tr[T_MM]),
                   gy_term + tr[T_MY]);
          bx = lae(gx_red + tr[T_XX], mm_red + tr[T_XM]);
          by = lae(mm_red + tr[T_YM], gy_term + tr[T_YY]);
        }
      }
      cur[MATCH * W + o] = bm;
      cur[GAP_X * W + o] = bx;
      cur[GAP_Y * W + o] = by;
      tmax = fmaxf(tmax, fmaxf(bm, fmaxf(bx, by)));
    }
    float m = block_reduce<false>(tmax, part);          // barrier 1
    m = fin ? 0.f : (m > NEG * 0.5f ? m : 0.f);
    bo += (double)m;                                     // Bo(d)
    // absolute log posterior = f + b + cvecf[d] + Bo(d), b normalised
    const float c = (float)(cv[d] + bo);

    float pk[MAX_CHUNKS];   // this lane's survivor value per chunk
    int rk[MAX_CHUNKS];     // its rank inside its warp, -1 for none
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      pk[k] = 0.f;
      rk[k] = -1;
      if (k < nchunk) {   // uniform across the block
        const int o = threadIdx.x + k * blockDim.x;
        bool surv = false;
        float p = 0.f;
        if (o < W) {
          for (int s = 0; s < 3; ++s)
            cur[s * W + o] = fmaxf(cur[s * W + o] - m, NEG);
          const int x = xd + o, y = d - x;
          if (o < wd && x > 0 && y > 0 && x <= P.lX && y <= P.lY) {
            p = expf(fmaxf(fs[(size_t)d * W + o] + cur[MATCH * W + o] + c,
                           NEG));
            surv = p >= threshold;
          }
        }
        // survivors are ranked in band-offset (= x) order: chunk, warp, lane
        const unsigned ball = __ballot_sync(0xffffffffu, surv);
        if (lane == 0) wcnt[k * 32 + warp] = __popc(ball);
        if (surv) {
          pk[k] = p;
          rk[k] = __popc(ball & ((1u << lane) - 1u));
        }
      }
    }
    // barrier 2: publishes the normalised diagonal and the warp counts.
    // The next diagonal writes wcnt only after its barrier 1, which every
    // thread reaches after reading wcnt below.
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k) {
      if (k < nchunk) {
        int base = before;
        for (int w = 0; w < warp; ++w) base += wcnt[k * 32 + w];
        const int r = base + rk[k];
        if (rk[k] >= 0 && r < R) {
          so[(size_t)d * R + r] = threadIdx.x + k * blockDim.x;
          sv[(size_t)d * R + r] = pk[k];
        }
        for (int w = 0; w < nw; ++w) before += wcnt[k * 32 + w];
      }
    }
    if (threadIdx.x == 0) {
      inc[d] = m;
      cn[d] = before;
    }
    m_prev = m;
  }
  const float l = block_lse(ring, P.start, W, part);   // diagonal 0 = slot 0
  if (threadIdx.x == 0) lse_b[b] = l;
}

int threads_for(int W) { return W >= 1024 ? 1024 : ((W + 31) / 32) * 32; }

}  // namespace

// C interface, loaded with ctypes. Every pointer is a device pointer of a
// contiguous tensor; the kernels launch on `stream`, allocate nothing and
// do not synchronise. Each returns cudaGetLastError() after its launch.

extern "C" int sa_fwd_sweep(const int* x0, const int* width, const float* ref,
                            const float* ev, const int* meta,
                            const float* par, float* fstack, float* f_incr,
                            float* lse_f, int B, int D1, int W, int LX,
                            int LE, void* stream) {
  const size_t smem = (9 * (size_t)W + 32) * sizeof(float);
  cudaFuncSetAttribute(sa_fwd_sweep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sa_fwd_sweep_kernel<<<B, threads_for(W), smem, (cudaStream_t)stream>>>(
      x0, width, ref, ev, meta, par, fstack, f_incr, lse_f, D1, W, LX, LE);
  return (int)cudaGetLastError();
}

extern "C" int sa_bwd_sweep_compact(
    const int* x0, const int* width, const float* ref, const float* ev,
    const int* meta, const float* par, const float* fstack,
    const double* cvecf, float* b_incr, float* lse_b, int* slot_off,
    float* slot_val, int* cnt, int B, int D1, int W, int LX, int LE, int R,
    float threshold, void* stream) {
  if (W > MAX_CHUNKS * 1024) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (9 * (size_t)W + 32) * sizeof(float) + MAX_CHUNKS * 32 * sizeof(int);
  cudaFuncSetAttribute(sa_bwd_sweep_compact_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sa_bwd_sweep_compact_kernel<<<B, threads_for(W), smem,
                                (cudaStream_t)stream>>>(
      x0, width, ref, ev, meta, par, fstack, cvecf, b_incr, lse_b, slot_off,
      slot_val, cnt, D1, W, LX, LE, R, threshold);
  return (int)cudaGetLastError();
}
