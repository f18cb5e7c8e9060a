// Hand-written Hopper kernels for the probability-space banded
// forward-backward of signalalign_tpu_torch (P = 1 path per cell,
// MODE_MEAN_ONLY Gaussian emissions, bands of at most 512 offsets).
//
// sa_fwd_sweep_prob replaces the TPU forward kernel
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _fwd_kernel  (log_space=False)
// sa_bwd_sweep_compact_prob replaces the TPU backward kernel
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _bwd_kernel  (log_space=False, fuse_post)
// and the survivor compaction that follows it there, which here is fused
// into the sweep as in sa_bwd_sweep_compact (csrc/banded_fb.cu).
//
// The recurrence is the TPU kernels', and the plain twins'
// (sweep_forward_prob / sweep_backward_prob in
// signalalign_tpu_torch/ops/banded_fb.py): f32 probabilities, each
// diagonal's max rescaled to SCALE = 2^100 (as 1/m, then * SCALE: SCALE/m
// overflows on a near-dead diagonal); the step at diagonal d is taken in
// the larger frame of d-1 and d-2 ("max-frame leapfrog"), both damped
// into it by exp(<= 0); emissions are event-normalised, exp(c - z^2/2 -
// ev_best[event]), with exp(c) and the transitions taken as probabilities
// on the host. Out-of-band cells and impossible states are exact zeros.
// The outputs keep the log-space kernels' contract: the forward match row
// log(value) - LOG_SCALE (NEG where the value is 0), the per-diagonal
// frame increments lr(d) whose prefix (forward) or suffix (backward) sums
// are the log frames, and the end/start-weighted log-sums; the totals lack
// the problem's event normaliser (the caller adds it). They do not copy
// the TPU layout (x-frame, 128-lane stripes, ring re-basing, u16 posterior
// rows re-centred on their max, DMA double buffers): cell (d, o) is x =
// x0[d] + o, y = d - x.
//
// What bounds them on this card: as the log-space sweeps, the serial chain
// of anti-diagonals, one block per problem, two block barriers per
// diagonal. A cell costs 2 expf (its emissions) and 1 logf (its stored
// log row) forward, plus the posterior's expf backward, where the log
// recurrence spent ~8 transcendentals on logaddexps: only the work above
// the barrier floor can shrink. One thread holds one band offset (W <=
// 512 threads), the two live diagonals of all three states sit in shared
// memory (6 W floats), and the backward ranks survivors by warp ballot and
// writes them to R slots per diagonal, as sa_bwd_sweep_compact does.
//
// Numerics: as the twins, op for op, built with --fmad=false; max and min
// propagate NaN (torch.amax / torch.clamp), so a tripped problem (f32
// range exhausted: its totals come out NaN or -inf) gives the same flags
// on the card as in the twin. Such a problem's cvecf is +inf or NaN: every
// in-band cell or none survives, and no slot past R is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr float SCALE = 0x1p100f;                 // 2^100
constexpr float LOG_SCALE = 69.31471805599453f;   // 100 ln 2, in float32
// state indices, transition slots (signalalign_tpu_torch/models/pore_model.py)
constexpr int MATCH = 0, GAP_X = 1, GAP_Y = 2;
constexpr int T_MM = 0, T_MX = 1, T_MY = 2, T_XM = 3, T_XX = 4, T_YM = 6,
              T_YY = 8;
// ProblemTensors layout (signalalign_tpu_torch/ops/banded_fb.py)
constexpr int NREF = 5, NEV = 2, NMETA = 8, NPACK = 17;
constexpr int M_LX = 0, M_LY = 1, M_NDIAG = 2, M_EVPAD = 3, M_REFLEN = 4,
              M_EVLEN = 5;
constexpr int PACK_TRANS = 0, PACK_START = 9, PACK_END = 12, PACK_GAPX = 15;
constexpr int MAX_W = 512;                        // one band offset a thread

// max / min that return NaN if either argument is NaN
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Block-wide max (NaN-propagating) or sum; blockDim.x is a multiple of
// 32. Contains one barrier; the caller separates a reuse of `part` from
// earlier readers.
template <bool SUM>
__device__ float block_reduce(float v, float* part) {
  for (int off = 16; off > 0; off >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, off);
    v = SUM ? v + u : nmax(v, u);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float r = part[0];
  for (int i = 1; i < nw; ++i) r = SUM ? r + part[i] : nmax(r, part[i]);
  return r;
}

// log(sum of a normalised ring slot weighted by the state probabilities
// w[3]) - LOG_SCALE, summed state by state (the twins' _prob_lse)
__device__ float block_prob_lse(const float* slot, const float* w, int W,
                                float* part) {
  float s[3];
  for (int st = 0; st < 3; ++st) {
    float v = 0.f;
    for (int c = threadIdx.x; c < W; c += blockDim.x) v += slot[st * W + c] * w[st];
    __syncthreads();
    s[st] = block_reduce<true>(v, part);
  }
  return logf(s[0] + s[1] + s[2]) - LOG_SCALE;
}

struct Problem {
  const int* x0;
  const int* width;
  const float* ref;      // (NREF, 1, LX)
  const float* cexp;     // (2, LX): exp(c_m), exp(c_y)
  const float* ev;       // (NEV, LE)
  const float* evb;      // (LE,) best-case log emission per event
  int lX, lY, nd, efp, reflen, evlen, LX, LE;
  float t[9], start[3], end[3], gapx;   // probabilities

  __device__ void load(const int* x0_, const int* width_, const float* ref_,
                       const float* ev_, const int* meta_,
                       const float* cexp_, const float* evb_,
                       const float* par_, int D1, int LX_, int LE_) {
    const int b = blockIdx.x;
    x0 = x0_ + (size_t)b * D1;
    width = width_ + (size_t)b * D1;
    ref = ref_ + (size_t)b * NREF * LX_;
    cexp = cexp_ + (size_t)b * 2 * LX_;
    ev = ev_ + (size_t)b * NEV * LE_;
    evb = evb_ + (size_t)b * LE_;
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

  __device__ __forceinline__ float rf(int r, int x) const {
    return ref[(size_t)r * LX + x];
  }

  // event-normalised emission exp(c - 0.5 z^2 - ev_best): (ok ? exp(c) :
  // 0) * exp(-(0.5 z z + cw)), the twins' order
  __device__ __forceinline__ float emit(bool ok, float cx, float z,
                                        float cw) const {
    return (ok ? cx : 0.f) * expf(-(0.5f * z * z + cw));
  }
};

// state s of band offset i of a ring slot; 0 outside the band
__device__ __forceinline__ float rd(const float* slot, int s, int i, int W) {
  return (i >= 0 && i < W) ? slot[s * W + i] : 0.f;
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(MAX_W) sa_fwd_sweep_prob_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const float* __restrict__ ev_,
    const int* __restrict__ meta_, const float* __restrict__ cexp_,
    const float* __restrict__ evb_, const float* __restrict__ par_,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, int D1, int W, int LX, int LE) {
  extern __shared__ float smem[];
  float* ring = smem;              // [2 slots][3 states][W]
  float* part = smem + 6 * W;      // [32] reduction partials
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, ev_, meta_, cexp_, evb_, par_, D1, LX, LE);
  for (int i = threadIdx.x; i < 6 * W; i += blockDim.x) ring[i] = 0.f;
  __syncthreads();

  const int b = blockIdx.x;
  const int o = threadIdx.x;       // this thread's band offset
  float* fs = fstack + (size_t)b * D1 * W;
  float* inc = f_incr + (size_t)b * D1;
  const int nd = pr.nd;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;
  const float* tr = pr.t;

  float lr = 0.f;   // log(FRAME(d-1) / FRAME(d-2))
  for (int d = 0; d <= nd; ++d) {
    float* cur = ring + (d & 1) * 3 * W;          // holds d-2 until written
    const float* p1 = ring + ((d + 1) & 1) * 3 * W;
    const float* p2 = cur;
    float mm = 0.f, gx = 0.f, gy = 0.f;
    if (d == 0) {
      // the start cell (0, 0), and nothing else
      if (o == 0) {
        mm = pr.start[MATCH] * SCALE;
        gx = pr.start[GAP_X] * SCALE;
        gy = pr.start[GAP_Y] * SCALE;
      }
    } else if (o < W && o < pr.width[d]) {
      const int xd = pr.x0[d];
      const int s1 = xd - pr.x0[d - 1] - 1;
      const int s2 = d >= 2 ? xd - pr.x0[d - 2] - 1 : W + 5;
      const int xr = clampi(xd, 0, pr.reflen - W) + o;
      const int je = clampi(pr.lY - d + xd + pr.efp, 0, pr.evlen - W) + o;
      const float m_hat = pr.rf(0, xr), inv_m = pr.rf(1, xr),
                  inv_y = pr.rf(3, xr);
      const float ev_mean = pr.ev[je], cw = pr.evb[je];
      const bool kvalid = inv_m > 0.f;
      const bool ok = kvalid && pr.ev[pr.LE + je] > 0.5f;
      const float am = (ev_mean - m_hat) * inv_m;
      const float ay = (ev_mean - m_hat) * inv_y;
      const float e_match = pr.emit(ok, pr.cexp[xr], am, cw);
      const float e_stay = pr.emit(ok, pr.cexp[pr.LX + xr], ay, cw);
      const float e_gapx = kvalid ? pr.gapx : 0.f;
      const float w1 = expf(nmin(lr, 0.f)), w2 = expf(-nmax(lr, 0.f));
      const int il = o + s1, im = o + s2;
      // gapX from (x-1, y), match from (x-1, y-1), gapY from (x, y-1)
      gx = (rd(p1, MATCH, il, W) * (tr[T_MX] * w1)
            + rd(p1, GAP_X, il, W) * (tr[T_XX] * w1)) * e_gapx;
      mm = ((rd(p2, MATCH, im, W) * tr[T_MM] + rd(p2, GAP_X, im, W) * tr[T_XM]
             + rd(p2, GAP_Y, im, W) * tr[T_YM]) * w2) * e_match;
      gy = (rd(p1, MATCH, il + 1, W) * (tr[T_MY] * w1)
            + rd(p1, GAP_Y, il + 1, W) * (tr[T_YY] * w1)) * e_stay;
    }
    // its barrier also ends every read of diagonal d-2 in `cur`
    const float mx = block_reduce<false>(nmax(mm, nmax(gx, gy)), part);
    const float m = mx > 0.f ? mx : SCALE;
    const float sc1 = 1.f / m;
    mm = (mm * sc1) * SCALE;
    gx = (gx * sc1) * SCALE;
    gy = (gy * sc1) * SCALE;
    if (o < W) {
      cur[MATCH * W + o] = mm;
      cur[GAP_X * W + o] = gx;
      cur[GAP_Y * W + o] = gy;
      fs[(size_t)d * W + o] = nmax(logf(mm) - LOG_SCALE, NEG);
    }
    lr = nmax(-lr, 0.f) + (logf(m) - LOG_SCALE);
    if (threadIdx.x == 0) inc[d] = lr;
    __syncthreads();
  }
  const float l = block_prob_lse(ring + (nd & 1) * 3 * W, pr.end, W, part);
  if (threadIdx.x == 0) lse_f[b] = l;
}

// ----------------------------------------------- backward + compaction

__global__ void __launch_bounds__(MAX_W) sa_bwd_sweep_compact_prob_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const float* __restrict__ ev_,
    const int* __restrict__ meta_, const float* __restrict__ cexp_,
    const float* __restrict__ evb_, const float* __restrict__ par_,
    const float* __restrict__ fstack, const double* __restrict__ cvecf,
    float* __restrict__ b_incr, float* __restrict__ lse_b,
    int* __restrict__ slot_cell, float* __restrict__ slot_val,
    int* __restrict__ cnt, int D1, int W, int LX, int LE, int R,
    float threshold) {
  extern __shared__ float smem[];
  float* ring = smem;                               // [2 slots][3 states][W]
  float* part = smem + 6 * W;                       // [32] reduction partials
  int* wcnt = reinterpret_cast<int*>(part + 32);    // [32] survivors per warp
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, ev_, meta_, cexp_, evb_, par_, D1, LX, LE);
  for (int i = threadIdx.x; i < 6 * W; i += blockDim.x) ring[i] = 0.f;
  __syncthreads();

  const int b = blockIdx.x;
  const int o = threadIdx.x;
  const float* fs = fstack + (size_t)b * D1 * W;
  const double* cv = cvecf + (size_t)b * D1;
  float* inc = b_incr + (size_t)b * D1;
  int* so = slot_cell + (size_t)b * D1 * R;
  float* sv = slot_val + (size_t)b * D1 * R;
  int* cn = cnt + (size_t)b * D1;
  const int nd = pr.nd;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) {
    inc[d] = 0.f;
    cn[d] = 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* tr = pr.t;

  float lr = 0.f;    // log(FRAME(d+1) / FRAME(d+2))
  double bo = 0.0;   // running backward offset: Bo(d) = sum of lr over >= d
  for (int d = nd; d >= 0; --d) {
    float* cur = ring + (d & 1) * 3 * W;            // holds d+2 until written
    const float* b1 = ring + ((d + 1) & 1) * 3 * W;
    const float* b2 = cur;
    const int xd = pr.x0[d];
    const bool fin = d == nd;
    float bm = 0.f, bx = 0.f, by = 0.f;
    if (o < W && o < pr.width[d]) {
      if (fin) {
        bm = pr.end[MATCH] * SCALE;
        bx = pr.end[GAP_X] * SCALE;
        by = pr.end[GAP_Y] * SCALE;
      } else {
        const int u1 = xd - pr.x0[d + 1];
        const int u2 = d + 2 < D1 ? xd + 1 - pr.x0[d + 2] : W + 5;
        const int xr1 = clampi(xd + 1, 0, pr.reflen - W) + o;
        const int xr0 = clampi(xd, 0, pr.reflen - W) + o;
        const int je =
            clampi(pr.lY - d + xd + pr.efp - 1, 0, pr.evlen - W) + o;
        const float ev_mean = pr.ev[je], cw = pr.evb[je];
        const bool evok = pr.ev[pr.LE + je] > 0.5f;
        // match TO (x+1, y+1) and gapX TO (x+1, y) at x+1; gapY TO
        // (x, y+1) at x; the first and the last consume event y+1
        const float m_hat1 = pr.rf(0, xr1), inv_m1 = pr.rf(1, xr1);
        const float am1 = (ev_mean - m_hat1) * inv_m1;
        const float e_match_to =
            pr.emit(inv_m1 > 0.f && evok, pr.cexp[xr1], am1, cw);
        const float m_hat0 = pr.rf(0, xr0), inv_m0 = pr.rf(1, xr0),
                    inv_y0 = pr.rf(3, xr0);
        const float ay0 = (ev_mean - m_hat0) * inv_y0;
        const float e_stay_same =
            pr.emit(inv_m0 > 0.f && evok, pr.cexp[pr.LX + xr0], ay0, cw);
        const float gapx_ok = inv_m1 > 0.f ? pr.gapx : 0.f;
        const float w1 = expf(nmin(lr, 0.f)), w2 = expf(-nmax(lr, 0.f));
        const float gx_red = (rd(b1, GAP_X, o + u1 + 1, W) * w1) * gapx_ok;
        const float mm_red = (rd(b2, MATCH, o + u2, W) * w2) * e_match_to;
        const float gy_term = (rd(b1, GAP_Y, o + u1, W) * w1) * e_stay_same;
        bm = gx_red * tr[T_MX] + mm_red * tr[T_MM] + gy_term * tr[T_MY];
        bx = gx_red * tr[T_XX] + mm_red * tr[T_XM];
        by = mm_red * tr[T_YM] + gy_term * tr[T_YY];
      }
    }
    // barrier 1; it also ends every read of diagonal d+2 in `cur`
    const float mx = block_reduce<false>(nmax(bm, nmax(bx, by)), part);
    const float m = fin ? SCALE : (mx > 0.f ? mx : SCALE);
    const float sc1 = 1.f / m;
    bm = (bm * sc1) * SCALE;
    bx = (bx * sc1) * SCALE;
    by = (by * sc1) * SCALE;
    lr = nmax(-lr, 0.f) + (logf(m) - LOG_SCALE);
    bo += (double)lr;                                    // Bo(d)
    // absolute log posterior = fm + bmn + cvecf[d] + Bo(d)
    const float cd = (float)(cv[d] + bo);
    bool surv = false;
    float p = 0.f;
    if (o < W) {
      cur[MATCH * W + o] = bm;
      cur[GAP_X * W + o] = bx;
      cur[GAP_Y * W + o] = by;
      const int x = xd + o, y = d - x;
      if (o < pr.width[d] && x > 0 && y > 0 && x <= pr.lX && y <= pr.lY) {
        const float bmn = nmax(logf(bm) - LOG_SCALE, NEG);
        p = expf(nmax(fs[(size_t)d * W + o] + bmn + cd, NEG));
        surv = p >= threshold;
      }
    }
    // survivors rank in band-offset order: warp, then lane
    const unsigned ball = __ballot_sync(0xffffffffu, surv);
    if (lane == 0) wcnt[warp] = __popc(ball);
    // barrier 2: publishes the rescaled diagonal and the warp counts. The
    // next diagonal writes wcnt only after its barrier 1, which every
    // thread reaches after reading wcnt below.
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += wcnt[w];
      total += wcnt[w];
    }
    const int r = before + __popc(ball & ((1u << lane) - 1u));
    if (surv && r < R) {
      so[(size_t)d * R + r] = o;
      sv[(size_t)d * R + r] = p;
    }
    if (threadIdx.x == 0) {
      inc[d] = lr;
      cn[d] = total;
    }
  }
  const float l = block_prob_lse(ring, pr.start, W, part);   // d = 0: slot 0
  if (threadIdx.x == 0) lse_b[b] = l;
}

int threads_for(int W) { return ((W + 31) / 32) * 32; }

}  // namespace

// C interface, loaded with ctypes. Every pointer is a device pointer of a
// contiguous tensor of a P = 1 Gaussian bucket (ProblemTensors and its
// ProbTensors: cexp (B, 2, LX), evb (B, LE), par (B, NPACK) probabilities);
// the kernels launch on `stream`, allocate nothing and do not synchronise.
// Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a band wider than 512 offsets.

extern "C" int sa_fwd_sweep_prob(const int* x0, const int* width,
                                 const float* ref, const float* ev,
                                 const int* meta, const float* cexp,
                                 const float* evb, const float* par,
                                 float* fstack, float* f_incr, float* lse_f,
                                 int B, int D1, int W, int LX, int LE,
                                 void* stream) {
  if (W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = (6 * (size_t)W + 32) * sizeof(float);
  sa_fwd_sweep_prob_kernel<<<B, threads_for(W), smem, (cudaStream_t)stream>>>(
      x0, width, ref, ev, meta, cexp, evb, par, fstack, f_incr, lse_f, D1, W,
      LX, LE);
  return (int)cudaGetLastError();
}

extern "C" int sa_bwd_sweep_compact_prob(
    const int* x0, const int* width, const float* ref, const float* ev,
    const int* meta, const float* cexp, const float* evb, const float* par,
    const float* fstack, const double* cvecf, float* b_incr, float* lse_b,
    int* slot_cell, float* slot_val, int* cnt, int B, int D1, int W, int LX,
    int LE, int R, float threshold, void* stream) {
  if (W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = (6 * (size_t)W + 32) * sizeof(float) + 32 * sizeof(int);
  sa_bwd_sweep_compact_prob_kernel
      <<<B, threads_for(W), smem, (cudaStream_t)stream>>>(
          x0, width, ref, ev, meta, cexp, evb, par, fstack, cvecf, b_incr,
          lse_b, slot_cell, slot_val, cnt, D1, W, LX, LE, R, threshold);
  return (int)cudaGetLastError();
}
