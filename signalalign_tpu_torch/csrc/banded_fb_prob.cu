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
// of anti-diagonals, one block per problem. A cell costs 2 expf (its
// emissions) and 1 logf (its stored log row) forward, plus the
// posterior's expf backward, where the log recurrence spent ~8
// transcendentals on logaddexps, so what a diagonal waits on is latency:
// its block max and the loads and exponentials its cells' emissions
// need. The design takes the emissions off that chain and waits on one
// barrier a diagonal:
// - a ring of three slots holds *raw* states: diagonal d goes to slot d
//   mod 3, whose last reader (d-1) finished before barrier d-1; readers
//   rescale at read time as the twins rescale, (v * sc) * SCALE with sc =
//   1/m of the diagonal read, so every value is the twin's;
// - the per-warp maxima are double-buffered by diagonal parity and, after
//   the barrier, each warp's lanes reduce them with shuffles;
// - the loop runs from one barrier to the next with no branch between:
//   diagonal d-1's max, stack row and frame increment, then diagonal d's
//   emissions from the inputs loaded during d-1, the loads of d+1 (band
//   origins two ahead), then d's cells, so the compiler interleaves the
//   loads and exponentials with the max's reduction and the ring reads;
// - the backward forms diagonal d+1's posterior and ballot after barrier
//   d+1 and writes the survivor slots of d+2 there, whose warp counts that
//   barrier published (each warp's rank base and the total by one integer
//   reduction each); its forward match row and cvecf come a diagonal ahead.
// One thread holds one band offset (W <= 512 threads, the faster of one
// and two cells a thread on an H100). Outputs equal the earlier
// two-barrier design's bit for bit (PERF.md §6).
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

  // event-normalised emission exp(c - 0.5 z^2 - ev_best): (ok ? exp(c) :
  // 0) * exp(-(0.5 z z + cw)), the twins' order
  __device__ __forceinline__ float emit(bool ok, float cx, float z,
                                        float cw) const {
    return (ok ? cx : 0.f) * expf(-(0.5f * z * z + cw));
  }
};

// state s of band offset i of a ring slot of raw states, rescaled by its
// diagonal's 1/m as the twins rescale it ((v * sc) * SCALE, op for op):
// 0 outside the band
__device__ __forceinline__ float rdn(const float* slot, int s, int i, int W,
                                     float sc) {
  return (i >= 0 && i < W) ? (slot[s * W + i] * sc) * SCALE : 0.f;
}

// NaN-propagating warp max
__device__ __forceinline__ float warp_nmax(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The diagonal's one barrier, after each warp's max went to part[par *
// 32 + warp]; returns the block max: each warp's lanes read the nw
// partials, one each, and reduce them with shuffles, straight-line code
// that the compiler interleaves with the independent work after it (a
// serial read of the partials, a loop, measured slower: PERF.md §6). A
// block of one warp synchronises that warp alone.
__device__ __forceinline__ float diag_barrier_max(float wmax,
                                                  const float* part, int par,
                                                  int nw) {
  if (nw == 1) {
    __syncwarp();
    return wmax;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_nmax(lane < nw ? part[par * 32 + lane] : 0.f);
}

// One cell's emission inputs, loaded a diagonal before they are used: the
// forward's reference rows m_hat, inv_m, inv_y and exp constants at x,
// its event's mean, best-case log emission and mask (the backward's: the
// same at x+1 (match and gapX targets, `1`) and at x (stay target, `0`))
struct FwdLoad {
  float m_hat, inv_m, inv_y, cx_m, cx_y, ev_mean, cw, flag;
};
struct BwdLoad {
  float m_hat1, inv_m1, cx_m1, m_hat0, inv_m0, inv_y0, cx_y0, ev_mean, cw,
      flag;
};

// One cell's emissions: its event-normalised match and stay
// probabilities, and its gapX weight
struct Emis {
  float match, stay, gapx;
};

// The forward's inputs of cell o (clamped into the band) on diagonal d of
// band origin xd: every index stays inside the tables
__device__ __forceinline__ FwdLoad fwd_load(const Problem& pr, int d, int xd,
                                            int o, int W) {
  o = min(o, W - 1);
  const int xr = clampi(xd, 0, pr.reflen - W) + o;
  const int je = clampi(pr.lY - d + xd + pr.efp, 0, pr.evlen - W) + o;
  return {__ldg(pr.ref + xr), __ldg(pr.ref + pr.LX + xr),
          __ldg(pr.ref + 3 * pr.LX + xr), __ldg(pr.cexp + xr),
          __ldg(pr.cexp + pr.LX + xr), __ldg(pr.ev + je), __ldg(pr.evb + je),
          __ldg(pr.ev + pr.LE + je)};
}

// the twins' _prob_emissions, op for op
__device__ __forceinline__ Emis fwd_emis(const Problem& pr, const FwdLoad& a) {
  const bool kvalid = a.inv_m > 0.f;
  const bool ok = kvalid && a.flag > 0.5f;
  const float am = (a.ev_mean - a.m_hat) * a.inv_m;
  const float ay = (a.ev_mean - a.m_hat) * a.inv_y;
  return {pr.emit(ok, a.cx_m, am, a.cw), pr.emit(ok, a.cx_y, ay, a.cw),
          kvalid ? pr.gapx : 0.f};
}

// The backward's inputs of cell o on diagonal d: match TO (x+1, y+1) and
// gapX TO (x+1, y) at x+1, gapY TO (x, y+1) at x, with event y+1
__device__ __forceinline__ BwdLoad bwd_load(const Problem& pr, int d, int xd,
                                            int o, int W) {
  o = min(o, W - 1);
  const int xr1 = clampi(xd + 1, 0, pr.reflen - W) + o;
  const int xr0 = clampi(xd, 0, pr.reflen - W) + o;
  const int je = clampi(pr.lY - d + xd + pr.efp - 1, 0, pr.evlen - W) + o;
  return {__ldg(pr.ref + xr1), __ldg(pr.ref + pr.LX + xr1),
          __ldg(pr.cexp + xr1), __ldg(pr.ref + xr0),
          __ldg(pr.ref + pr.LX + xr0), __ldg(pr.ref + 3 * pr.LX + xr0),
          __ldg(pr.cexp + pr.LX + xr0), __ldg(pr.ev + je), __ldg(pr.evb + je),
          __ldg(pr.ev + pr.LE + je)};
}

// e_match_to, e_stay_same and gapx_ok of the twin, op for op
__device__ __forceinline__ Emis bwd_emis(const Problem& pr, const BwdLoad& a) {
  const bool evok = a.flag > 0.5f;
  const float am1 = (a.ev_mean - a.m_hat1) * a.inv_m1;
  const float ay0 = (a.ev_mean - a.m_hat0) * a.inv_y0;
  return {pr.emit(a.inv_m1 > 0.f && evok, a.cx_m1, am1, a.cw),
          pr.emit(a.inv_m0 > 0.f && evok, a.cx_y0, ay0, a.cw),
          a.inv_m1 > 0.f ? pr.gapx : 0.f};
}

// log(sum of ring slot `slot` of raw states rescaled by sc, weighted by
// the state probabilities w[3]) - LOG_SCALE, summed state by state (the
// twins' _prob_lse)
__device__ float block_prob_lse(const float* slot, float sc, const float* w,
                                int W, float* part) {
  float s[3];
  for (int st = 0; st < 3; ++st) {
    float v = 0.f;
    for (int c = threadIdx.x; c < W; c += blockDim.x)
      v += ((slot[st * W + c] * sc) * SCALE) * w[st];
    __syncthreads();
    s[st] = block_reduce<true>(v, part);
  }
  return logf(s[0] + s[1] + s[2]) - LOG_SCALE;
}

// ---------------------------------------------------------------- forward

// The loop runs from one barrier to the next: after barrier d-1 it forms
// diagonal d-1's max, stack row and frame increment, diagonal d's
// emissions from the inputs loaded during d-1, issues the loads of d+1,
// and only then reads the ring for d's cells; with no branch between the
// barriers the compiler interleaves the emissions and the loads with the
// max's reduction and the ring reads. Written for K cells a thread and
// launched at K = 1: the same loop written for one cell compiled to a 16%
// slower forward on an H100, while the backward's one-cell form was 11%
// faster than its K form (PERF.md §6).
template <int K>
__global__ void __launch_bounds__(MAX_W) sa_fwd_sweep_prob_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const float* __restrict__ ev_,
    const int* __restrict__ meta_, const float* __restrict__ cexp_,
    const float* __restrict__ evb_, const float* __restrict__ par_,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, int D1, int W, int LX, int LE) {
  extern __shared__ float smem[];
  float* ring = smem;              // [3 slots][3 states][W] raw states
  float* part = smem + 9 * W;      // [2 parities][32] per-warp maxima
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, ev_, meta_, cexp_, evb_, par_, D1, LX, LE);
  for (int i = threadIdx.x; i < 9 * W; i += blockDim.x) ring[i] = 0.f;
  __syncthreads();

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* fs = fstack + (size_t)b * D1 * W;
  float* inc = f_incr + (size_t)b * D1;
  const int nd = pr.nd, last = D1 - 1;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;
  const float* tr = pr.t;

  // diagonal 0: the start cell (0, 0), and nothing else, in slot 0
  float vm[K], vx[K], vy[K];   // this thread's raw states of diagonal d
  float tmax = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int o = threadIdx.x + k * blockDim.x;
    vm[k] = o == 0 ? pr.start[MATCH] * SCALE : 0.f;
    vx[k] = o == 0 ? pr.start[GAP_X] * SCALE : 0.f;
    vy[k] = o == 0 ? pr.start[GAP_Y] * SCALE : 0.f;
    if (o < W) {
      ring[MATCH * W + o] = vm[k];
      ring[GAP_X * W + o] = vx[k];
      ring[GAP_Y * W + o] = vy[k];
    }
    tmax = nmax(tmax, nmax(vm[k], nmax(vx[k], vy[k])));
  }
  tmax = warp_nmax(tmax);
  if (nw > 1 && lane == 0) part[warp] = tmax;
  // band origins of d-2, d-1, d (with its width) and d+1: each loaded two
  // diagonals ahead; the inputs of diagonal d's emissions one ahead
  int xm2 = 0, xm1 = pr.x0[0];
  int xd = pr.x0[min(1, last)], wd = pr.width[min(1, last)];
  int xn = pr.x0[min(2, last)];
  FwdLoad in[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    in[k] = fwd_load(pr, 1, xd, threadIdx.x + k * blockDim.x, W);
  float sc1 = 0.f, sc2 = 0.f;   // 1/m of diagonals d-1 and d-2
  float lr = 0.f;               // log(FRAME(d-1) / FRAME(d-2))

  // diagonal d-1's max, stack row and frame increment, after its barrier
  auto close = [&](int dd) {
    const float mx = diag_barrier_max(tmax, part, dd & 1, nw);
    const float m = mx > 0.f ? mx : SCALE;
    const float sc = 1.f / m;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = threadIdx.x + k * blockDim.x;
      if (o < W)
        fs[(size_t)dd * W + o] =
            nmax(logf((vm[k] * sc) * SCALE) - LOG_SCALE, NEG);
    }
    lr = nmax(-lr, 0.f) + (logf(m) - LOG_SCALE);
    if (threadIdx.x == 0) inc[dd] = lr;
    sc2 = sc1;
    sc1 = sc;
  };

  for (int d = 1; d <= nd; ++d) {
    close(d - 1);
    const float* p1 = ring + ((d + 2) % 3) * 3 * W;   // diagonal d-1
    const float* p2 = ring + ((d + 1) % 3) * 3 * W;   // diagonal d-2
    float* cur = ring + (d % 3) * 3 * W;
    Emis e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = fwd_emis(pr, in[k]);
    // the loads of d+1 and the band of d+2
    const int xnn = pr.x0[min(d + 2, last)], wn = pr.width[min(d + 1, last)];
#pragma unroll
    for (int k = 0; k < K; ++k)
      in[k] = fwd_load(pr, d + 1, xn, threadIdx.x + k * blockDim.x, W);
    const float w1 = expf(nmin(lr, 0.f)), w2 = expf(-nmax(lr, 0.f));
    const int s1 = xd - xm1 - 1;
    const int s2 = d >= 2 ? xd - xm2 - 1 : W + 5;
    tmax = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = threadIdx.x + k * blockDim.x;
      const int il = o + s1, im = o + s2;
      // gapX from (x-1, y), match from (x-1, y-1), gapY from (x, y-1)
      const float gx = (rdn(p1, MATCH, il, W, sc1) * (tr[T_MX] * w1)
                        + rdn(p1, GAP_X, il, W, sc1) * (tr[T_XX] * w1)) *
                       e[k].gapx;
      const float mm = ((rdn(p2, MATCH, im, W, sc2) * tr[T_MM]
                         + rdn(p2, GAP_X, im, W, sc2) * tr[T_XM]
                         + rdn(p2, GAP_Y, im, W, sc2) * tr[T_YM]) * w2) *
                       e[k].match;
      const float gy = (rdn(p1, MATCH, il + 1, W, sc1) * (tr[T_MY] * w1)
                        + rdn(p1, GAP_Y, il + 1, W, sc1) * (tr[T_YY] * w1)) *
                       e[k].stay;
      const bool inb = o < W && o < wd;
      vm[k] = inb ? mm : 0.f;
      vx[k] = inb ? gx : 0.f;
      vy[k] = inb ? gy : 0.f;
      if (o < W) {
        cur[MATCH * W + o] = vm[k];
        cur[GAP_X * W + o] = vx[k];
        cur[GAP_Y * W + o] = vy[k];
      }
      tmax = nmax(tmax, nmax(vm[k], nmax(vx[k], vy[k])));
    }
    tmax = warp_nmax(tmax);
    if (nw > 1 && lane == 0) part[(d & 1) * 32 + warp] = tmax;
    xm2 = xm1;
    xm1 = xd;
    xd = xn;
    wd = wn;
    xn = xnn;
  }
  close(nd);
  const float l =
      block_prob_lse(ring + (nd % 3) * 3 * W, sc1, pr.end, W, part);
  if (threadIdx.x == 0) lse_f[b] = l;
}

// ----------------------------------------------- backward + compaction

// The survivor slots of one diagonal from its per-warp counts wc[32] and
// this thread's rank inside its warp (-1 for none), ranked in band-offset
// order: warp, then lane. Each warp forms the count of the warps before
// it and the diagonal's total with one integer reduction each: no branch
// and no loop over the warps.
__device__ __forceinline__ void write_slots(const int* wc, int rk, float pk,
                                            int* so, float* sv, int* cn,
                                            int R, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane < nw ? wc[lane] : 0;
  const int r = __reduce_add_sync(0xffffffffu, lane < warp ? c : 0) + rk;
  if (rk >= 0 && r < R) {
    so[r] = threadIdx.x;
    sv[r] = pk;
  }
  const int total = __reduce_add_sync(0xffffffffu, c);
  if (threadIdx.x == 0) *cn = total;
}

// As the forward, from barrier to barrier: after barrier d+1, diagonal
// d+1's max, frame and posterior (its ballot and warp counts), and the
// survivor slots of d+2, whose counts that barrier published; then
// diagonal d's emissions from the inputs loaded during d+1, the loads of
// d-1 (inputs, forward match row, cvecf), and d's cells.
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
  float* ring = smem;                               // [3 slots][3 states][W]
  float* part = smem + 9 * W;                       // [2 parities][32]
  int* wcnt = reinterpret_cast<int*>(part + 64);    // [2 parities][32]
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, ev_, meta_, cexp_, evb_, par_, D1, LX, LE);
  for (int i = threadIdx.x; i < 9 * W; i += blockDim.x) ring[i] = 0.f;
  __syncthreads();

  const int b = blockIdx.x;
  const int o = threadIdx.x;       // this thread's band offset
  const float* fs = fstack + (size_t)b * D1 * W;
  const double* cv = cvecf + (size_t)b * D1;
  float* inc = b_incr + (size_t)b * D1;
  int* so = slot_cell + (size_t)b * D1 * R;
  float* sv = slot_val + (size_t)b * D1 * R;
  int* cn = cnt + (size_t)b * D1;
  const int nd = pr.nd, last = D1 - 1;
  for (int d = nd + 1 + o; d < D1; d += blockDim.x) {
    inc[d] = 0.f;
    cn[d] = 0;
  }
  const int lane = o & 31, warp = o >> 5;
  const int nw = blockDim.x >> 5;
  const float* tr = pr.t;
  const int oc = min(o, W - 1);    // a column inside the rows

  // diagonal nd: the end states in the band; this thread's raw match
  // state of the diagonal in hand, and its forward match row for the
  // posterior
  const int wnd = pr.width[nd];
  const bool inb0 = o < W && o < wnd;
  float bm = inb0 ? pr.end[MATCH] * SCALE : 0.f;
  const float bx0 = inb0 ? pr.end[GAP_X] * SCALE : 0.f;
  const float by0 = inb0 ? pr.end[GAP_Y] * SCALE : 0.f;
  if (o < W) {
    float* cur0 = ring + (nd % 3) * 3 * W;
    cur0[MATCH * W + o] = bm;
    cur0[GAP_X * W + o] = bx0;
    cur0[GAP_Y * W + o] = by0;
  }
  float fpost = __ldg(fs + (size_t)nd * W + oc);
  float tmax = warp_nmax(nmax(bm, nmax(bx0, by0)));
  if (nw > 1 && lane == 0) part[(nd & 1) * 32 + warp] = tmax;
  // band origins of d+2, d+1 (with its width), d (with its width) and
  // d-1, each loaded two diagonals ahead; d's emission inputs, forward
  // match row and cvecf one ahead
  int xp2 = pr.x0[min(nd + 1, last)], xp1 = pr.x0[nd], wp1 = wnd;
  int xd = pr.x0[max(nd - 1, 0)], wd = pr.width[max(nd - 1, 0)];
  int xn = pr.x0[max(nd - 2, 0)];
  BwdLoad in = bwd_load(pr, nd - 1, xd, o, W);
  float fnext = __ldg(fs + (size_t)max(nd - 1, 0) * W + oc);
  double cv_1 = cv[nd], cv_d = cv[max(nd - 1, 0)];   // cvecf of d+1 and d
  float sc1 = 0.f, sc2 = 0.f;   // 1/m of diagonals d+1 and d+2
  float lr = 0.f;    // log(FRAME(d+1) / FRAME(d+2))
  double bo = 0.0;   // running backward offset: Bo(d) = sum of lr over >= d
  // this thread's survivor of the diagonal closed last: value and rank
  // inside its warp (-1 for none), written once the next barrier has
  // published the warp counts
  float pk = 0.f;
  int rk = -1;

  // after barrier dd: diagonal dd's max, frame and posterior, and the
  // survivor slots of dd+1
  auto close = [&](int dd, int xdd, int wdd) {
    const float mx = diag_barrier_max(tmax, part, dd & 1, nw);
    const float m = dd == nd ? SCALE : (mx > 0.f ? mx : SCALE);
    const float sc = 1.f / m;
    lr = nmax(-lr, 0.f) + (logf(m) - LOG_SCALE);
    bo += (double)lr;                                    // Bo(dd)
    // absolute log posterior = fm + bmn + cvecf[dd] + Bo(dd)
    const float cd = (float)(cv_1 + bo);
    if (dd < nd)
      write_slots(wcnt + ((dd + 1) & 1) * 32, rk, pk,
                  so + (size_t)(dd + 1) * R, sv + (size_t)(dd + 1) * R,
                  cn + dd + 1, R, nw);
    const int x = xdd + o, y = dd - x;
    const float bmn = nmax(logf((bm * sc) * SCALE) - LOG_SCALE, NEG);
    pk = expf(nmax(fpost + bmn + cd, NEG));
    const bool surv = o < W && o < wdd && x > 0 && y > 0 && x <= pr.lX &&
                      y <= pr.lY && pk >= threshold;
    const unsigned ball = __ballot_sync(0xffffffffu, surv);
    if (lane == 0) wcnt[(dd & 1) * 32 + warp] = __popc(ball);
    rk = surv ? __popc(ball & ((1u << lane) - 1u)) : -1;
    if (o == 0) inc[dd] = lr;
    sc2 = sc1;
    sc1 = sc;
  };

  for (int d = nd - 1; d >= 0; --d) {
    close(d + 1, xp1, wp1);
    const float* b1 = ring + ((d + 1) % 3) * 3 * W;   // diagonal d+1
    const float* b2 = ring + ((d + 2) % 3) * 3 * W;   // diagonal d+2
    float* cur = ring + (d % 3) * 3 * W;
    const Emis e = bwd_emis(pr, in);
    fpost = fnext;
    cv_1 = cv_d;
    // the loads of d-1 and the band of d-2
    const int xnn = pr.x0[max(d - 2, 0)], wn = pr.width[max(d - 1, 0)];
    cv_d = cv[max(d - 1, 0)];
    in = bwd_load(pr, d - 1, xn, o, W);
    fnext = __ldg(fs + (size_t)max(d - 1, 0) * W + oc);
    const float w1 = expf(nmin(lr, 0.f)), w2 = expf(-nmax(lr, 0.f));
    const int u1 = xd - xp1;
    const int u2 = d + 2 < D1 ? xd + 1 - xp2 : W + 5;
    const float gx_red = (rdn(b1, GAP_X, o + u1 + 1, W, sc1) * w1) * e.gapx;
    const float mm_red = (rdn(b2, MATCH, o + u2, W, sc2) * w2) * e.match;
    const float gy_term = (rdn(b1, GAP_Y, o + u1, W, sc1) * w1) * e.stay;
    const bool inb = o < W && o < wd;
    bm = inb ? gx_red * tr[T_MX] + mm_red * tr[T_MM] + gy_term * tr[T_MY]
             : 0.f;
    const float bx = inb ? gx_red * tr[T_XX] + mm_red * tr[T_XM] : 0.f;
    const float by = inb ? mm_red * tr[T_YM] + gy_term * tr[T_YY] : 0.f;
    if (o < W) {
      cur[MATCH * W + o] = bm;
      cur[GAP_X * W + o] = bx;
      cur[GAP_Y * W + o] = by;
    }
    tmax = warp_nmax(nmax(bm, nmax(bx, by)));
    if (nw > 1 && lane == 0) part[(d & 1) * 32 + warp] = tmax;
    xp2 = xp1;
    xp1 = xd;
    wp1 = wd;
    xd = xn;
    wd = wn;
    xn = xnn;
  }
  close(0, xp1, wp1);
  // publish diagonal 0's warp counts, then its survivor slots
  __syncthreads();
  write_slots(wcnt, rk, pk, so, sv, cn, R, nw);
  const float l = block_prob_lse(ring, sc1, pr.start, W, part);  // d = 0
  if (o == 0) lse_b[b] = l;
}

// One band offset a thread. Two a thread (half the warps, so a cheaper
// max) measured 26% (W = 256) and 5% (W = 512) slower forward, 20% and
// 9% slower backward on an H100 (PERF.md §6).
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
  const size_t smem = (9 * (size_t)W + 64) * sizeof(float);
  sa_fwd_sweep_prob_kernel<1>
      <<<B, threads_for(W), smem, (cudaStream_t)stream>>>(
          x0, width, ref, ev, meta, cexp, evb, par, fstack, f_incr, lse_f, D1,
          W, LX, LE);
  return (int)cudaGetLastError();
}

extern "C" int sa_bwd_sweep_compact_prob(
    const int* x0, const int* width, const float* ref, const float* ev,
    const int* meta, const float* cexp, const float* evb, const float* par,
    const float* fstack, const double* cvecf, float* b_incr, float* lse_b,
    int* slot_cell, float* slot_val, int* cnt, int B, int D1, int W, int LX,
    int LE, int R, float threshold, void* stream) {
  if (W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (9 * (size_t)W + 64) * sizeof(float) + 64 * sizeof(int);
  sa_bwd_sweep_compact_prob_kernel
      <<<B, threads_for(W), smem, (cudaStream_t)stream>>>(
          x0, width, ref, ev, meta, cexp, evb, par, fstack, cvecf, b_incr,
          lse_b, slot_cell, slot_val, cnt, D1, W, LX, LE, R, threshold);
  return (int)cudaGetLastError();
}
