// Hand-written Hopper kernels for the banded forward-backward of
// signalalign_tpu_torch: MODE_MEAN_ONLY Gaussian or MODE_HDP spline
// emissions, 1 <= P <= 8 paths per cell (degenerate reference positions
// expand into paths).
//
// sa_fwd_sweep replaces the TPU forward kernels
//   signalalign_tpu/ops/banded_fb_pallas.py        _fwd_kernel      (pallas_forward, P=1)
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _fwd_kernel_log  (pallas_forward_b, PP=1 and PP>1,
//                                                                    estream)
// sa_bwd_sweep_compact replaces the TPU backward and compaction kernels
//   signalalign_tpu/ops/banded_fb_pallas.py        _bwd_kernel      (fuse_post, P=1)
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _bwd_kernel_log  (fuse_post + fuse_compact PP=1,
//                                                                    fuse_post PP>1, estream)
//   signalalign_tpu/ops/banded_fb_pallas_batch.py  _compact_map_kernel (PP>1 survivors)
// and, in their HDP instances (template flag HDP), the HDP emission
// stream the TPU sweeps read:
//   signalalign_tpu/ops/emission_stream.py  _spline_eval_banked_kernel (banked table DMA)
//   signalalign_tpu/ops/emission_stream.py  _spline_eval_fused_kernel  (per-tile windows)
// Both keep the output contract of the plain DP in
// signalalign_tpu_torch/ops/banded_fb.py (sweep_forward / sweep_backward):
// max-normalised diagonals plus per-diagonal offset increments. They do
// not copy the TPU layout (x-frame lanes, 128-lane stripes, paths in
// lanes with lane rolls and legality planes, ring re-basing, TwoSum
// scans): cell (d, p, o) is x = x0[d] + o, y = d - x on path p; a block
// holds all P paths of a problem, legality is one 64-bit word per
// reference position (bit p_to*8 + q_from), and the backward offset is a
// plain double.
//
// What bounds them on this card: the serial chain of anti-diagonals. A
// diagonal depends on the two before it, so one problem is one block that
// walks its own n_diag diagonals in order, with two block barriers per
// diagonal (one inside the max reduction, one before the next diagonal
// reads the ring). At P = 1 the work per diagonal is small (W cells, ~9
// transcendentals each), so the barrier latency, not device-memory
// bandwidth or arithmetic, sets the time of one problem; throughput comes
// from many problems in flight (one block each). At P > 2 each cell adds
// two logsumexps over its legal paths (an exponential per legal path
// pair, a logarithm per logsumexp) and, forward, the three logaddexp
// terms its successors read.
//
// What the design does about it: the two live diagonals of all three
// states sit in a shared-memory ring (6 P W floats, 192 KB at P*W = 8192);
// each thread keeps its K <= 8 cells of the new diagonal in registers
// until the max reduction's barrier has passed (every read of the ring is
// done by then) and only then overwrites the oldest diagonal. Emissions
// are computed inline from the per-position tables (no emission stack in
// device memory) and each block stops at its own n_diag. The backward
// kernel folds the posterior, the threshold and the survivor compaction
// into the sweep (a warp ballot + per-warp counts published by the
// diagonal's second barrier), so no posterior stack is ever written.
//
// The P > 2 instances (template flag PATHS) compute every term that does
// not depend on the path at the other end of a transition once per cell,
// not once per (source, target) pair. The forward's ring holds, in place
// of a cell's three states, the three terms later diagonals read from it
// (src_terms: gapX and gapY of d+1, match of d+2 before its m_prev), so a
// target cell's logsumexp over its source paths reads the legal ones'
// terms from shared memory, with no logaddexp inside; reads outside the
// window take the terms of NEG states, computed once per block, and the
// end logsumexp takes the last diagonal's states from registers. The backward first writes each
// cell's target terms (gapX TO and match TO on its own path, with the
// match-to emission, the HDP spline among them) into the two planes of
// the oldest ring slot that are dead at that step, then, after one more
// barrier (a warp's when P divides 32: an offset's P cells are then in
// one warp), reduces each source cell over the legal targets from there.
// Every operation and its order are those of the twin's, so the results
// stay equal bit for bit. P = 1 and 2 keep the per-pair instances: at two
// paths a block of at most 16 warps waits on latency, and the terms'
// nested logaddexp behind the max barrier and the backward's extra stage
// measured up to 17% slower there (PERF.md §6); EXPECT is unchanged.
//
// HDP emissions (log((1/var) * Hermite spline of the descaled mean) over
// the k-mer's density/slope rows on a uniform grid, hdp_log_emission
// below) are computed inline too, where the sweeps need them: no
// (diagonal, cell, path) emission stack is written or read, and no extra
// launch runs. The TPU wrote that stack, with banked table DMA, select
// trees and `ebnd` boundary rows, only because Mosaic has no gather
// (emission_stream.py:1-29); here each spline is four loads from the
// k-mer's table rows in device memory (two density, two slope values at
// the interval's knots). What bounds the HDP instances is still the
// serial diagonal chain, now lengthened by that gather chain: the tables
// (2 x 224 MB at 46,656 k-mers x 1,200 points) do not fit the 50 MB L2,
// but within a block the k-mer row is fixed per (position, path) and
// neighbouring diagonals read nearby knots, so the loads mostly hit L1/L2.
// The backward evaluates the match-to emission once per legal (source,
// target) path pair (up to P^2 per offset); illegal pairs skip it. The
// Gaussian instances compile without any of it (if constexpr), to the
// code of the Gaussian-only kernels.
//
// The EM expectation pass (template flag EXPECT, P = 1 only, K in {1, 2})
// replaces the `expect` mode of _fwd_kernel_log / _bwd_kernel_log: the
// forward writes all three normalised states of each diagonal (fstack
// (B, D1, 3, W)); the backward, at each FROM diagonal d < n_diag, already
// holds the to-cell reductions gx_red, mm_red and gy_term of every cell,
// so it adds the seven transition posteriors exp(f_s + t + red + normA),
// normA = cvecf[d] + Bo(d+1), into per-thread double sums (one block
// reduction at the end, in a fixed order: texp (B, 7)), and in the
// Gaussian instance the into-match posterior's moments [p, p dx, p dx^2],
// dx = (event mean - m_hat(x+1)) / var, into kx[b, :, x+1] in device
// memory (double). A position has one writer per diagonal and the
// diagonal's barriers order successive writers, so kx needs no atomics and
// its sums are deterministic. The HDP instance accumulates texp only (the
// TPU kernel's contract: HDP emissions train from assignments, not
// Gaussian moments). The non-expect instances compile without any of it
// (if constexpr).
//
// Numerics: float32 values with precise expf/logf/log1pf (no fast math),
// built with --fmad=false so each operation rounds as in the plain twin,
// the logaddexp formulation of torch.logaddexp and the twin's legal
// logsumexp over paths (max, then exp-sum in path order); the backward
// running offset and the forward normaliser stream cvecf are float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
// state indices, transition slots (signalalign_tpu/models/pore_model.py)
constexpr int MATCH = 0, GAP_X = 1, GAP_Y = 2;
constexpr int T_MM = 0, T_MX = 1, T_MY = 2, T_XM = 3, T_XX = 4, T_YM = 6,
              T_YY = 8;
// ProblemTensors layout (signalalign_tpu_torch/ops/banded_fb.py)
constexpr int NREF = 5, NEV = 2, NMETA = 8, NPACK = 17;
constexpr int M_LX = 0, M_LY = 1, M_NDIAG = 2, M_EVPAD = 3, M_REFLEN = 4,
              M_EVLEN = 5;
constexpr int PACK_TRANS = 0, PACK_START = 9, PACK_END = 12, PACK_GAPX = 15,
              PACK_VAR = 16;
constexpr int MAX_P = 8;                        // legality: 8 bits per path
constexpr int PAIR_P = 2;   // the per-pair instances' paths (P > 2: PATHS)
constexpr int MAX_THREADS = 1024;
constexpr int MAX_K = 8;                        // cells per thread
constexpr int MAX_CELLS = MAX_K * MAX_THREADS;  // P * W

__device__ __forceinline__ float lae(float a, float b) {
  float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// logsumexp of v[0..P), P <= PAIR_P (entries an illegal transition
// masked to NEG): the max, then the exp-sum in path order, as the twin's
// _legal_reduce. At P = 1 it returns v[0] bit for bit (expf(0) = 1,
// logf(1) = 0), but its expf/logf cost 12-18% of a P = 1 sweep (H100,
// 700 W), so the callers skip it there.
__device__ __forceinline__ float legal_lse(const float* v, int P) {
  float mx = v[0];
#pragma unroll
  for (int q = 1; q < PAIR_P; ++q)
    if (q < P) mx = fmaxf(mx, v[q]);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < PAIR_P; ++q)
    if (q < P) s += expf(v[q] - mx);
  return mx + logf(fmaxf(s, 1e-37f));
}

// logsumexp over the paths j < P of v(j) = row[j] - sub (fill - sub for
// every j where row is null: a read outside the band window), NEG where
// bit j of lb is clear: legal_lse's result bit for bit, from the legal
// paths alone (the P > 2 instances; values read from shared memory). An
// illegal path's NEG keeps the max at NEG or above and adds expf(NEG -
// mx) to the sum: exactly 0 when mx > NEG (the next float above NEG is
// 2^76 away), so it is skipped; when mx == NEG every term is 0 or 1 and
// the result NEG + logf(s) rounds to NEG for any s in [1, 8]. The legal
// paths add in path order, as in the twin, and a warp runs each loop as
// often as its lane with the most legal paths (one or two, mostly).
__device__ __forceinline__ float legal_lse_row(const float* row, float fill,
                                               float sub, unsigned lb, int P) {
  auto v = [&](unsigned m) {   // the value of the lowest path left in m
    return (row ? row[__ffs(m) - 1] : fill) - sub;
  };
  float mx = __popc(lb) == P ? -INFINITY : NEG;
  for (unsigned m = lb; m; m &= m - 1) mx = fmaxf(mx, v(m));
  if (mx == NEG) return NEG;
  float s = 0.f;
  for (unsigned m = lb; m; m &= m - 1) s += expf(v(m) - mx);
  return mx + logf(fmaxf(s, 1e-37f));
}

// The terms a forward cell with normalised states (m, x, y) gives the
// diagonals after it, whatever their path (the P > 2 forward keeps these
// in its ring in place of the states): gapX of d+1 from (x-1, y), gapY of
// d+1 from (x, y-1) and match of d+2 from (x-1, y-1) before that
// diagonal's m_prev, in the twin's order of operations.
constexpr int SRC_X = 0, SRC_Y = 1, SRC_M = 2;   // planes of that ring
struct SrcTerms {
  float x, y, m;
};
__device__ __forceinline__ SrcTerms src_terms(float m, float x, float y,
                                              const float* t) {
  return {lae(m + t[T_MX], x + t[T_XX]), lae(m + t[T_MY], y + t[T_YY]),
          lae(lae(m + t[T_MM], x + t[T_XM]), y + t[T_YM])};
}

// HDP tables of a bucket: per-(problem, path, position) k-mer ids and
// unscaled level means (the layout of the ref rows), and the (nk, ng)
// density and slope tables on the grid g0 + i * dx, i < ng (gN = its last
// knot). All pointers are null for a Gaussian bucket.
struct HdpTab {
  const int* kid;        // (B, P, LX)
  const float* mu;       // (B, P, LX)
  const float* dens;     // (nk, ng)
  const float* slopes;   // (nk, ng)
  int nk, ng;
  float g0, dx, gN;
};

// log((1/var) * spline density of k-mer k at x), NEG where it is 0: the
// plain twin's hdp_log_emission (and the JAX hdp_spline_density) with the
// interval index floor((x - g0) / dx) clamped to [0, ng - 2], linear
// extension past either end of the grid and the negative clamp. Every
// load index is inside the tables whatever x and k are.
__device__ __forceinline__ float hdp_log_emission(float x, int k, float var,
                                                  const HdpTab& h) {
  const size_t row = (size_t)clampi(k, 0, h.nk - 1) * h.ng;
  float v;
  if (x <= h.g0) {
    v = __ldg(h.dens + row) - __ldg(h.slopes + row) * (h.g0 - x);
  } else if (x >= h.gN) {
    const size_t e = row + h.ng - 1;
    v = __ldg(h.dens + e) + __ldg(h.slopes + e) * (x - h.gN);
  } else {
    const float il = fminf(fmaxf(floorf((x - h.g0) / h.dx), 0.f),
                           (float)(h.ng - 2));
    const size_t i = row + (size_t)il;
    const float yl = __ldg(h.dens + i), yr = __ldg(h.dens + i + 1);
    const float sl = __ldg(h.slopes + i), sr = __ldg(h.slopes + i + 1);
    const float dy = yr - yl;
    const float a = sl * h.dx - dy;
    const float b = dy - sr * h.dx;
    const float tl = (x - (h.g0 + il * h.dx)) / h.dx;
    const float tr = 1.f - tl;
    v = tr * yl + tl * yr + tl * tr * (a * tr + b * tl);
  }
  v = fmaxf(v, 0.f) / var;
  return v > 0.f ? logf(fmaxf(v, 1e-37f)) : NEG;
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

// logsumexp over the 3 states x N cells of a normalised ring slot,
// weighted by logs[3] (torch.logsumexp of clamp(cur + logs, NEG)).
__device__ float block_lse(const float* slot, const float* logs, int N,
                           float* part) {
  float mx = NEG;
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    for (int s = 0; s < 3; ++s)
      mx = fmaxf(mx, fmaxf(slot[s * N + c] + logs[s], NEG));
  __syncthreads();
  mx = block_reduce<false>(mx, part);
  float sm = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    for (int s = 0; s < 3; ++s)
      sm += expf(fmaxf(slot[s * N + c] + logs[s], NEG) - mx);
  __syncthreads();
  sm = block_reduce<true>(sm, part);
  return logf(sm) + mx;
}

// block_lse over the three states of this thread's K cells (cell c =
// threadIdx.x + k * blockDim.x) held in registers, in block_lse's order
template <int K>
__device__ float block_lse_cells(const float (&vm)[K], const float (&vx)[K],
                                 const float (&vy)[K], const float* logs,
                                 int N, float* part) {
  float mx = NEG;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (threadIdx.x + k * blockDim.x < N) {
      mx = fmaxf(mx, fmaxf(vm[k] + logs[0], NEG));
      mx = fmaxf(mx, fmaxf(vx[k] + logs[1], NEG));
      mx = fmaxf(mx, fmaxf(vy[k] + logs[2], NEG));
    }
  __syncthreads();
  mx = block_reduce<false>(mx, part);
  float sm = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (threadIdx.x + k * blockDim.x < N) {
      sm += expf(fmaxf(vm[k] + logs[0], NEG) - mx);
      sm += expf(fmaxf(vx[k] + logs[1], NEG) - mx);
      sm += expf(fmaxf(vy[k] + logs[2], NEG) - mx);
    }
  __syncthreads();
  sm = block_reduce<true>(sm, part);
  return logf(sm) + mx;
}

struct Problem {
  const int* x0;
  const int* width;
  const float* ref;                 // (NREF, P, LX)
  const unsigned long long* leg;    // (LX,) legality words
  const float* ev;                  // (NEV, LE)
  int lX, lY, nd, efp, reflen, evlen, P, LX, LE;
  float t[9], start[3], end[3], gapx;
  // HDP buckets only
  const int* kid;                   // (P, LX) k-mer ids
  const float* mu;                  // (P, LX) level means
  float var;

  __device__ void load(const int* x0_, const int* width_, const float* ref_,
                       const unsigned long long* leg_, const float* ev_,
                       const int* meta_, const float* par_, const HdpTab& h,
                       int D1, int P_, int LX_, int LE_) {
    const int b = blockIdx.x;
    x0 = x0_ + (size_t)b * D1;
    width = width_ + (size_t)b * D1;
    ref = ref_ + (size_t)b * NREF * P_ * LX_;
    kid = h.kid ? h.kid + (size_t)b * P_ * LX_ : nullptr;
    mu = h.mu ? h.mu + (size_t)b * P_ * LX_ : nullptr;
    leg = leg_ + (size_t)b * LX_;
    ev = ev_ + (size_t)b * NEV * LE_;
    P = P_;
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
    var = par[PACK_VAR];
  }

  // reference row r of path p at column x
  __device__ __forceinline__ float rf(int r, int p, int x) const {
    return ref[((size_t)r * P + p) * LX + x];
  }

  // HDP log emission of path p at column x for an event of mean ev_mean:
  // descaled mean mu + (ev_mean - m_hat) / var (the XLA formula)
  __device__ __forceinline__ float hdp(int p, int x, float m_hat,
                                       float ev_mean, const HdpTab& h) const {
    const size_t i = (size_t)p * LX + x;
    return hdp_log_emission(mu[i] + (ev_mean - m_hat) / var, kid[i], var, h);
  }
};

// state s of band offset i on path p of a ring slot; NEG outside the band
__device__ __forceinline__ float rd(const float* slot, int s, int i, int p,
                                    int W, int N, int P) {
  return (i >= 0 && i < W) ? slot[s * N + i * P + p] : NEG;
}

// ---------------------------------------------------------------- forward

template <int K, bool HDP, bool EXPECT, bool PATHS>
__global__ void __launch_bounds__(MAX_THREADS) sa_fwd_sweep_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_,
    const unsigned long long* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, int D1, int W, int P_, int LX, int LE) {
  extern __shared__ float smem[];
  const int N = P_ * W;
  // [2 slots][3 states][N], cell o*P + p; PATHS: [2 slots][3 source
  // terms SRC_X, SRC_Y, SRC_M][N]
  float* ring = smem;
  float* part = smem + 6 * N;      // [32] reduction partials
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE);
  // PATHS: the terms of a cell whose states are NEG: every cell outside
  // the band, and every read outside the window
  SrcTerms neg{NEG, NEG, NEG};
  if constexpr (PATHS) {
    neg = src_terms(NEG, NEG, NEG,
                    par_ + (size_t)blockIdx.x * NPACK + PACK_TRANS);
    for (int i = threadIdx.x; i < 6 * N; i += blockDim.x) {
      const int pl = (i / N) % 3;
      ring[i] = pl == SRC_X ? neg.x : pl == SRC_Y ? neg.y : neg.m;
    }
  } else {
    for (int i = threadIdx.x; i < 6 * N; i += blockDim.x) ring[i] = NEG;
  }
  __syncthreads();

  const int b = blockIdx.x;
  const int P = pr.P;
  // (D1, P, W); EXPECT: (D1, 3, P, W)
  float* fs = fstack + (size_t)b * D1 * N * (EXPECT ? 3 : 1);
  float* inc = f_incr + (size_t)b * D1;
  const int nd = pr.nd;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;

  // diagonal 0: the single start cell (0, 0) on path 0, in slot 0
  if (threadIdx.x == 0) {
    if constexpr (PATHS) {
      const SrcTerms st = src_terms(pr.start[MATCH], pr.start[GAP_X],
                                    pr.start[GAP_Y], pr.t);
      ring[SRC_X * N] = st.x;
      ring[SRC_Y * N] = st.y;
      ring[SRC_M * N] = st.m;
    } else {
      for (int s = 0; s < 3; ++s) ring[s * N] = pr.start[s];
    }
    inc[0] = 0.f;
  }
  if constexpr (EXPECT) {
    for (int c = threadIdx.x; c < 3 * N; c += blockDim.x)
      fs[c] = c % N == 0 ? pr.start[c / N] : NEG;
  } else {
    for (int c = threadIdx.x; c < N; c += blockDim.x)
      fs[c] = c == 0 ? pr.start[MATCH] : NEG;
  }
  __syncthreads();

  const float* tr = pr.t;
  float m_prev = 0.f;
  // this thread's cells of the diagonal in hand; PATHS: after the loop,
  // the normalised states of diagonal nd (the ring holds terms)
  float vm[K], vx[K], vy[K];
  if constexpr (PATHS) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool c0 = threadIdx.x + k * blockDim.x == 0;
      vm[k] = c0 ? pr.start[MATCH] : NEG;
      vx[k] = c0 ? pr.start[GAP_X] : NEG;
      vy[k] = c0 ? pr.start[GAP_Y] : NEG;
    }
  }
  for (int d = 1; d <= nd; ++d) {
    float* cur = ring + (d & 1) * 3 * N;        // holds d-2 until written
    const float* p1 = ring + ((d - 1) & 1) * 3 * N;
    const float* p2 = cur;
    const int xd = pr.x0[d];
    const int wd = pr.width[d];
    const int s1 = xd - pr.x0[d - 1] - 1;
    const int s2 = d >= 2 ? xd - pr.x0[d - 2] - 1 : W + 5;
    const int rs = clampi(xd, 0, pr.reflen - W);
    const int es = clampi(pr.lY - d + xd + pr.efp, 0, pr.evlen - W);

    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      float mm = NEG, gx = NEG, gy = NEG;
      const int o = c / P, p = c - o * P;
      if (c < N && o < wd) {
        const int xr = rs + o, je = es + o;
        bool kvalid;
        unsigned lb;
        float e_match, e_stay;
        if constexpr (HDP) {
          const float m_hat = pr.rf(0, p, xr), inv_m = pr.rf(1, p, xr);
          const float ev_mean = pr.ev[je];
          kvalid = inv_m > 0.f;
          const bool ok = kvalid && pr.ev[pr.LE + je] > 0.5f;
          lb = (unsigned)(pr.leg[xr] >> (p * MAX_P)) & 0xffu;
          // stay = match (emissions_signal_getHdpKmerDensity)
          e_match = e_stay = ok ? pr.hdp(p, xr, m_hat, ev_mean, h) : NEG;
        } else {
          const float m_hat = pr.rf(0, p, xr), inv_m = pr.rf(1, p, xr),
                      c_m = pr.rf(2, p, xr), inv_y = pr.rf(3, p, xr),
                      c_y = pr.rf(4, p, xr);
          const float ev_mean = pr.ev[je];
          kvalid = inv_m > 0.f;
          const bool ok = kvalid && pr.ev[pr.LE + je] > 0.5f;
          lb = (unsigned)(pr.leg[xr] >> (p * MAX_P)) & 0xffu;
          const float am = (ev_mean - m_hat) * inv_m;
          const float ay = (ev_mean - m_hat) * inv_y;
          e_match = ok ? c_m - 0.5f * am * am : NEG;
          e_stay = ok ? c_y - 0.5f * ay * ay : NEG;
        }
        const float e_gapx = kvalid ? pr.gapx : NEG;

        // gapX from (x-1, y) and match from (x-1, y-1), over the legal
        // source paths q
        const int il = o + s1, im = o + s2;
        if constexpr (PATHS) {
          // one pass over the terms the source cells wrote
          const float* rx = il >= 0 && il < W ? p1 + SRC_X * N + il * P
                                              : nullptr;
          const float* rm = im >= 0 && im < W ? p2 + SRC_M * N + im * P
                                              : nullptr;
          gx = legal_lse_row(rx, neg.x, 0.f, lb, P) + e_gapx;
          mm = legal_lse_row(rm, neg.m, m_prev, lb, P) + e_match;
          // gapY from (x, y-1), same path
          const int iy = il + 1;
          gy = (iy >= 0 && iy < W ? p1[SRC_Y * N + iy * P + p] : neg.y) +
               e_stay;
        } else {
          float srx[PAIR_P], srm[PAIR_P];
#pragma unroll
          for (int q = 0; q < PAIR_P; ++q) {
            if (q < P) {
              const bool leg = (lb >> q) & 1u;
              const float sx = lae(rd(p1, MATCH, il, q, W, N, P) + tr[T_MX],
                                   rd(p1, GAP_X, il, q, W, N, P) + tr[T_XX]);
              const float sm =
                  lae(lae(rd(p2, MATCH, im, q, W, N, P) + tr[T_MM],
                          rd(p2, GAP_X, im, q, W, N, P) + tr[T_XM]),
                      rd(p2, GAP_Y, im, q, W, N, P) + tr[T_YM]) - m_prev;
              srx[q] = leg ? sx : NEG;
              srm[q] = leg ? sm : NEG;
            }
          }
          gx = (P == 1 ? srx[0] : legal_lse(srx, P)) + e_gapx;
          mm = (P == 1 ? srm[0] : legal_lse(srm, P)) + e_match;
          // gapY from (x, y-1), same path
          gy = lae(rd(p1, MATCH, il + 1, p, W, N, P) + tr[T_MY],
                   rd(p1, GAP_Y, il + 1, p, W, N, P) + tr[T_YY]) + e_stay;
        }
      }
      vm[k] = mm;
      vx[k] = gx;
      vy[k] = gy;
      tmax = fmaxf(tmax, fmaxf(mm, fmaxf(gx, gy)));
    }
    // its barrier also ends every read of diagonal d-2 in `cur`
    float m = block_reduce<false>(tmax, part);
    m = m > NEG * 0.5f ? m : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < N) {
        const int o = c / P, p = c - o * P;
        const float mm = fmaxf(vm[k] - m, NEG);
        const float gx = fmaxf(vx[k] - m, NEG);
        const float gy = fmaxf(vy[k] - m, NEG);
        if constexpr (PATHS) {
          const SrcTerms st = src_terms(mm, gx, gy, tr);
          cur[SRC_X * N + c] = st.x;
          cur[SRC_Y * N + c] = st.y;
          cur[SRC_M * N + c] = st.m;
          vm[k] = mm;
          vx[k] = gx;
          vy[k] = gy;
        } else {
          cur[MATCH * N + c] = mm;
          cur[GAP_X * N + c] = gx;
          cur[GAP_Y * N + c] = gy;
        }
        if constexpr (EXPECT) {
          float* fd = fs + (size_t)d * 3 * N + p * W + o;
          fd[MATCH * N] = mm;
          fd[GAP_X * N] = gx;
          fd[GAP_Y * N] = gy;
        } else {
          fs[(size_t)d * N + p * W + o] = mm;
        }
      }
    }
    if (threadIdx.x == 0) inc[d] = m;
    m_prev = m;
    __syncthreads();
  }
  float l;
  if constexpr (PATHS) l = block_lse_cells<K>(vm, vx, vy, pr.end, N, part);
  else l = block_lse(ring + (nd & 1) * 3 * N, pr.end, N, part);
  if (threadIdx.x == 0) lse_f[b] = l;
}


// ----------------------------------------------- backward + compaction

template <int K, bool HDP, bool EXPECT, bool PATHS>
__global__ void __launch_bounds__(MAX_THREADS) sa_bwd_sweep_compact_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_,
    const unsigned long long* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    const float* __restrict__ fstack,
    const double* __restrict__ cvecf, float* __restrict__ b_incr,
    float* __restrict__ lse_b, int* __restrict__ slot_cell,
    float* __restrict__ slot_val, int* __restrict__ cnt,
    double* __restrict__ texp, double* __restrict__ kx, int D1, int W,
    int P_, int LX, int LE, int R, float threshold) {
  extern __shared__ float smem[];
  const int N = P_ * W;
  float* ring = smem;                               // [2 slots][3 states][N]
  float* part = smem + 6 * N;                       // [32] reduction partials
  int* wcnt = reinterpret_cast<int*>(part + 32);    // [K][32] survivors
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE);
  for (int i = threadIdx.x; i < 6 * N; i += blockDim.x) ring[i] = NEG;
  __syncthreads();

  const int b = blockIdx.x;
  const int P = pr.P;
  const float* fs = fstack + (size_t)b * D1 * N * (EXPECT ? 3 : 1);
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
  float m_prev = 0.f;
  double bo = 0.0;   // running backward offset: Bo(d) = sum of m over >= d
  // EXPECT: this thread's sums of the seven transition posteriors, in the
  // order of texp's rows (mx, xx, mm, xm, ym, my, yy)
  double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int d = nd; d >= 0; --d) {
    float* cur = ring + (d & 1) * 3 * N;          // holds d+2 until written
    const float* b1 = ring + ((d + 1) & 1) * 3 * N;
    const float* b2 = cur;
    const int xd = pr.x0[d];
    const int wd = pr.width[d];
    const bool fin = d == nd;
    const int u1 = d + 1 < D1 ? xd - pr.x0[d + 1] : W + 5;
    const int u2 = d + 2 < D1 ? xd + 1 - pr.x0[d + 2] : W + 5;
    const int r1 = clampi(xd + 1, 0, pr.reflen - W);
    const int r0 = clampi(xd, 0, pr.reflen - W);
    const int es = clampi(pr.lY - d + xd + pr.efp - 1, 0, pr.evlen - W);
    if constexpr (PATHS) {
      // the target-side terms of this thread's cells (o, p), once each:
      // gapX TO (x+1, y) and match TO (x+1, y+1) on path p, which every
      // source path q of offset o reduces over below. They go to the gapX
      // and gapY planes of `cur`, dead at this step: diagonal d+2's gapX
      // and gapY were read at d+1, and only its match is read here.
      if (!fin) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = threadIdx.x + k * blockDim.x;
          const int o = c / P, p = c - o * P;
          if (c < N && o < wd) {
            const int xr1 = r1 + o, je = es + o;
            const float ev_mean = pr.ev[je];
            const bool evok = pr.ev[pr.LE + je] > 0.5f;
            const float m_hat1 = pr.rf(0, p, xr1), inv_m1 = pr.rf(1, p, xr1);
            float e_match_to;
            if constexpr (HDP) {
              e_match_to = (inv_m1 > 0.f && evok)
                               ? pr.hdp(p, xr1, m_hat1, ev_mean, h) : NEG;
            } else {
              const float c_m1 = pr.rf(2, p, xr1);
              const float am = (ev_mean - m_hat1) * inv_m1;
              e_match_to = (inv_m1 > 0.f && evok) ? c_m1 - 0.5f * am * am
                                                  : NEG;
            }
            const float gapx_valid = inv_m1 > 0.f ? pr.gapx : NEG;
            cur[GAP_X * N + c] =
                rd(b1, GAP_X, o + u1 + 1, p, W, N, P) + gapx_valid;
            cur[GAP_Y * N + c] =
                rd(b2, MATCH, o + u2, p, W, N, P) + e_match_to - m_prev;
          }
        }
      }
      // an offset's P cells share a warp when P divides 32
      if (32 % P == 0) __syncwarp();
      else __syncthreads();
    }
    float vm[K], vx[K], vy[K];
    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      float bm = NEG, bx = NEG, by = NEG;
      const int o = c / P, q = c - o * P;   // q: this cell's (source) path
      if (c < N && o < wd) {
        if (fin) {
          bm = pr.end[MATCH];
          bx = pr.end[GAP_X];
          by = pr.end[GAP_Y];
        } else {
          const int xr1 = r1 + o, xr0 = r0 + o, je = es + o;
          const float ev_mean = pr.ev[je];
          const bool evok = pr.ev[pr.LE + je] > 0.5f;
          // gapY TO cell (x, y+1) on the same path
          float e_stay_same;
          if constexpr (HDP) {
            const float m_hat0 = pr.rf(0, q, xr0), inv_m0 = pr.rf(1, q, xr0);
            e_stay_same = (inv_m0 > 0.f && evok)
                              ? pr.hdp(q, xr0, m_hat0, ev_mean, h) : NEG;
          } else {
            const float m_hat0 = pr.rf(0, q, xr0), inv_m0 = pr.rf(1, q, xr0),
                        inv_y0 = pr.rf(3, q, xr0), c_y0 = pr.rf(4, q, xr0);
            const float ay = (ev_mean - m_hat0) * inv_y0;
            e_stay_same = (inv_m0 > 0.f && evok) ? c_y0 - 0.5f * ay * ay : NEG;
          }
          const float gy_term = rd(b1, GAP_Y, o + u1, q, W, N, P) + e_stay_same;
          // gapX TO (x+1, y) and match TO (x+1, y+1), over the target
          // paths p that may follow q: legal[p, q] at x+1
          const unsigned long long lw = pr.leg[xr1];
          float gx_red, mm_red;
          if constexpr (PATHS) {
            unsigned lb = 0;   // bit p: legal[p, q] at x+1
#pragma unroll
            for (int p = 0; p < MAX_P; ++p)
              lb |= (unsigned)((lw >> (p * MAX_P + q)) & 1ull) << p;
            gx_red = legal_lse_row(cur + GAP_X * N + o * P, NEG, 0.f, lb, P);
            mm_red = legal_lse_row(cur + GAP_Y * N + o * P, NEG, 0.f, lb, P);
          } else {
            float tgx[PAIR_P], tmm[PAIR_P];
#pragma unroll
            for (int p = 0; p < PAIR_P; ++p) {
              if (p < P) {
                const bool leg = (lw >> (p * MAX_P + q)) & 1ull;
                float inv_m1, e_match_to;
                if constexpr (HDP) {
                  const float m_hat1 = pr.rf(0, p, xr1);
                  inv_m1 = pr.rf(1, p, xr1);
                  // only a legal target's emission is read below
                  e_match_to = (inv_m1 > 0.f && evok && leg)
                                   ? pr.hdp(p, xr1, m_hat1, ev_mean, h) : NEG;
                } else {
                  const float m_hat1 = pr.rf(0, p, xr1);
                  inv_m1 = pr.rf(1, p, xr1);
                  const float c_m1 = pr.rf(2, p, xr1);
                  const float am = (ev_mean - m_hat1) * inv_m1;
                  e_match_to = (inv_m1 > 0.f && evok) ? c_m1 - 0.5f * am * am
                                                      : NEG;
                }
                const float gapx_valid = inv_m1 > 0.f ? pr.gapx : NEG;
                tgx[p] = leg ? rd(b1, GAP_X, o + u1 + 1, p, W, N, P) + gapx_valid
                             : NEG;
                tmm[p] = leg ? rd(b2, MATCH, o + u2, p, W, N, P) + e_match_to
                                   - m_prev
                             : NEG;
              }
            }
            gx_red = P == 1 ? tgx[0] : legal_lse(tgx, P);
            mm_red = P == 1 ? tmm[0] : legal_lse(tmm, P);
          }
          if constexpr (EXPECT) {
            // transitions out of (x, y) at d; the to-cell reductions are
            // normalised to Bo(d+1), which `bo` still holds here
            const float normA = (float)(cv[d] + bo);
            const float* fd = fs + (size_t)d * 3 * N + q * W + o;
            const float f_m = fd[MATCH * N], f_x = fd[GAP_X * N],
                        f_y = fd[GAP_Y * N];
            const float p_mx = expf(f_m + tr[T_MX] + gx_red + normA);
            const float p_xx = expf(f_x + tr[T_XX] + gx_red + normA);
            const float p_mm = expf(f_m + tr[T_MM] + mm_red + normA);
            const float p_xm = expf(f_x + tr[T_XM] + mm_red + normA);
            const float p_ym = expf(f_y + tr[T_YM] + mm_red + normA);
            const float p_my = expf(f_m + tr[T_MY] + gy_term + normA);
            const float p_yy = expf(f_y + tr[T_YY] + gy_term + normA);
            acc[0] += (double)p_mx;
            acc[1] += (double)p_xx;
            acc[2] += (double)p_mm;
            acc[3] += (double)p_xm;
            acc[4] += (double)p_ym;
            acc[5] += (double)p_my;
            acc[6] += (double)p_yy;
            if constexpr (!HDP) {
              // moments of the into-match posterior at (x+1, y+1)
              const float mtp = p_mm + p_xm + p_ym;
              if (mtp != 0.f) {
                const float dxv = pr.rf(1, q, xr1) > 0.f
                                      ? (ev_mean - pr.rf(0, q, xr1)) / pr.var
                                      : 0.f;
                double* kb = kx + (size_t)b * 3 * LX + xr1;
                kb[0] += (double)mtp;
                kb[LX] += (double)(mtp * dxv);
                kb[2 * (size_t)LX] += (double)(mtp * dxv * dxv);
              }
            }
          }
          bm = lae(lae(gx_red + tr[T_MX], mm_red + tr[T_MM]),
                   gy_term + tr[T_MY]);
          bx = lae(gx_red + tr[T_XX], mm_red + tr[T_XM]);
          by = lae(mm_red + tr[T_YM], gy_term + tr[T_YY]);
        }
      }
      vm[k] = bm;
      vx[k] = bx;
      vy[k] = by;
      tmax = fmaxf(tmax, fmaxf(bm, fmaxf(bx, by)));
    }
    // barrier 1; it also ends every read of diagonal d+2 in `cur`
    float m = block_reduce<false>(tmax, part);
    m = fin ? 0.f : (m > NEG * 0.5f ? m : 0.f);
    bo += (double)m;                                     // Bo(d)
    // absolute log posterior = f + b + cvecf[d] + Bo(d), b normalised
    const float cd = (float)(cv[d] + bo);

    float pk[K];   // this lane's survivor value per chunk
    int rk[K];     // its rank inside its warp, -1 for none
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      bool surv = false;
      float p = 0.f;
      if (c < N) {
        const int o = c / P, q = c - o * P;
        const float bmn = fmaxf(vm[k] - m, NEG);
        cur[MATCH * N + c] = bmn;
        cur[GAP_X * N + c] = fmaxf(vx[k] - m, NEG);
        cur[GAP_Y * N + c] = fmaxf(vy[k] - m, NEG);
        const int x = xd + o, y = d - x;
        if (o < wd && x > 0 && y > 0 && x <= pr.lX && y <= pr.lY) {
          float fm;
          if constexpr (EXPECT) fm = fs[(size_t)d * 3 * N + q * W + o];
          else fm = fs[(size_t)d * N + q * W + o];
          p = expf(fmaxf(fm + bmn + cd, NEG));
          surv = p >= threshold;
        }
      }
      // survivors are ranked in cell (= offset, then path) order: chunk,
      // warp, lane
      const unsigned ball = __ballot_sync(0xffffffffu, surv);
      if (lane == 0) wcnt[k * 32 + warp] = __popc(ball);
      pk[k] = p;
      rk[k] = surv ? __popc(ball & ((1u << lane) - 1u)) : -1;
    }
    // barrier 2: publishes the normalised diagonal and the warp counts.
    // The next diagonal writes wcnt only after its barrier 1, which every
    // thread reaches after reading wcnt below.
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int base = before;
      for (int w = 0; w < warp; ++w) base += wcnt[k * 32 + w];
      const int r = base + rk[k];
      if (rk[k] >= 0 && r < R) {
        so[(size_t)d * R + r] = threadIdx.x + k * blockDim.x;
        sv[(size_t)d * R + r] = pk[k];
      }
      for (int w = 0; w < nw; ++w) before += wcnt[k * 32 + w];
    }
    if (threadIdx.x == 0) {
      inc[d] = m;
      cn[d] = before;
    }
    m_prev = m;
  }
  const float l = block_lse(ring, pr.start, N, part);   // diagonal 0 = slot 0
  if (threadIdx.x == 0) lse_b[b] = l;
  if constexpr (EXPECT) {
    // texp: warp sums, then the warps in order
    __shared__ double tpart[7][32];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      double v = acc[i];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) tpart[i][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < 7) {
      double s = 0.0;
      for (int w = 0; w < nw; ++w) s += tpart[threadIdx.x][w];
      texp[(size_t)b * 7 + threadIdx.x] = s;
    }
  }
}

int threads_for(int N) {
  return N >= MAX_THREADS ? MAX_THREADS : ((N + 31) / 32) * 32;
}

// cells per thread, rounded up to an instantiated K
int cells_per_thread(int N) {
  const int k = (N + MAX_THREADS - 1) / MAX_THREADS;
  return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8;
}

bool shape_ok(int W, int P) {
  return W >= 1 && P >= 1 && P <= MAX_P && P * W <= MAX_CELLS;
}

// the expectation instances: P = 1, at most two cells per thread
bool expect_shape_ok(int W, int P) {
  return P == 1 && W >= 1 && W <= 2 * MAX_THREADS;
}

// The device pointers and sizes of one bucket.
struct Bucket {
  const int* x0;
  const int* width;
  const float* ref;
  const unsigned long long* leg;
  const float* ev;
  const int* meta;
  const float* par;
  HdpTab h;
  int B, D1, W, P, LX, LE;
};

template <int K, bool HDP, bool EXPECT, bool PATHS>
int fwd_launch(const Bucket& a, float* fstack, float* f_incr, float* lse_f,
               cudaStream_t stream) {
  const int N = a.P * a.W;
  const size_t smem = (6 * (size_t)N + 32) * sizeof(float);
  cudaFuncSetAttribute(sa_fwd_sweep_kernel<K, HDP, EXPECT, PATHS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sa_fwd_sweep_kernel<K, HDP, EXPECT, PATHS>
      <<<a.B, threads_for(N), smem, stream>>>(
      a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack, f_incr,
      lse_f, a.D1, a.W, a.P, a.LX, a.LE);
  return (int)cudaGetLastError();
}

// PATHS: the P > 2 instances (EXPECT runs at P = 1 only)
template <bool HDP, bool EXPECT, bool PATHS>
int fwd_dispatch(const Bucket& a, float* fstack, float* f_incr, float* lse_f,
                 cudaStream_t s) {
  if constexpr (EXPECT) {
    return cells_per_thread(a.P * a.W) == 1
               ? fwd_launch<1, HDP, true, false>(a, fstack, f_incr, lse_f, s)
               : fwd_launch<2, HDP, true, false>(a, fstack, f_incr, lse_f, s);
  } else {
    switch (cells_per_thread(a.P * a.W)) {
      case 1:
        return fwd_launch<1, HDP, false, PATHS>(a, fstack, f_incr, lse_f, s);
      case 2:
        return fwd_launch<2, HDP, false, PATHS>(a, fstack, f_incr, lse_f, s);
      case 4:
        return fwd_launch<4, HDP, false, PATHS>(a, fstack, f_incr, lse_f, s);
      default:
        return fwd_launch<8, HDP, false, PATHS>(a, fstack, f_incr, lse_f, s);
    }
  }
}

// The backward's outputs: the survivor slots, and for an expectation
// pass texp (B, 7) and kx (B, 3, LX) (null otherwise).
struct BwdOut {
  float* b_incr;
  float* lse_b;
  int* slot_cell;
  float* slot_val;
  int* cnt;
  double* texp;
  double* kx;
};

template <int K, bool HDP, bool EXPECT, bool PATHS>
int bwd_launch(const Bucket& a, const float* fstack, const double* cvecf,
               const BwdOut& o, int R, float threshold, cudaStream_t stream) {
  const int N = a.P * a.W;
  const size_t smem =
      (6 * (size_t)N + 32) * sizeof(float) + K * 32 * sizeof(int);
  cudaFuncSetAttribute(sa_bwd_sweep_compact_kernel<K, HDP, EXPECT, PATHS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sa_bwd_sweep_compact_kernel<K, HDP, EXPECT, PATHS>
      <<<a.B, threads_for(N), smem, stream>>>(
          a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack,
          cvecf, o.b_incr, o.lse_b, o.slot_cell, o.slot_val, o.cnt, o.texp,
          o.kx, a.D1, a.W, a.P, a.LX, a.LE, R, threshold);
  return (int)cudaGetLastError();
}

template <bool HDP, bool EXPECT, bool PATHS>
int bwd_dispatch(const Bucket& a, const float* fstack, const double* cvecf,
                 const BwdOut& o, int R, float threshold, cudaStream_t s) {
  if constexpr (EXPECT) {
    return cells_per_thread(a.P * a.W) == 1
        ? bwd_launch<1, HDP, true, false>(a, fstack, cvecf, o, R, threshold, s)
        : bwd_launch<2, HDP, true, false>(a, fstack, cvecf, o, R, threshold, s);
  } else {
    switch (cells_per_thread(a.P * a.W)) {
      case 1: return bwd_launch<1, HDP, false, PATHS>(a, fstack, cvecf, o, R,
                                                      threshold, s);
      case 2: return bwd_launch<2, HDP, false, PATHS>(a, fstack, cvecf, o, R,
                                                      threshold, s);
      case 4: return bwd_launch<4, HDP, false, PATHS>(a, fstack, cvecf, o, R,
                                                      threshold, s);
      default: return bwd_launch<8, HDP, false, PATHS>(a, fstack, cvecf, o, R,
                                                       threshold, s);
    }
  }
}

// A Gaussian bucket passes null HDP pointers; an HDP bucket all four
// pointers and a grid of at least two knots.
bool hdp_ok(const HdpTab& h) {
  if (!h.dens) return !h.kid && !h.mu && !h.slopes;
  return h.kid && h.mu && h.slopes && h.nk >= 1 && h.ng >= 2 && h.dx > 0.f;
}

}  // namespace

// C interface, loaded with ctypes. Every pointer is a device pointer of a
// contiguous tensor; the kernels launch on `stream`, allocate nothing and
// do not synchronise. kid, mu, dens and slopes are the HDP tables (kid
// and mu (B, P, LX), dens and slopes (nk, ng) on the grid g0 + i * dx with
// last knot gN), all null for a Gaussian bucket. `expect` != 0 runs the
// EM expectation instances: fstack is (B, D1, 3, P, W), and the backward
// writes texp (B, 7) and adds into kx (B, 3, LX), which the caller zeroes
// (both null otherwise). Each returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue for a shape it does not take (P > 8 or
// P * W > 8192; with `expect`, P > 1 or W > 2048), an incomplete set of
// HDP tables or missing expectation outputs.

extern "C" int sa_fwd_sweep(const int* x0, const int* width, const float* ref,
                            const unsigned long long* leg, const float* ev,
                            const int* meta, const float* par, const int* kid,
                            const float* mu, const float* dens,
                            const float* slopes, float* fstack,
                            float* f_incr, float* lse_f, int B, int D1, int W,
                            int P, int LX, int LE, int expect, int nk, int ng,
                            float g0, float dx, float gN, void* stream) {
  const Bucket a{x0, width, ref, leg, ev, meta, par,
                 HdpTab{kid, mu, dens, slopes, nk, ng, g0, dx, gN},
                 B, D1, W, P, LX, LE};
  if (!shape_ok(W, P) || !hdp_ok(a.h) || (expect && !expect_shape_ok(W, P)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (expect)
    return dens ? fwd_dispatch<true, true, false>(a, fstack, f_incr, lse_f, s)
                : fwd_dispatch<false, true, false>(a, fstack, f_incr, lse_f, s);
  if (P > PAIR_P)
    return dens ? fwd_dispatch<true, false, true>(a, fstack, f_incr, lse_f, s)
                : fwd_dispatch<false, false, true>(a, fstack, f_incr, lse_f, s);
  return dens ? fwd_dispatch<true, false, false>(a, fstack, f_incr, lse_f, s)
              : fwd_dispatch<false, false, false>(a, fstack, f_incr, lse_f, s);
}

extern "C" int sa_bwd_sweep_compact(
    const int* x0, const int* width, const float* ref,
    const unsigned long long* leg, const float* ev, const int* meta,
    const float* par, const int* kid, const float* mu, const float* dens,
    const float* slopes, const float* fstack, const double* cvecf,
    float* b_incr, float* lse_b, int* slot_cell, float* slot_val, int* cnt,
    double* texp, double* kx, int B, int D1, int W, int P, int LX, int LE,
    int R, int expect, int nk, int ng, float threshold, float g0, float dx,
    float gN, void* stream) {
  const Bucket a{x0, width, ref, leg, ev, meta, par,
                 HdpTab{kid, mu, dens, slopes, nk, ng, g0, dx, gN},
                 B, D1, W, P, LX, LE};
  if (!shape_ok(W, P) || !hdp_ok(a.h) ||
      (expect && (!expect_shape_ok(W, P) || !texp || !kx)))
    return (int)cudaErrorInvalidValue;
  const BwdOut o{b_incr, lse_b, slot_cell, slot_val, cnt, texp, kx};
  cudaStream_t s = (cudaStream_t)stream;
  if (expect)
    return dens
        ? bwd_dispatch<true, true, false>(a, fstack, cvecf, o, R, threshold, s)
        : bwd_dispatch<false, true, false>(a, fstack, cvecf, o, R, threshold, s);
  if (P > PAIR_P)
    return dens
        ? bwd_dispatch<true, false, true>(a, fstack, cvecf, o, R, threshold, s)
        : bwd_dispatch<false, false, true>(a, fstack, cvecf, o, R, threshold, s);
  return dens
      ? bwd_dispatch<true, false, false>(a, fstack, cvecf, o, R, threshold, s)
      : bwd_dispatch<false, false, false>(a, fstack, cvecf, o, R, threshold, s);
}
