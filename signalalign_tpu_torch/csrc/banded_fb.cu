// Hand-written Hopper kernels for the banded forward-backward of
// signalalign_tpu_torch: MODE_MEAN_ONLY Gaussian or MODE_HDP spline
// emissions, any number P of paths per cell (degenerate reference
// positions expand into paths).
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
// holds all P paths of a problem, legality is ceil(P / 32) 32-bit words
// per (reference position, target path) (bit q % 32 of word q / 32: legal
// from source path q), and the backward offset is a plain double.
//
// What bounds them on this card: the serial chain of anti-diagonals. A
// diagonal depends on the two before it, so one problem is one block that
// walks its own n_diag diagonals in order. At P <= 2 the work per
// diagonal is small (W or 2W cells, ~9 transcendentals each), so latency,
// not device-memory bandwidth or arithmetic, sets the time of one
// problem: the block barriers, and every load whose result a diagonal
// waits for; throughput comes from many problems in flight (one block
// each). At P > 2 each cell adds two logsumexps over its legal paths (an
// exponential per legal path pair, a logarithm per logsumexp) and,
// forward, the three logaddexp terms its successors read.
//
// Three designs, picked per bucket by the dispatch at the end of this
// file.
//
// The per-pair instances (P <= PAIR_P = 2 and P * W <= PAIR_CELLS, EXPECT
// included) wait on one block barrier per diagonal:
// - a ring of three slots holds *raw* (un-normalised) states, stored
//   clamped at NEG: diagonal d goes to slot d mod 3, whose last reader
//   (diagonal d-1) finished before the barrier of d-1. A reader
//   normalises at read time by subtracting the diagonal's max m: for a
//   stored v >= NEG, v - m equals the twin's fmaxf(raw - m, NEG) bit for
//   bit (NEG - m rounds to NEG), so the stacks, increments and totals
//   equal the twin's. One subtraction a read: the clamp and the select
//   of diagonal 0's raw start logs at every read cost the forward 18%
//   (H100, PERF.md §6);
// - the per-warp maxima are double-buffered by diagonal parity: after a
//   diagonal's single barrier every thread forms its max m(d) from them,
//   then writes the diagonal's stack rows and offset from registers;
// - the backward forms diagonal d's posteriors, ballots and warp counts
//   after barrier d, and the barrier of d-1 publishes the counts: d's
//   survivor slots are written one step later, in the same cell order;
// - what the next diagonal waits on from device memory is loaded before
//   the barrier: the band origin and width two diagonals ahead, and in
//   the backward each cell's forward state(s) and cvecf one ahead. The
//   reference rows, events and legality masks are loaded at the diagonal,
//   as the P > 2 instances do: their lines serve ~64 diagonals from L1,
//   and staging them a diagonal ahead in registers measured slower;
// - EXPECT's per-(position, path) moment sums live in a shared-memory
//   window over the band's positions (one slot per position mod W and
//   path, tagged with its position) and are added to device memory,
//   without waiting, when a position leaves the window or the sweep ends:
//   still one writer per slot per diagonal, in diagonal order, so the
//   double sums keep their order and are deterministic (a read-modify-
//   write of kx in device memory per cell had put an L2 round trip on
//   every diagonal). At P = 2 a target's two source paths sit in
//   neighbouring lanes, which exchange their terms by one shuffle (a
//   template instance of its own, so the P = 1 instances are unchanged);
// - cells per thread K come from a table measured on an H100 (pair_k):
//   the most threads the instance's register budget allows won at every
//   class. A block of one warp synchronises with __syncwarp and reduces
//   with shuffles alone.
// What bounds them is the dependent chain of each cell's logaddexps
// (precise expf and log1pf) and the issue slots of a problem's few warps,
// more than the barrier: the one-barrier ring without any read-time
// normalisation measured only 7% below the two-barrier design.
//
// The P > 2 instances (PATHS) compute every term that does not depend on
// the path at the other end of a transition once per cell, not once per
// (source, target) pair, with two barriers per diagonal. The forward's
// ring holds, in place of a cell's three states, the three terms later
// diagonals read from it (src_terms: gapX and gapY of d+1, match of d+2
// before its m_prev), so a target cell's logsumexp over its source paths
// reads the legal ones' terms from shared memory, with no logaddexp
// inside; reads outside the window take the terms of NEG states,
// computed once per block, and the end logsumexp takes the last
// diagonal's states from registers. The backward first writes each cell's
// target terms (gapX TO and match TO on its own path, with the match-to
// emission, the HDP spline among them) into the two planes of the oldest
// ring slot that are dead at that step, then, after one more barrier (a
// warp's when P divides 32: an offset's P cells are then in one warp),
// reduces each source cell over the legal targets from there. They also
// take P <= 2 buckets too wide for the per-pair instances' shared memory,
// and the EXPECT pass of every bucket of P > 1.
// Every operation and its order are those of the twin's, so the results
// stay equal bit for bit. Past 32 paths a logsumexp walks the legal bits
// of each of its ceil(P / 32) words in turn (legal_lse_words), in path
// order as before.
//
// The wide instances (P * W > REG_CELLS = 8,192 cells a diagonal: P = 64
// at W = 256, P = 16 at W = 768) are the P > 2 design on more than one
// block's shared memory. Up to CAP (P = 64 at W = 768, 49,152 cells, the
// widest bucket of the runner at P <= 64, fits) a problem runs on a
// thread-block cluster of up to 8 blocks on neighbouring SMs (the
// cluster instance, sa_fwd_cluster_kernel / sa_bwd_cluster_kernel): each
// block owns a run of band offsets with all their paths, keeps its slice
// of the ring (6 P W floats in all, 393 KB at P = 64, W = 256, past the
// 227 KB one block may have) in its shared memory and its cells in
// registers, reads a neighbour's edge offsets through distributed shared
// memory, and synchronises by two cluster barriers a diagonal; its stack
// rows pass through shared memory, so they are written and read in runs
// of offsets. Past CAP the scratch instance (K = WIDE) runs: 1,024
// threads that each loop over every 1,024th cell, its ring, cell states
// and survivor ranks in a per-problem device scratch the wrapper
// allocates, L2-resident; __syncthreads orders its writes before its
// reads within the block as it does shared memory's. Same operations,
// same order: both are bit-equal to the twin. The scratch instance's
// cost is the L1/L2 latency of every ring read and one SM doing the work
// of several (PR 8: 45 us a diagonal at P = 64, W = 256 on an H100).
//
// HDP emissions (log((1/var) * Hermite spline of the descaled mean) over
// the k-mer's density/slope rows on a uniform grid, hdp_log_emission
// below) are computed inline too, where the sweeps need them: no
// (diagonal, cell, path) emission stack is written or read, and no extra
// launch runs. The TPU wrote that stack, with banked table DMA, select
// trees and `ebnd` boundary rows, only because Mosaic has no gather
// (emission_stream.py:1-29); here each spline is four loads from the
// k-mer's table rows in device memory (two density, two slope values at
// the interval's knots). The tables (2 x 224 MB at 46,656 k-mers x 1,200
// points) do not fit the 50 MB L2, but within a block the k-mer row is
// fixed per (position, path) and neighbouring diagonals read nearby
// knots, so the loads mostly hit L1/L2. The backward evaluates the
// match-to emission once per legal (source, target) path pair at P <= 2
// and once per (offset, path) at P > 2; illegal pairs skip it. The
// Gaussian instances compile without any of it (if constexpr).
//
// The EM expectation pass (template flag EXPECT) replaces the `expect`
// mode of _fwd_kernel_log / _bwd_kernel_log, and at P > 1 the JAX XLA
// expectation core the JAX runner sends such buckets to: the forward
// writes all three normalised states of each diagonal (fstack (B, D1, 3,
// P, W)). Where the sums are taken depends on the backward's instance:
// - the per-pair, cluster and scratch instances sum in the sweep: at each
//   FROM diagonal d < n_diag the backward already holds the to-cell
//   reductions gx_red, mm_red (over the legal target paths) and gy_term
//   of every cell, so it adds the seven transition posteriors exp(f_s + t
//   + red + normA), normA = cvecf[d] + Bo(d+1), into per-thread double
//   sums (one block reduction at the end, in a fixed order: texp (B, 7)):
//   a reduction over the targets is the sum of the (source, target) pair
//   posteriors the XLA core adds up, to f32 round-off. In the Gaussian
//   instances it adds the into-match posterior's moments [p, p dx, p
//   dx^2], dx = (event mean - m_hat(x+1)) / var (0 where inv_m <= 0),
//   into kx[b, :, p, x+1] for each target (x+1, y+1) on path p: the
//   per-pair instances (P <= 2 within PAIR_CELLS) through the
//   shared-memory window above, the cluster and scratch instances (past
//   REG_CELLS) by adds into device memory from the cell that staged the
//   target's term, which sums the pair posteriors of its legal source
//   paths; one writer per (path, position) a diagonal, the diagonals in
//   barrier order;
// - the P > 2 register instances (every other expectation bucket:
//   expect_split) sum nothing in the sweep: they write each diagonal's
//   three normalised backward states from registers into bstack (B, D1,
//   3, P, W), laid out as fstack, and sa_expect_sums then sums texp and kx
//   from both stacks over every diagonal at once, term for term as the
//   twin (its note below). The sums had cost these sweeps 1.30-1.42x the
//   plain backward on their serial chain (H100, PERF.md §6).
// The HDP instances accumulate texp only (the TPU kernel's contract: HDP
// emissions train from assignments, not Gaussian moments). The
// non-expect instances compile without any of it (if constexpr).
//
// Numerics: float32 values with precise expf/logf/log1pf (no fast math),
// built with --fmad=false so each operation rounds as in the plain twin,
// the logaddexp formulation of torch.logaddexp and the twin's legal
// logsumexp over paths (max, then exp-sum in path order); the backward
// running offset and the forward normaliser stream cvecf are float64.
// Only the end-of-sweep logsumexp (block_lse_cells) and EXPECT's texp sum
// in thread order, so they depend on K; sa_expect_sums sums in an order
// fixed by its grid.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

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
constexpr int PAIR_P = 2;   // the per-pair instances' paths (P > 2: PATHS)
// the per-pair instances' cells: 9 P W floats of ring in shared memory
constexpr int PAIR_CELLS = 2048;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_K = 8;   // cells per thread held in registers
// P * W of the P > 2 instances that hold their cells in registers and
// their ring in shared memory; wider diagonals take the wide instance
constexpr int REG_CELLS = MAX_K * MAX_THREADS;

// 32-bit legality words per (position, path) at P paths
__host__ __device__ __forceinline__ int leg_words(int P) {
  return (P + 31) / 32;
}

// threads a per-pair instance is built for (its register budget:
// 65,536 / threads): PAIR_CELLS cells at the table's largest K, 4
constexpr int PAIR_THREADS = 512;

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
// the result NEG + logf(s) rounds to NEG for any s in [1, 32]. The legal
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

// legal_lse_row over P > 32 paths: bit q % 32 of word lw[q / 32] (NW
// words) says whether path q is legal; the same operations in path order
__device__ __forceinline__ float legal_lse_words(const float* row, float fill,
                                              float sub, const unsigned* lw,
                                              int NW, int P) {
  auto v = [&](int q) { return (row ? row[q] : fill) - sub; };
  int n = 0;
  for (int w = 0; w < NW; ++w) n += __popc(lw[w]);
  float mx = n == P ? -INFINITY : NEG;
  for (int w = 0; w < NW; ++w)
    for (unsigned m = lw[w]; m; m &= m - 1)
      mx = fmaxf(mx, v(32 * w + __ffs(m) - 1));
  if (mx == NEG) return NEG;
  float s = 0.f;
  for (int w = 0; w < NW; ++w)
    for (unsigned m = lw[w]; m; m &= m - 1)
      s += expf(v(32 * w + __ffs(m) - 1) - mx);
  return mx + logf(fmaxf(s, 1e-37f));
}

// the legal logsumexp of a P > 2 cell over its NW legality words lw
__device__ __forceinline__ float legal_lse_any(const float* row, float fill,
                                               float sub, const unsigned* lw,
                                               int NW, int P) {
  return NW == 1 ? legal_lse_row(row, fill, sub, lw[0], P)
                 : legal_lse_words(row, fill, sub, lw, NW, P);
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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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
  // (LX, P, NW) legality masks, NW = ceil(P / 32) words: the forward's
  // by target path (bit q % 32 of word q / 32: legal from source path q),
  // the backward's by source path (the same for target path p)
  const unsigned* leg;
  const float* ev;                  // (NEV, LE)
  int lX, lY, nd, efp, reflen, evlen, P, LX, LE;
  float t[9], start[3], end[3], gapx;
  // HDP buckets only
  const int* kid;                   // (P, LX) k-mer ids
  const float* mu;                  // (P, LX) level means
  float var;
  int NW;                           // legality words per (position, path)

  __device__ void load(const int* x0_, const int* width_, const float* ref_,
                       const unsigned* leg_, const float* ev_,
                       const int* meta_, const float* par_, const HdpTab& h,
                       int D1, int P_, int LX_, int LE_, int b_ = -1) {
    // problem b_ (by default the block's: one block a problem)
    const int b = b_ < 0 ? (int)blockIdx.x : b_;
    x0 = x0_ + (size_t)b * D1;
    width = width_ + (size_t)b * D1;
    ref = ref_ + (size_t)b * NREF * P_ * LX_;
    kid = h.kid ? h.kid + (size_t)b * P_ * LX_ : nullptr;
    mu = h.mu ? h.mu + (size_t)b * P_ * LX_ : nullptr;
    NW = leg_words(P_);
    leg = leg_ + (size_t)b * LX_ * P_ * NW;
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

  // the NW legality words of path p at column x (see `leg`)
  __device__ __forceinline__ const unsigned* lg(int x, int p) const {
    return leg + ((size_t)x * P + p) * NW;
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


// texp of an expectation pass: each thread's seven double sums added over
// its warp by shuffles, then the warps in order, to out[0..7). Contains a
// barrier.
__device__ void block_texp(const double (&acc)[7], double* out) {
  __shared__ double tpart[7][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
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
    out[threadIdx.x] = s;
  }
}

// ------------------------------------------------ P > 2 (PATHS) instances

// The cells per thread that mark the scratch instance (past CAP, where
// the cluster instance does not fit: cluster_cfg): P * W > REG_CELLS
// cells, MAX_THREADS threads that each loop over every MAX_THREADS-th
// cell of the diagonal, and the ring, the cells' states and the
// backward's survivor ranks in a per-problem device scratch (L2-resident:
// 9-11 floats a cell) in place of shared memory and registers. The same
// operations in the same order as the register instances (only the end
// logsumexp sums in thread order), and __syncthreads orders the
// scratch's writes before its reads as it does shared memory's.
constexpr int WIDE = 0;

// The scratch of one problem of the wide instance, in 4-byte words: the
// forward's ring (6 N) and cell states (3 N); the backward's ring, cell
// states, survivor values and ranks (N each) and per-chunk warp counts.
__host__ __device__ __forceinline__ size_t wide_scratch_words(int N,
                                                              bool backward) {
  const size_t nk = (N + MAX_THREADS - 1) / MAX_THREADS;
  return backward ? 11 * (size_t)N + 32 * nk : 9 * (size_t)N;
}

// A P > 2 instance's cell states: K a thread in registers (cell c = thread
// + k * blockDim), or the wide instance's in its scratch at cell c.
template <int K>
struct Cells {
  float m[K], x[K], y[K];
  __device__ __forceinline__ float& M(int k, int) { return m[k]; }
  __device__ __forceinline__ float& X(int k, int) { return x[k]; }
  __device__ __forceinline__ float& Y(int k, int) { return y[k]; }
};
template <>
struct Cells<WIDE> {
  float *m, *x, *y;
  __device__ __forceinline__ float& M(int, int c) { return m[c]; }
  __device__ __forceinline__ float& X(int, int c) { return x[c]; }
  __device__ __forceinline__ float& Y(int, int c) { return y[c]; }
};

// The backward's survivors of a diagonal: value and rank inside its warp
// (-1 for none) per cell, as Cells
template <int K>
struct Surv {
  float p[K];
  int r[K];
  __device__ __forceinline__ float& V(int k, int) { return p[k]; }
  __device__ __forceinline__ int& R(int k, int) { return r[k]; }
};
template <>
struct Surv<WIDE> {
  float* p;
  int* r;
  __device__ __forceinline__ float& V(int, int c) { return p[c]; }
  __device__ __forceinline__ int& R(int, int c) { return r[c]; }
};

// block_lse_cells over the wide instance's cells in its scratch
__device__ float block_lse_mem(const float* vm, const float* vx,
                               const float* vy, int nk, const float* logs,
                               int N, float* part) {
  float mx = NEG;
  for (int k = 0; k < nk; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < N) {
      mx = fmaxf(mx, fmaxf(vm[c] + logs[0], NEG));
      mx = fmaxf(mx, fmaxf(vx[c] + logs[1], NEG));
      mx = fmaxf(mx, fmaxf(vy[c] + logs[2], NEG));
    }
  }
  __syncthreads();
  mx = block_reduce<false>(mx, part);
  float sm = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < N) {
      sm += expf(fmaxf(vm[c] + logs[0], NEG) - mx);
      sm += expf(fmaxf(vx[c] + logs[1], NEG) - mx);
      sm += expf(fmaxf(vy[c] + logs[2], NEG) - mx);
    }
  }
  __syncthreads();
  sm = block_reduce<true>(sm, part);
  return logf(sm) + mx;
}

template <int K, bool HDP, bool EXPECT>
__global__ void __launch_bounds__(MAX_THREADS) sa_fwd_paths_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, float* scratch, int D1, int W, int P_, int LX,
    int LE) {
  constexpr bool WIDE_ = K == WIDE;
  extern __shared__ float smem[];
  const int N = P_ * W;
  const int b = blockIdx.x;
  // [2 slots][3 source terms SRC_X, SRC_Y, SRC_M][N], cell o*P + p
  float* sb = WIDE_ ? scratch + b * wide_scratch_words(N, false) : nullptr;
  float* ring = WIDE_ ? sb : smem;
  float* part = WIDE_ ? smem : smem + 6 * N;   // [32] reduction partials
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE);
  // the terms of a cell whose states are NEG: every cell outside the
  // band, and every read outside the window
  const SrcTerms neg = src_terms(NEG, NEG, NEG,
                                 par_ + (size_t)blockIdx.x * NPACK + PACK_TRANS);
  for (int i = threadIdx.x; i < 6 * N; i += blockDim.x) {
    const int pl = (i / N) % 3;
    ring[i] = pl == SRC_X ? neg.x : pl == SRC_Y ? neg.y : neg.m;
  }
  __syncthreads();

  const int P = pr.P, NW = pr.NW;
  constexpr int NF = EXPECT ? 3 : 1;   // states a diagonal's stack row keeps
  float* fs = fstack + (size_t)b * D1 * N * NF;   // (D1, P, W); EXPECT: (D1, 3, P, W)
  float* inc = f_incr + (size_t)b * D1;
  const int nd = pr.nd;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;

  // diagonal 0: the single start cell (0, 0) on path 0, in slot 0
  if (threadIdx.x == 0) {
    const SrcTerms st = src_terms(pr.start[MATCH], pr.start[GAP_X],
                                  pr.start[GAP_Y], pr.t);
    ring[SRC_X * N] = st.x;
    ring[SRC_Y * N] = st.y;
    ring[SRC_M * N] = st.m;
    inc[0] = 0.f;
  }
  for (int c = threadIdx.x; c < NF * N; c += blockDim.x)
    fs[c] = c % N == 0 ? pr.start[c / N] : NEG;
  __syncthreads();

  const float* tr = pr.t;
  float m_prev = 0.f;
  // this thread's cells of the diagonal in hand; after the loop, the
  // normalised states of diagonal nd (the ring holds terms)
  const int nk = WIDE_ ? (N + blockDim.x - 1) / blockDim.x : K;
  Cells<K> v;
  if constexpr (WIDE_) {
    v.m = sb + 6 * N;
    v.x = sb + 7 * N;
    v.y = sb + 8 * N;
  }
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (!WIDE_ || c < N) {
      v.M(k, c) = c == 0 ? pr.start[MATCH] : NEG;
      v.X(k, c) = c == 0 ? pr.start[GAP_X] : NEG;
      v.Y(k, c) = c == 0 ? pr.start[GAP_Y] : NEG;
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
    for (int k = 0; k < nk; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      float mm = NEG, gx = NEG, gy = NEG;
      const int o = c / P, p = c - o * P;
      if (c < N && o < wd) {
        const int xr = rs + o, je = es + o;
        bool kvalid;
        float e_match, e_stay;
        const float m_hat = pr.rf(0, p, xr), inv_m = pr.rf(1, p, xr);
        const float ev_mean = pr.ev[je];
        kvalid = inv_m > 0.f;
        const bool ok = kvalid && pr.ev[pr.LE + je] > 0.5f;
        const unsigned* lw = pr.lg(xr, p);
        if constexpr (HDP) {
          // stay = match (emissions_signal_getHdpKmerDensity)
          e_match = e_stay = ok ? pr.hdp(p, xr, m_hat, ev_mean, h) : NEG;
        } else {
          const float c_m = pr.rf(2, p, xr), inv_y = pr.rf(3, p, xr),
                      c_y = pr.rf(4, p, xr);
          const float am = (ev_mean - m_hat) * inv_m;
          const float ay = (ev_mean - m_hat) * inv_y;
          e_match = ok ? c_m - 0.5f * am * am : NEG;
          e_stay = ok ? c_y - 0.5f * ay * ay : NEG;
        }
        const float e_gapx = kvalid ? pr.gapx : NEG;

        // gapX from (x-1, y) and match from (x-1, y-1), over the legal
        // source paths q: one pass over the terms the source cells wrote
        const int il = o + s1, im = o + s2;
        const float* rx = il >= 0 && il < W ? p1 + SRC_X * N + il * P
                                            : nullptr;
        const float* rm = im >= 0 && im < W ? p2 + SRC_M * N + im * P
                                            : nullptr;
        gx = legal_lse_any(rx, neg.x, 0.f, lw, NW, P) + e_gapx;
        mm = legal_lse_any(rm, neg.m, m_prev, lw, NW, P) + e_match;
        // gapY from (x, y-1), same path
        const int iy = il + 1;
        gy = (iy >= 0 && iy < W ? p1[SRC_Y * N + iy * P + p] : neg.y) +
             e_stay;
      }
      if (!WIDE_ || c < N) {
        v.M(k, c) = mm;
        v.X(k, c) = gx;
        v.Y(k, c) = gy;
      }
      tmax = fmaxf(tmax, fmaxf(mm, fmaxf(gx, gy)));
    }
    // its barrier also ends every read of diagonal d-2 in `cur`
    float m = block_reduce<false>(tmax, part);
    m = m > NEG * 0.5f ? m : 0.f;
#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < N) {
        const int o = c / P, p = c - o * P;
        const float mm = fmaxf(v.M(k, c) - m, NEG);
        const float gx = fmaxf(v.X(k, c) - m, NEG);
        const float gy = fmaxf(v.Y(k, c) - m, NEG);
        const SrcTerms st = src_terms(mm, gx, gy, tr);
        cur[SRC_X * N + c] = st.x;
        cur[SRC_Y * N + c] = st.y;
        cur[SRC_M * N + c] = st.m;
        v.M(k, c) = mm;
        v.X(k, c) = gx;
        v.Y(k, c) = gy;
        float* fd = fs + (size_t)d * NF * N + p * W + o;
        fd[0] = mm;
        if constexpr (EXPECT) {
          fd[GAP_X * N] = gx;
          fd[GAP_Y * N] = gy;
        }
      }
    }
    if (threadIdx.x == 0) inc[d] = m;
    m_prev = m;
    __syncthreads();
  }
  float l;
  if constexpr (WIDE_)
    l = block_lse_mem(v.m, v.x, v.y, nk, pr.end, N, part);
  else
    l = block_lse_cells<K>(v.m, v.x, v.y, pr.end, N, part);
  if (threadIdx.x == 0) lse_f[b] = l;
}

template <int K, bool HDP, bool EXPECT>
__global__ void __launch_bounds__(MAX_THREADS) sa_bwd_paths_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    const float* __restrict__ fstack,
    const double* __restrict__ cvecf, float* __restrict__ b_incr,
    float* __restrict__ lse_b, int* __restrict__ slot_cell,
    float* __restrict__ slot_val, int* __restrict__ cnt,
    double* __restrict__ texp, double* __restrict__ kx,
    float* __restrict__ bstack, float* scratch, int D1, int W, int P_,
    int LX, int LE, int R, float threshold) {
  constexpr bool WIDE_ = K == WIDE;
  // EXPECT: the register instances store the diagonal's three states
  // (bstack, laid out as fstack) and leave texp and kx to sa_expect_sums;
  // the scratch instance sums them here
  constexpr bool SUMS = EXPECT && WIDE_;
  constexpr bool STACK = EXPECT && !WIDE_;
  constexpr bool MOMENTS = SUMS && !HDP;
  constexpr int NF = EXPECT ? 3 : 1;   // forward states a stack row holds
  extern __shared__ float smem[];
  const int N = P_ * W;
  const int b = blockIdx.x;
  const int nk = WIDE_ ? (N + blockDim.x - 1) / blockDim.x : K;
  float* sb = WIDE_ ? scratch + b * wide_scratch_words(N, true) : nullptr;
  float* ring = WIDE_ ? sb : smem;                  // [2 slots][3 states][N]
  float* part = WIDE_ ? smem : smem + 6 * N;        // [32] reduction partials
  // [nk][32] survivors per warp and chunk
  int* wcnt = reinterpret_cast<int*>(WIDE_ ? sb + 11 * N : part + 32);
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE);
  for (int i = threadIdx.x; i < 6 * N; i += blockDim.x) ring[i] = NEG;
  __syncthreads();

  const int P = pr.P, NW = pr.NW;
  const float* fs = fstack + (size_t)b * D1 * N * NF;
  float* bs = STACK ? bstack + (size_t)b * D1 * 3 * N : nullptr;
  const double* cv = cvecf + (size_t)b * D1;
  // MOMENTS: (3, P, LX) sums per (path, position), one writer per cell a
  // diagonal, the diagonals in order (the barriers order them)
  double* kb = MOMENTS ? kx + (size_t)b * 3 * P * LX : nullptr;
  // SUMS: this thread's sums of the seven transition posteriors, in the
  // order of texp's rows (mx, xx, mm, xm, ym, my, yy)
  double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
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
  Cells<K> v;        // this thread's cells of the diagonal
  Surv<K> su;        // and their survivors
  if constexpr (WIDE_) {
    v.m = sb + 6 * N;
    v.x = sb + 7 * N;
    v.y = sb + 8 * N;
    su.p = sb + 9 * N;
    su.r = reinterpret_cast<int*>(sb + 10 * N);
  }
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
    // the target-side terms of this thread's cells (o, p), once each:
    // gapX TO (x+1, y) and match TO (x+1, y+1) on path p, which every
    // source path q of offset o reduces over below. They go to the gapX
    // and gapY planes of `cur`, dead at this step: diagonal d+2's gapX
    // and gapY were read at d+1, and only its match is read here.
    if (!fin) {
#pragma unroll
      for (int k = 0; k < nk; ++k) {
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
          const float tmm =
              rd(b2, MATCH, o + u2, p, W, N, P) + e_match_to - m_prev;
          cur[GAP_Y * N + c] = tmm;
          if constexpr (MOMENTS) {
            // the into-match posterior of this target (x+1, y+1) on path
            // p, summed over the source paths q at (x, y) it may follow:
            // bit p of legal[., q] at x+1. The to-cell term is normalised
            // to Bo(d+1), which `bo` still holds here.
            const float normA = (float)(cv[d] + bo);
            const float* fd = fs + (size_t)d * 3 * N + o;
            float mtp = 0.f;
            for (int q = 0; q < P; ++q) {
              if ((pr.lg(xr1, q)[p >> 5] >> (p & 31)) & 1u) {
                const float* f = fd + q * W;
                mtp += expf(f[MATCH * N] + tr[T_MM] + tmm + normA) +
                       expf(f[GAP_X * N] + tr[T_XM] + tmm + normA) +
                       expf(f[GAP_Y * N] + tr[T_YM] + tmm + normA);
              }
            }
            if (mtp != 0.f) {
              const float dxv =
                  inv_m1 > 0.f ? (ev_mean - m_hat1) / pr.var : 0.f;
              double* kc = kb + (size_t)p * LX + xr1;
              const size_t plane = (size_t)P * LX;
              kc[0] += (double)mtp;
              kc[plane] += (double)(mtp * dxv);
              kc[2 * plane] += (double)(mtp * dxv * dxv);
            }
          }
        }
      }
    }
    // an offset's P cells share a warp when P divides 32
    if (32 % P == 0) __syncwarp();
    else __syncthreads();
    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < nk; ++k) {
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
          const unsigned* lw = pr.lg(xr1, q);   // bit p: legal[p, q] at x+1
          const float gx_red =
              legal_lse_any(cur + GAP_X * N + o * P, NEG, 0.f, lw, NW, P);
          const float mm_red =
              legal_lse_any(cur + GAP_Y * N + o * P, NEG, 0.f, lw, NW, P);
          if constexpr (SUMS) {
            // transitions out of (x, y) on path q at d, summed over their
            // legal targets by the to-cell reductions (normalised to
            // Bo(d+1), which `bo` still holds here)
            const float normA = (float)(cv[d] + bo);
            const float* f = fs + (size_t)d * 3 * N + q * W + o;
            const float f_m = f[MATCH * N], f_x = f[GAP_X * N],
                        f_y = f[GAP_Y * N];
            acc[0] += (double)expf(f_m + tr[T_MX] + gx_red + normA);
            acc[1] += (double)expf(f_x + tr[T_XX] + gx_red + normA);
            acc[2] += (double)expf(f_m + tr[T_MM] + mm_red + normA);
            acc[3] += (double)expf(f_x + tr[T_XM] + mm_red + normA);
            acc[4] += (double)expf(f_y + tr[T_YM] + mm_red + normA);
            acc[5] += (double)expf(f_m + tr[T_MY] + gy_term + normA);
            acc[6] += (double)expf(f_y + tr[T_YY] + gy_term + normA);
          }
          bm = lae(lae(gx_red + tr[T_MX], mm_red + tr[T_MM]),
                   gy_term + tr[T_MY]);
          bx = lae(gx_red + tr[T_XX], mm_red + tr[T_XM]);
          by = lae(mm_red + tr[T_YM], gy_term + tr[T_YY]);
        }
      }
      if (!WIDE_ || c < N) {
        v.M(k, c) = bm;
        v.X(k, c) = bx;
        v.Y(k, c) = by;
      }
      tmax = fmaxf(tmax, fmaxf(bm, fmaxf(bx, by)));
    }
    // barrier 1; it also ends every read of diagonal d+2 in `cur`
    float m = block_reduce<false>(tmax, part);
    m = fin ? 0.f : (m > NEG * 0.5f ? m : 0.f);
    bo += (double)m;                                     // Bo(d)
    // absolute log posterior = f + b + cvecf[d] + Bo(d), b normalised
    const float cd = (float)(cv[d] + bo);

#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      bool surv = false;
      float p = 0.f;
      if (c < N) {
        const int o = c / P, q = c - o * P;
        const float bmn = fmaxf(v.M(k, c) - m, NEG);
        const float bxn = fmaxf(v.X(k, c) - m, NEG);
        const float byn = fmaxf(v.Y(k, c) - m, NEG);
        cur[MATCH * N + c] = bmn;
        cur[GAP_X * N + c] = bxn;
        cur[GAP_Y * N + c] = byn;
        if constexpr (STACK) {
          // from registers, as the forward writes its row; nothing in
          // the chain waits on these stores
          float* bd = bs + (size_t)d * 3 * N + q * W + o;
          bd[0] = bmn;
          bd[GAP_X * N] = bxn;
          bd[GAP_Y * N] = byn;
        }
        const int x = xd + o, y = d - x;
        if (o < wd && x > 0 && y > 0 && x <= pr.lX && y <= pr.lY) {
          const float fm = fs[(size_t)d * NF * N + q * W + o];
          p = expf(fmaxf(fm + bmn + cd, NEG));
          surv = p >= threshold;
        }
      }
      // survivors are ranked in cell (= offset, then path) order: chunk,
      // warp, lane
      const unsigned ball = __ballot_sync(0xffffffffu, surv);
      if (lane == 0) wcnt[k * 32 + warp] = __popc(ball);
      if (!WIDE_ || c < N) {
        su.V(k, c) = p;
        su.R(k, c) = surv ? __popc(ball & ((1u << lane) - 1u)) : -1;
      }
    }
    // barrier 2: publishes the normalised diagonal and the warp counts.
    // The next diagonal writes wcnt only after its barrier 1, which every
    // thread reaches after reading wcnt below.
    __syncthreads();
    // the wide instance's counts lie in its scratch: only a thread with
    // a survivor, and thread 0 for the diagonal's count, walks them
    bool mine = !WIDE_ || threadIdx.x == 0;
    if constexpr (WIDE_)
      for (int k = 0; k < nk; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        mine |= c < N && su.R(k, c) >= 0;
      }
    if (mine) {
      int before = 0;
#pragma unroll
      for (int k = 0; k < nk; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        const int rk = !WIDE_ || c < N ? su.R(k, c) : -1;
        int base = before;
        for (int w = 0; w < warp; ++w) base += wcnt[k * 32 + w];
        const int r = base + rk;
        if (rk >= 0 && r < R) {
          so[(size_t)d * R + r] = c;
          sv[(size_t)d * R + r] = su.V(k, c);
        }
        for (int w = 0; w < nw; ++w) before += wcnt[k * 32 + w];
      }
      if (threadIdx.x == 0) {
        inc[d] = m;
        cn[d] = before;
      }
    }
    m_prev = m;
  }
  const float l = block_lse(ring, pr.start, N, part);   // diagonal 0 = slot 0
  if (threadIdx.x == 0) lse_b[b] = l;
  if constexpr (SUMS) block_texp(acc, texp + (size_t)b * 7);
}

// ------------------------------------------- the cluster (wide) instance

// Past REG_CELLS cells a diagonal and up to the shared memory of
// CLUSTER_MAX blocks (CAP: cluster_cfg below), a problem runs on a
// thread-block cluster of C blocks on neighbouring SMs, the P > 2 design
// (same operations, same order, two cluster barriers a diagonal) split
// by band offset: block r owns offsets [r opc, (r + 1) opc), opc =
// ceil(W / C), with all P paths, so its cells c = o P + p are one run
// and the cluster's cell order is its blocks' order. Each block keeps
// its slice of the ring (2 slots x 3 planes x opc P floats) in its own
// shared memory and its cells in registers (K a thread, K <= MAX_K).
// A read of a neighbour offset (the forward's o + s1, o + s2, the
// backward's o + u1 (+1), o + u2: the band moves by a couple of offsets
// a diagonal, so only a block's edge offsets cross) takes the owner's
// ring through distributed shared memory (map_shared_rank), in place.
// Per diagonal:
// - barrier 1: each warp's max goes to its slot in every block's `part`
//   (one DSMEM store per lane r < C), one cluster barrier, then every
//   warp reduces the C x nw slots: all blocks hold the same m;
// - barrier 2: after the normalised terms (and the backward's survivor
//   counts) are written, one cluster barrier, split into arrive and wait
//   around the next diagonal's band origin and width;
// - survivors: a warp with survivors adds its count, by DSMEM atomics,
//   to the base of every higher-ranked block and to block 0's total
//   (by diagonal parity), so a block's ranks continue its lower
//   neighbours' in the cell order: the slots of the wcnt walk, with R as
//   before;
// - the forward stages its slice of the stack row (NF planes x P paths x
//   its offsets, row stride opc + 1 against bank conflicts) in shared
//   memory and writes each path's run of offsets contiguously after
//   barrier 2; the backward copies its slice of row d (cp.async, 4
//   bytes a thread, coalesced) into the same layout at the start of the
//   diagonal and reads the moments, the EXPECT transitions and the
//   posterior there (a warp's lanes then read neighbouring words, where
//   the strided reads of the (B, D1, NF, P, W) stack were W floats
//   apart). One stage buffer: P = 64 at W = 768 (49,152 cells, the widest
//   P <= 64 bucket of the runner) then fits 227 KB at C = 8;
// - EXPECT: texp by a block reduction and then the blocks' sums in rank
//   order (deterministic); kx by an atomic add in device memory from the
//   target cell's owner, one writer per (path, position) a diagonal, the
//   diagonals in barrier order: the sums keep their order. A target's
//   moments visit its legal source paths through the forward's masks
//   (leg_tgt, by target path), not all P masks of the backward's.
// The end logsumexps reduce over the cluster in rank, then warp, order.
constexpr int CLUSTER_MAX = 8;   // the portable cluster size
// shared memory a block may have on sm_90, and the room kept in it for
// the kernels' static arrays
constexpr size_t SMEM_OPTIN = 232448;
constexpr size_t SMEM_STATIC_ROOM = 6144;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");   // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");     // acquire
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// 4 bytes from device memory into shared memory, asynchronously; the
// thread waits with cp_async_wait, a barrier then publishes the words
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The offsets block `rank` of a C-block cluster owns: [o0, o0 + noff) of
// W, with all P paths (cells o0 P + i, i < nc). Every block lays its ring
// out with the plane stride ncs = opc P, and its stage with the row
// stride opc + 1.
struct Slice {
  int opc, o0, noff, ncs, nc, rank, C;
  __device__ Slice(int W, int P, int C_, int rank_) {
    C = C_;
    rank = rank_;
    opc = (W + C - 1) / C;
    o0 = min(rank * opc, W);
    noff = min(opc, W - o0);
    ncs = opc * P;
    nc = noff * P;
  }
  // the cells of band offset i (0 <= i < W) in plane `off` (a float
  // offset into a block's ring) of the block that owns it
  __device__ __forceinline__ float* at(cg::cluster_group& cl, float* ring,
                                       int off, int i, int P) const {
    const int r = i / opc;
    float* base = r == rank ? ring : cl.map_shared_rank(ring, (unsigned)r);
    return base + off + (i - r * opc) * P;
  }
};

// The max over the cluster of every thread's v: each warp's max goes to
// slot (rank, warp) of every block's `part` (lane r stores to block r),
// one cluster barrier, then each warp reduces the C x nw slots. The caller
// separates a reuse of `part` from these reads by a cluster barrier.
__device__ float cluster_max(cg::cluster_group& cl, float v, float* part,
                             const Slice& s) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane < s.C)
    *cl.map_shared_rank(part + s.rank * nw + warp, (unsigned)lane) = v;
  cluster_sync();
  float r = -INFINITY;
  for (int i = lane; i < s.C * nw; i += 32) r = fmaxf(r, part[i]);
  return warp_max(r);
}

// The sum over the cluster: each warp's sum (block_reduce's shuffles) to
// its slot of every block, one cluster barrier, then the slots in rank,
// then warp, order (block_reduce's order within a block).
__device__ float cluster_sum(cg::cluster_group& cl, float v, float* part,
                             const Slice& s) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane < s.C)
    *cl.map_shared_rank(part + s.rank * nw + warp, (unsigned)lane) = v;
  cluster_sync();
  float r = part[0];
  for (int i = 1; i < s.C * nw; ++i) r += part[i];
  return r;
}

// cluster_max/cluster_sum's logsumexp over the three states of this
// thread's cells in registers (block_lse_cells over the cluster); `pm`
// and `ps` are two partial arrays, so no barrier separates the two
// reductions
template <int K>
__device__ float cluster_lse_cells(cg::cluster_group& cl, const float (&vm)[K],
                                   const float (&vx)[K], const float (&vy)[K],
                                   const float* logs, int nk,
                                   const Slice& s, float* pm, float* ps) {
  float mx = NEG;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < nk && (int)threadIdx.x + k * (int)blockDim.x < s.nc) {
      mx = fmaxf(mx, fmaxf(vm[k] + logs[0], NEG));
      mx = fmaxf(mx, fmaxf(vx[k] + logs[1], NEG));
      mx = fmaxf(mx, fmaxf(vy[k] + logs[2], NEG));
    }
  mx = cluster_max(cl, mx, pm, s);
  float sm = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < nk && (int)threadIdx.x + k * (int)blockDim.x < s.nc) {
      sm += expf(fmaxf(vm[k] + logs[0], NEG) - mx);
      sm += expf(fmaxf(vx[k] + logs[1], NEG) - mx);
      sm += expf(fmaxf(vy[k] + logs[2], NEG) - mx);
    }
  sm = cluster_sum(cl, sm, ps, s);
  return logf(sm) + mx;
}

template <int K, bool HDP, bool EXPECT>
__global__ void __launch_bounds__(MAX_THREADS, 1) sa_fwd_cluster_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, int D1, int W, int P_, int LX, int LE,
    int C) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ Problem pr;
  __shared__ float pmax[CLUSTER_MAX * 32], psum[CLUSTER_MAX * 32];
  const int N = P_ * W;
  const int b = blockIdx.x / C;
  const Slice sl(W, P_, C, (int)cl.block_rank());
  const int ncs = sl.ncs, opcp = sl.opc + 1;
  constexpr int NF = EXPECT ? 3 : 1;   // states a diagonal's stack row keeps
  // [2 slots][3 source terms SRC_X, SRC_Y, SRC_M][ncs], cell (o - o0) P + p
  float* ring = smem;
  float* stage = smem + 6 * ncs;   // [NF][P][opc + 1]: this block's row
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE, b);
  const SrcTerms neg =
      src_terms(NEG, NEG, NEG, par_ + (size_t)b * NPACK + PACK_TRANS);
  for (int i = threadIdx.x; i < 6 * ncs; i += blockDim.x) {
    const int pl = (i / ncs) % 3;
    ring[i] = pl == SRC_X ? neg.x : pl == SRC_Y ? neg.y : neg.m;
  }
  __syncthreads();

  const int P = pr.P, NW = pr.NW;
  float* fs = fstack + (size_t)b * D1 * N * NF;   // (D1, NF, P, W)
  float* inc = f_incr + (size_t)b * D1;
  const int nd = pr.nd;
  const bool lead = sl.rank == 0 && threadIdx.x == 0;
  if (sl.rank == 0)
    for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;
  // diagonal 0: the single start cell (0, 0) on path 0, block 0's, slot 0
  if (lead) {
    const SrcTerms st = src_terms(pr.start[MATCH], pr.start[GAP_X],
                                  pr.start[GAP_Y], pr.t);
    ring[SRC_X * ncs] = st.x;
    ring[SRC_Y * ncs] = st.y;
    ring[SRC_M * ncs] = st.m;
    inc[0] = 0.f;
  }
  for (int c = sl.rank * blockDim.x + threadIdx.x; c < NF * N;
       c += C * blockDim.x)
    fs[c] = c % N == 0 ? pr.start[c / N] : NEG;
  // every block of the cluster runs, and its ring is set, before any
  // reads a neighbour's
  cluster_sync();

  // this block's part of the stack row of diagonal d, from the stage
  auto flush = [&](int d) {
    float* row = fs + (size_t)d * NF * N + sl.o0;
    const int pn = P * sl.noff;
    for (int e = threadIdx.x; e < NF * pn; e += blockDim.x) {
      const int s = e / pn, q = (e - s * pn) / sl.noff;
      const int j = e - s * pn - q * sl.noff;
      row[(size_t)s * N + q * W + j] = stage[(s * P + q) * opcp + j];
    }
  };

  const float* tr = pr.t;
  float m_prev = 0.f;
  const int T = blockDim.x;
  const int nk = (sl.nc + T - 1) / T;
  // this thread's cells (cell o0 P + threadIdx.x + k T) of the diagonal in
  // hand; after the loop, the normalised states of diagonal nd
  float vm[K], vx[K], vy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool start = sl.rank == 0 && threadIdx.x + k * T == 0;
    vm[k] = start ? pr.start[MATCH] : NEG;
    vx[k] = start ? pr.start[GAP_X] : NEG;
    vy[k] = start ? pr.start[GAP_Y] : NEG;
  }
  int xn = nd >= 1 ? pr.x0[1] : 0, wn = nd >= 1 ? pr.width[1] : 0;
  int xp = pr.x0[0], xpp = 0;   // x0 of d-1 and d-2
  for (int d = 1; d <= nd; ++d) {
    if (d >= 2) flush(d - 1);
    const int curoff = (d & 1) * 3 * ncs;   // slot of d, holds d-2
    const int p1off = ((d - 1) & 1) * 3 * ncs;
    float* cur = ring + curoff;
    const int xd = xn, wd = wn;
    const int s1 = xd - xp - 1;
    const int s2 = d >= 2 ? xd - xpp - 1 : W + 5;
    const int rs = clampi(xd, 0, pr.reflen - W);
    const int es = clampi(pr.lY - d + xd + pr.efp, 0, pr.evlen - W);

    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * T;   // cell of this block
      float mm = NEG, gx = NEG, gy = NEG;
      const int o = sl.o0 + i / P, p = i % P;
      if (k < nk && i < sl.nc && o < wd) {
        const int xr = rs + o, je = es + o;
        float e_match, e_stay;
        const float m_hat = pr.rf(0, p, xr), inv_m = pr.rf(1, p, xr);
        const float ev_mean = pr.ev[je];
        const bool kvalid = inv_m > 0.f;
        const bool ok = kvalid && pr.ev[pr.LE + je] > 0.5f;
        const unsigned* lw = pr.lg(xr, p);
        if constexpr (HDP) {
          e_match = e_stay = ok ? pr.hdp(p, xr, m_hat, ev_mean, h) : NEG;
        } else {
          const float c_m = pr.rf(2, p, xr), inv_y = pr.rf(3, p, xr),
                      c_y = pr.rf(4, p, xr);
          const float am = (ev_mean - m_hat) * inv_m;
          const float ay = (ev_mean - m_hat) * inv_y;
          e_match = ok ? c_m - 0.5f * am * am : NEG;
          e_stay = ok ? c_y - 0.5f * ay * ay : NEG;
        }
        const float e_gapx = kvalid ? pr.gapx : NEG;
        // gapX from (x-1, y) and match from (x-1, y-1) over the legal
        // source paths, from whichever block owns those offsets
        const int il = o + s1, im = o + s2;
        const float* rx =
            il >= 0 && il < W ? sl.at(cl, ring, p1off + SRC_X * ncs, il, P)
                              : nullptr;
        const float* rm =
            im >= 0 && im < W ? sl.at(cl, ring, curoff + SRC_M * ncs, im, P)
                              : nullptr;
        gx = legal_lse_any(rx, neg.x, 0.f, lw, NW, P) + e_gapx;
        mm = legal_lse_any(rm, neg.m, m_prev, lw, NW, P) + e_match;
        const int iy = il + 1;   // gapY from (x, y-1), same path
        gy = (iy >= 0 && iy < W
                  ? sl.at(cl, ring, p1off + SRC_Y * ncs, iy, P)[p]
                  : neg.y) +
             e_stay;
      }
      vm[k] = mm;
      vx[k] = gx;
      vy[k] = gy;
      tmax = fmaxf(tmax, fmaxf(mm, fmaxf(gx, gy)));
    }
    // barrier 1; it also ends every read of diagonal d-2 in `cur`
    float m = cluster_max(cl, tmax, pmax, sl);
    m = m > NEG * 0.5f ? m : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * T;
      if (k < nk && i < sl.nc) {
        const int ol = i / P, p = i % P;
        const float mm = fmaxf(vm[k] - m, NEG);
        const float gx = fmaxf(vx[k] - m, NEG);
        const float gy = fmaxf(vy[k] - m, NEG);
        const SrcTerms st = src_terms(mm, gx, gy, tr);
        cur[SRC_X * ncs + i] = st.x;
        cur[SRC_Y * ncs + i] = st.y;
        cur[SRC_M * ncs + i] = st.m;
        vm[k] = mm;
        vx[k] = gx;
        vy[k] = gy;
        float* sd = stage + p * opcp + ol;
        sd[0] = mm;
        if constexpr (EXPECT) {
          sd[GAP_X * P * opcp] = gx;
          sd[GAP_Y * P * opcp] = gy;
        }
      }
    }
    if (lead) inc[d] = m;
    m_prev = m;
    // barrier 2: publishes the terms and the stage; the next diagonal's
    // band origin and width load in between
    cluster_arrive();
    xpp = xp;
    xp = xd;
    if (d < nd) {
      xn = pr.x0[d + 1];
      wn = pr.width[d + 1];
    }
    cluster_wait();
  }
  if (nd >= 1) flush(nd);
  const float l =
      cluster_lse_cells<K>(cl, vm, vx, vy, pr.end, nk, sl, pmax, psum);
  if (lead) lse_f[b] = l;
}

template <int K, bool HDP, bool EXPECT>
__global__ void __launch_bounds__(MAX_THREADS, 1) sa_bwd_cluster_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    const float* __restrict__ fstack,
    const double* __restrict__ cvecf, float* __restrict__ b_incr,
    float* __restrict__ lse_b, int* __restrict__ slot_cell,
    float* __restrict__ slot_val, int* __restrict__ cnt,
    double* __restrict__ texp, double* __restrict__ kx,
    const unsigned* __restrict__ leg_tgt_, int D1, int W, int P_, int LX,
    int LE, int R, float threshold, int C) {
  constexpr bool MOMENTS = EXPECT && !HDP;
  constexpr int NF = EXPECT ? 3 : 1;   // forward states a stack row holds
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ Problem pr;
  __shared__ float pmax[CLUSTER_MAX * 32], psum[CLUSTER_MAX * 32];
  __shared__ int wcnt[MAX_K * 32];   // [k][warp] survivors of a chunk
  // by diagonal parity: survivors of the lower-ranked blocks, and (block
  // 0) of the whole cluster
  __shared__ int cbase[2], ctot[2];
  __shared__ double tsum[7];
  const int N = P_ * W;
  const int b = blockIdx.x / C;
  const Slice sl(W, P_, C, (int)cl.block_rank());
  const int ncs = sl.ncs, opcp = sl.opc + 1;
  float* ring = smem;              // [2 slots][3 states][ncs]
  float* stage = smem + 6 * ncs;   // [NF][P][opc + 1]: this block's row
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE, b);
  for (int i = threadIdx.x; i < 6 * ncs; i += blockDim.x) ring[i] = NEG;
  if (threadIdx.x < 2) cbase[threadIdx.x] = ctot[threadIdx.x] = 0;
  __syncthreads();

  const int P = pr.P, NW = pr.NW;
  const float* fs = fstack + (size_t)b * D1 * N * NF;
  const double* cv = cvecf + (size_t)b * D1;
  double* kb = MOMENTS ? kx + (size_t)b * 3 * P * LX : nullptr;
  // MOMENTS: the forward's legality masks (by target path: bit q, legal
  // from source path q), so a target visits its legal sources only
  const unsigned* ltb =
      MOMENTS ? leg_tgt_ + (size_t)b * LX * P * NW : nullptr;
  double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  float* inc = b_incr + (size_t)b * D1;
  int* so = slot_cell + (size_t)b * D1 * R;
  float* sv = slot_val + (size_t)b * D1 * R;
  int* cn = cnt + (size_t)b * D1;
  const int nd = pr.nd;
  const bool lead = sl.rank == 0 && threadIdx.x == 0;
  if (sl.rank == 0)
    for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) {
      inc[d] = 0.f;
      cn[d] = 0;
    }
  cluster_sync();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int T = blockDim.x;
  const int nk = (sl.nc + T - 1) / T;
  const float* tr = pr.t;
  // NEG outside the band, else state s of offset i on path p in the ring
  // plane at `off` of its owner
  auto rd_c = [&](int off, int s, int i, int p) {
    return i >= 0 && i < W ? sl.at(cl, ring, off + s * ncs, i, P)[p] : NEG;
  };
  float m_prev = 0.f;
  double bo = 0.0;   // running backward offset: Bo(d) = sum of m over >= d
  float vm[K], vx[K], vy[K];   // this thread's cells of the diagonal
  float pk[K];                 // and their posteriors
  int rk[K];                   // and ranks inside their warp (-1: none)
  int xd = pr.x0[nd], wd = pr.width[nd];
  int x1 = nd + 1 < D1 ? pr.x0[nd + 1] : 0;   // x0 of d+1
  int x2 = 0;                                   // and of d+2
  for (int d = nd; d >= 0; --d) {
    // this block's slice of stack row d into the stage: its last reads
    // (row d+1) ended before barrier 2 of d+1
    {
      const float* row = fs + (size_t)d * NF * N + sl.o0;
      const int pn = P * sl.noff;
      for (int e = threadIdx.x; e < NF * pn; e += blockDim.x) {
        const int s = e / pn, q = (e - s * pn) / sl.noff;
        const int j = e - s * pn - q * sl.noff;
        cp_async4(stage + (s * P + q) * opcp + j, row + (size_t)s * N + q * W + j);
      }
    }
    const int curoff = (d & 1) * 3 * ncs;   // slot of d, holds d+2
    const int b1off = ((d + 1) & 1) * 3 * ncs;
    float* cur = ring + curoff;
    const bool fin = d == nd;
    const int u1 = d + 1 < D1 ? xd - x1 : W + 5;
    const int u2 = d + 2 < D1 ? xd + 1 - x2 : W + 5;
    const int r1 = clampi(xd + 1, 0, pr.reflen - W);
    const int r0 = clampi(xd, 0, pr.reflen - W);
    const int es = clampi(pr.lY - d + xd + pr.efp - 1, 0, pr.evlen - W);
    // the target-side terms of this thread's cells (o, p), once each, to
    // the gapX and gapY planes of `cur` (dead at this step: diagonal
    // d+2's gapX and gapY were read at d+1)
    if (!fin) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = threadIdx.x + k * T;
        const int o = sl.o0 + i / P, p = i % P;
        if (k < nk && i < sl.nc && o < wd) {
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
          cur[GAP_X * ncs + i] = rd_c(b1off, GAP_X, o + u1 + 1, p) + gapx_valid;
          cur[GAP_Y * ncs + i] =
              rd_c(curoff, MATCH, o + u2, p) + e_match_to - m_prev;
        }
      }
    }
    if constexpr (EXPECT) {
      // the stage row is read from here on
      cp_async_wait();
      __syncthreads();
    } else if (32 % P == 0) {
      __syncwarp();   // an offset's P cells share a warp
    } else {
      __syncthreads();
    }
    if constexpr (MOMENTS) {
      // the into-match posterior of each target (x+1, y+1) on path p of
      // this thread, summed over the source paths q at (x, y) it may
      // follow (bit p of legal[., q] at x+1), its term tmm read back from
      // `cur`; normalised to Bo(d+1), which `bo` still holds here
      if (!fin) {
        const float normA = (float)(cv[d] + bo);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = threadIdx.x + k * T;
          const int ol = i / P, o = sl.o0 + ol, p = i % P;
          if (k < nk && i < sl.nc && o < wd) {
            const int xr1 = r1 + o, je = es + o;
            const float tmm = cur[GAP_Y * ncs + i];
            const unsigned* lt = ltb + ((size_t)xr1 * P + p) * NW;
            float mtp = 0.f;   // the legal source paths q in path order
            for (int w = 0; w < NW; ++w)
              for (unsigned mq = lt[w]; mq; mq &= mq - 1) {
                const float* f = stage + (32 * w + __ffs(mq) - 1) * opcp + ol;
                mtp += expf(f[MATCH * P * opcp] + tr[T_MM] + tmm + normA) +
                       expf(f[GAP_X * P * opcp] + tr[T_XM] + tmm + normA) +
                       expf(f[GAP_Y * P * opcp] + tr[T_YM] + tmm + normA);
              }
            if (mtp != 0.f) {
              const float ev_mean = pr.ev[je];
              const float m_hat1 = pr.rf(0, p, xr1), inv_m1 = pr.rf(1, p, xr1);
              const float dxv =
                  inv_m1 > 0.f ? (ev_mean - m_hat1) / pr.var : 0.f;
              double* kc = kb + (size_t)p * LX + xr1;
              const size_t plane = (size_t)P * LX;
              // device-memory atomics: the owner of this target adds in
              // diagonal order (the barriers), whichever block held the
              // position on earlier diagonals
              atomicAdd(kc, (double)mtp);
              atomicAdd(kc + plane, (double)(mtp * dxv));
              atomicAdd(kc + 2 * plane, (double)(mtp * dxv * dxv));
            }
          }
        }
      }
    }
    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * T;
      float bm = NEG, bx = NEG, by = NEG;
      const int ol = i / P, o = sl.o0 + ol, q = i % P;   // q: source path
      if (k < nk && i < sl.nc && o < wd) {
        if (fin) {
          bm = pr.end[MATCH];
          bx = pr.end[GAP_X];
          by = pr.end[GAP_Y];
        } else {
          const int xr1 = r1 + o, xr0 = r0 + o, je = es + o;
          const float ev_mean = pr.ev[je];
          const bool evok = pr.ev[pr.LE + je] > 0.5f;
          float e_stay_same;   // gapY TO cell (x, y+1) on the same path
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
          const float gy_term = rd_c(b1off, GAP_Y, o + u1, q) + e_stay_same;
          // gapX TO (x+1, y) and match TO (x+1, y+1) over the target
          // paths p that may follow q (legal[p, q] at x+1): this block's
          const unsigned* lw = pr.lg(xr1, q);
          const float gx_red = legal_lse_any(cur + GAP_X * ncs + ol * P, NEG,
                                             0.f, lw, NW, P);
          const float mm_red = legal_lse_any(cur + GAP_Y * ncs + ol * P, NEG,
                                             0.f, lw, NW, P);
          if constexpr (EXPECT) {
            const float normA = (float)(cv[d] + bo);
            const float* f = stage + q * opcp + ol;
            const float f_m = f[MATCH * P * opcp], f_x = f[GAP_X * P * opcp],
                        f_y = f[GAP_Y * P * opcp];
            acc[0] += (double)expf(f_m + tr[T_MX] + gx_red + normA);
            acc[1] += (double)expf(f_x + tr[T_XX] + gx_red + normA);
            acc[2] += (double)expf(f_m + tr[T_MM] + mm_red + normA);
            acc[3] += (double)expf(f_x + tr[T_XM] + mm_red + normA);
            acc[4] += (double)expf(f_y + tr[T_YM] + mm_red + normA);
            acc[5] += (double)expf(f_m + tr[T_MY] + gy_term + normA);
            acc[6] += (double)expf(f_y + tr[T_YY] + gy_term + normA);
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
    if constexpr (!EXPECT) cp_async_wait();   // the posterior's row
    // barrier 1; it also ends every read of diagonal d+2 in `cur` and,
    // in every block, of the counts of diagonal d+1's parity
    float m = cluster_max(cl, tmax, pmax, sl);
    if (threadIdx.x == 0) cbase[(d + 1) & 1] = ctot[(d + 1) & 1] = 0;
    m = fin ? 0.f : (m > NEG * 0.5f ? m : 0.f);
    bo += (double)m;                                     // Bo(d)
    // absolute log posterior = f + b + cvecf[d] + Bo(d), b normalised
    const float cd = (float)(cv[d] + bo);
    int nsurv = 0;   // this warp's survivors of the diagonal
    bool mine = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * T;
      if (k < nk) {
        bool surv = false;
        float p = 0.f;
        if (i < sl.nc) {
          const int ol = i / P, q = i % P;
          const float bmn = fmaxf(vm[k] - m, NEG);
          vx[k] = fmaxf(vx[k] - m, NEG);
          vy[k] = fmaxf(vy[k] - m, NEG);
          cur[MATCH * ncs + i] = bmn;
          cur[GAP_X * ncs + i] = vx[k];
          cur[GAP_Y * ncs + i] = vy[k];
          vm[k] = bmn;
          const int x = xd + sl.o0 + ol, y = d - x;
          if (sl.o0 + ol < wd && x > 0 && y > 0 && x <= pr.lX && y <= pr.lY) {
            const float fm = stage[q * opcp + ol];
            p = expf(fmaxf(fm + bmn + cd, NEG));
            surv = p >= threshold;
          }
        }
        // ranked in cell (= offset, then path) order: block, chunk,
        // warp, lane
        const unsigned ball = __ballot_sync(0xffffffffu, surv);
        if (lane == 0) wcnt[k * 32 + warp] = __popc(ball);
        nsurv += __popc(ball);
        pk[k] = p;
        rk[k] = surv ? __popc(ball & ((1u << lane) - 1u)) : -1;
        mine |= surv;
      }
    }
    if (nsurv) {
      if (lane > sl.rank && lane < C)
        atomicAdd(cl.map_shared_rank(cbase + (d & 1), (unsigned)lane), nsurv);
      if (lane == 0)
        atomicAdd(cl.map_shared_rank(ctot + (d & 1), 0u), nsurv);
    }
    // barrier 2: publishes the normalised diagonal, the warp counts and
    // the blocks' bases; the next diagonal's band origin and width load
    // in between. The next diagonal writes wcnt and this parity's bases
    // only after its barrier 1, which every thread reaches after reading
    // them below.
    cluster_arrive();
    x2 = x1;
    x1 = xd;
    if (d > 0) {
      xd = pr.x0[d - 1];
      wd = pr.width[d - 1];
    }
    cluster_wait();
    if (mine) {
      int before = cbase[d & 1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= nk) break;
        int base = before;
        for (int w = 0; w < warp; ++w) base += wcnt[k * 32 + w];
        const int r = base + rk[k];
        if (rk[k] >= 0 && r < R) {
          so[(size_t)d * R + r] = sl.o0 * P + threadIdx.x + k * T;
          sv[(size_t)d * R + r] = pk[k];
        }
        for (int w = 0; w < nw; ++w) before += wcnt[k * 32 + w];
      }
    }
    if (lead) {
      inc[d] = m;
      cn[d] = ctot[d & 1];
    }
    m_prev = m;
  }
  // diagonal 0 is slot 0: its normalised states are this thread's cells
  const float l =
      cluster_lse_cells<K>(cl, vm, vx, vy, pr.start, nk, sl, pmax, psum);
  if (lead) lse_b[b] = l;
  if constexpr (EXPECT) {
    block_texp(acc, tsum);
    cluster_sync();
    if (sl.rank == 0 && threadIdx.x < 7) {
      double s = 0.0;
      for (int r = 0; r < C; ++r)
        s += cl.map_shared_rank(tsum, (unsigned)r)[threadIdx.x];
      texp[(size_t)b * 7 + threadIdx.x] = s;
    }
    cluster_sync();   // block 0 has read every block's sums
  }
}

// ------------------------------------------------- P <= 2 (per-pair) instances

// One forward cell's inputs at its column: the reference rows of its path
// (Gaussian: m_hat, inv_m, c_m, inv_y, c_y; HDP: m_hat, inv_m and the
// k-mer id and level mean), its event's mean and mask, and its legality
// mask (bit q: legal from source path q).
struct FwdIn {
  float m_hat, inv_m, c_m, inv_y, c_y, mu, ev_mean;
  int kid;
  bool ev_ok;
  unsigned lb;
};

template <bool HDP>
__device__ __forceinline__ FwdIn load_fwd_in(const Problem& pr, int p, int xr,
                                             int je) {
  FwdIn a;
  const size_t i = (size_t)p * pr.LX + xr;
  const size_t rows = (size_t)pr.P * pr.LX;
  a.m_hat = __ldg(pr.ref + i);
  a.inv_m = __ldg(pr.ref + rows + i);
  if constexpr (HDP) {
    a.mu = __ldg(pr.mu + i);
    a.kid = __ldg(pr.kid + i);
  } else {
    a.c_m = __ldg(pr.ref + 2 * rows + i);
    a.inv_y = __ldg(pr.ref + 3 * rows + i);
    a.c_y = __ldg(pr.ref + 4 * rows + i);
  }
  a.ev_mean = __ldg(pr.ev + je);
  a.ev_ok = __ldg(pr.ev + pr.LE + je) > 0.5f;
  a.lb = __ldg(pr.leg + (size_t)xr * pr.P + p);
  return a;
}

// state s of band offset i on path p of a ring slot of raw states stored
// clamped at NEG, normalised by its diagonal's max m: NEG outside the
// band. For a stored v >= NEG, v - m equals the twin's fmaxf(raw - m,
// NEG) bit for bit: NEG - m rounds to NEG for any |m| below half an ulp
// of 1e30 (2^75), and a finite v - m stays above NEG.
__device__ __forceinline__ float rdn(const float* slot, int s, int i, int p,
                                     int W, int N, int P, float m) {
  return (i >= 0 && i < W) ? slot[s * N + i * P + p] - m : NEG;
}

// The diagonal's one barrier: the block's (a warp's, for a block of one
// warp) after each warp's max went to part[par * 32 + warp]; returns the
// block max of `wmax` (this warp's max).
__device__ __forceinline__ float diag_barrier_max(float wmax, const float* part,
                                                  int par, int nw) {
  if (nw == 1) {
    __syncwarp();
    return wmax;
  }
  __syncthreads();
  float m = part[par * 32];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, part[par * 32 + w]);
  return m;
}

template <int K, bool HDP, bool EXPECT>
__global__ void __launch_bounds__(PAIR_THREADS) sa_fwd_pair_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    float* __restrict__ fstack, float* __restrict__ f_incr,
    float* __restrict__ lse_f, int D1, int W, int P_, int LX, int LE) {
  extern __shared__ float smem[];
  const int N = P_ * W;
  // [3 slots][3 states][N] raw states clamped at NEG, cell o*P + p
  float* ring = smem;
  float* part = smem + 9 * N;      // [2 parities][32] per-warp maxima
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE);
  for (int i = threadIdx.x; i < 9 * N; i += blockDim.x) ring[i] = NEG;
  __syncthreads();

  const int b = blockIdx.x;
  const int P = P_;
  const int nd = pr.nd, last = D1 - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // (D1, P, W); EXPECT: (D1, 3, P, W)
  float* fs = fstack + (size_t)b * D1 * N * (EXPECT ? 3 : 1);
  float* inc = f_incr + (size_t)b * D1;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) inc[d] = 0.f;
  if constexpr (EXPECT) {
    for (int c = threadIdx.x; c < 3 * N; c += blockDim.x)
      fs[c] = c % N == 0 ? pr.start[c / N] : NEG;
  } else {
    for (int c = threadIdx.x; c < N; c += blockDim.x)
      fs[c] = c == 0 ? pr.start[MATCH] : NEG;
  }
  // diagonal 0: the single start cell (0, 0) on path 0, in slot 0; its
  // max is 0. A start log of -inf reads as NEG, which gives the twin's
  // results: every logaddexp that reads it has a finite other term.
  if (threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) ring[s * N] = fmaxf(pr.start[s], NEG);
    inc[0] = 0.f;
  }
  // band origins of d-2, d-1, d (with its width) and d+1 (with its
  // width): each loaded two diagonals ahead
  int xm2 = 0, xm1 = pr.x0[0];
  int xd = pr.x0[min(1, last)], wd = pr.width[min(1, last)];
  int xn = pr.x0[min(2, last)], wn = pr.width[min(2, last)];
  const float* t = pr.t;
  float m1 = 0.f, m2 = 0.f;   // the maxima of diagonals d-1 and d-2
  // this thread's cells of diagonal d: raw until its barrier, normalised
  // after; after the loop, those of diagonal nd
  float vm[K], vx[K], vy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool c0 = threadIdx.x + k * blockDim.x == 0;
    vm[k] = c0 ? pr.start[MATCH] : NEG;
    vx[k] = c0 ? pr.start[GAP_X] : NEG;
    vy[k] = c0 ? pr.start[GAP_Y] : NEG;
  }
  __syncthreads();

  for (int d = 1; d <= nd; ++d) {
    const float* p1 = ring + ((d + 2) % 3) * 3 * N;   // diagonal d-1
    const float* p2 = ring + ((d + 1) % 3) * 3 * N;   // diagonal d-2
    float* cur = ring + (d % 3) * 3 * N;
    const int s1 = xd - xm1 - 1;
    const int s2 = d >= 2 ? xd - xm2 - 1 : W + 5;
    const int rs = clampi(xd, 0, pr.reflen - W);
    const int es = clampi(pr.lY - d + xd + pr.efp, 0, pr.evlen - W);

    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      float mm = NEG, gx = NEG, gy = NEG;
      const int o = c / P, p = c - o * P;
      if (c < N && o < wd) {
        const FwdIn a = load_fwd_in<HDP>(pr, p, rs + o, es + o);
        const bool kvalid = a.inv_m > 0.f;
        const bool ok = kvalid && a.ev_ok;
        float e_match, e_stay;
        if constexpr (HDP) {
          // stay = match (emissions_signal_getHdpKmerDensity)
          e_match = e_stay =
              ok ? hdp_log_emission(a.mu + (a.ev_mean - a.m_hat) / pr.var,
                                    a.kid, pr.var, h)
                 : NEG;
        } else {
          const float am = (a.ev_mean - a.m_hat) * a.inv_m;
          const float ay = (a.ev_mean - a.m_hat) * a.inv_y;
          e_match = ok ? a.c_m - 0.5f * am * am : NEG;
          e_stay = ok ? a.c_y - 0.5f * ay * ay : NEG;
        }
        const float e_gapx = kvalid ? pr.gapx : NEG;

        // gapX from (x-1, y) and match from (x-1, y-1), over the legal
        // source paths q
        const int il = o + s1, im = o + s2;
        float srx[PAIR_P], srm[PAIR_P];
#pragma unroll
        for (int q = 0; q < PAIR_P; ++q) {
          if (q < P) {
            const bool leg = (a.lb >> q) & 1u;
            const float sx =
                lae(rdn(p1, MATCH, il, q, W, N, P, m1) + t[T_MX],
                    rdn(p1, GAP_X, il, q, W, N, P, m1) + t[T_XX]);
            const float sm =
                lae(lae(rdn(p2, MATCH, im, q, W, N, P, m2) + t[T_MM],
                        rdn(p2, GAP_X, im, q, W, N, P, m2) + t[T_XM]),
                    rdn(p2, GAP_Y, im, q, W, N, P, m2) + t[T_YM]) - m1;
            srx[q] = leg ? sx : NEG;
            srm[q] = leg ? sm : NEG;
          }
        }
        gx = (P == 1 ? srx[0] : legal_lse(srx, P)) + e_gapx;
        mm = (P == 1 ? srm[0] : legal_lse(srm, P)) + e_match;
        // gapY from (x, y-1), same path
        gy = lae(rdn(p1, MATCH, il + 1, p, W, N, P, m1) + t[T_MY],
                 rdn(p1, GAP_Y, il + 1, p, W, N, P, m1) + t[T_YY]) + e_stay;
      }
      vm[k] = mm;
      vx[k] = gx;
      vy[k] = gy;
      tmax = fmaxf(tmax, fmaxf(mm, fmaxf(gx, gy)));
      if (c < N) {
        cur[MATCH * N + c] = fmaxf(mm, NEG);
        cur[GAP_X * N + c] = fmaxf(gx, NEG);
        cur[GAP_Y * N + c] = fmaxf(gy, NEG);
      }
    }
    tmax = warp_max(tmax);
    if (nw > 1 && lane == 0) part[(d & 1) * 32 + warp] = tmax;
    // the band of d+2, issued before the barrier and read after it
    const int xnn = pr.x0[min(d + 2, last)], wnn = pr.width[min(d + 2, last)];
    float m = diag_barrier_max(tmax, part, d & 1, nw);
    m = m > NEG * 0.5f ? m : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      vm[k] = fmaxf(vm[k] - m, NEG);
      vx[k] = fmaxf(vx[k] - m, NEG);
      vy[k] = fmaxf(vy[k] - m, NEG);
      if (c < N) {
        const int o = c / P, p = c - o * P;
        if constexpr (EXPECT) {
          float* fd = fs + (size_t)d * 3 * N + p * W + o;
          fd[MATCH * N] = vm[k];
          fd[GAP_X * N] = vx[k];
          fd[GAP_Y * N] = vy[k];
        } else {
          fs[(size_t)d * N + p * W + o] = vm[k];
        }
      }
    }
    if (threadIdx.x == 0) inc[d] = m;
    m2 = m1;
    m1 = m;
    xm2 = xm1;
    xm1 = xd;
    xd = xn;
    wd = wn;
    xn = xnn;
    wn = wnn;
  }
  const float l = block_lse_cells<K>(vm, vx, vy, pr.end, N, part);
  if (threadIdx.x == 0) lse_f[b] = l;
}

// One backward cell's inputs at its columns: its event's mean and mask;
// its stay target (x, y+1) on its own path q (m_hat, inv_m, and Gaussian
// inv_y, c_y or HDP k-mer id and level mean, at x); its match and gapX
// targets on every path p < P at x+1 (m_hat, inv_m, and Gaussian c_m or
// HDP k-mer id and level mean); and which of those may follow q (bit p:
// legal[p, q] at x+1).
struct BwdIn {
  float ev_mean;
  bool ev_ok;
  float m_hat0, inv_m0, inv_y0, c_y0, mu0;
  int kid0;
  float m_hat1[PAIR_P], inv_m1[PAIR_P], c_m1[PAIR_P], mu1[PAIR_P];
  int kid1[PAIR_P];
  unsigned lw;
};

template <bool HDP>
__device__ __forceinline__ BwdIn load_bwd_in(const Problem& pr, int q,
                                             int xr0, int xr1, int je) {
  BwdIn a;
  const int P = pr.P;
  const size_t rows = (size_t)P * pr.LX;
  a.ev_mean = __ldg(pr.ev + je);
  a.ev_ok = __ldg(pr.ev + pr.LE + je) > 0.5f;
  const size_t i0 = (size_t)q * pr.LX + xr0;
  a.m_hat0 = __ldg(pr.ref + i0);
  a.inv_m0 = __ldg(pr.ref + rows + i0);
  if constexpr (HDP) {
    a.mu0 = __ldg(pr.mu + i0);
    a.kid0 = __ldg(pr.kid + i0);
  } else {
    a.inv_y0 = __ldg(pr.ref + 3 * rows + i0);
    a.c_y0 = __ldg(pr.ref + 4 * rows + i0);
  }
  a.lw = __ldg(pr.leg + (size_t)xr1 * P + q);
#pragma unroll
  for (int p = 0; p < PAIR_P; ++p) {
    if (p < P) {
      const size_t i1 = (size_t)p * pr.LX + xr1;
      a.m_hat1[p] = __ldg(pr.ref + i1);
      a.inv_m1[p] = __ldg(pr.ref + rows + i1);
      if constexpr (HDP) {
        a.mu1[p] = __ldg(pr.mu + i1);
        a.kid1[p] = __ldg(pr.kid + i1);
      } else {
        a.c_m1[p] = __ldg(pr.ref + 2 * rows + i1);
      }
    }
  }
  return a;
}

// Add an into-match posterior mtp and its moments (dx = dxv) at
// reference position pos on path q to the per-pair EXPECT window: slot
// (pos mod W) * P + q of kxw [3][N] (tagged with its position in ktag
// [N]); a slot whose position left the window first adds its sums to kb
// (3, P, LX) in device memory, without waiting. One writer per slot a
// diagonal, the diagonals in barrier order.
__device__ __forceinline__ void window_add(double* kxw, int* ktag, double* kb,
                                           int W, int N, int P, int LX,
                                           int pos, int q, float mtp,
                                           float dxv) {
  const int sl = (pos % W) * P + q;
  if (ktag[sl] != pos) {
    if (ktag[sl] >= 0)
      for (int r = 0; r < 3; ++r)
        atomicAdd(kb + ((size_t)r * P + q) * LX + ktag[sl], kxw[r * N + sl]);
    ktag[sl] = pos;
    for (int r = 0; r < 3; ++r) kxw[r * N + sl] = 0.0;
  }
  kxw[sl] += (double)mtp;
  kxw[N + sl] += (double)(mtp * dxv);
  kxw[2 * N + sl] += (double)(mtp * dxv * dxv);
}

// MP: the paths whose moments the EXPECT window sums, 1 or (a Gaussian
// expectation bucket of P = 2) 2; the P = 1 instances compile without
// the two-path code
template <int K, bool HDP, bool EXPECT, int MP = 1>
__global__ void __launch_bounds__(PAIR_THREADS) sa_bwd_pair_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    const float* __restrict__ fstack,
    const double* __restrict__ cvecf, float* __restrict__ b_incr,
    float* __restrict__ lse_b, int* __restrict__ slot_cell,
    float* __restrict__ slot_val, int* __restrict__ cnt,
    double* __restrict__ texp, double* __restrict__ kx, int D1, int W,
    int P_, int LX, int LE, int R, float threshold) {
  constexpr bool MOMENTS = EXPECT && !HDP;
  constexpr int NF = EXPECT ? 3 : 1;   // forward states a cell reads
  extern __shared__ double smem_d[];
  const int N = P_ * W;
  // MOMENTS: [3][N] the window of per-(position, path) moment sums, slot
  // (x mod W) * P + p
  double* kxw = smem_d;
  float* ring = reinterpret_cast<float*>(smem_d + (MOMENTS ? 3 * N : 0));
  // [3 slots][3 states][N] raw states clamped at NEG, cell o*P + p
  float* part = ring + 9 * N;                        // [2 parities][32]
  int* wcnt = reinterpret_cast<int*>(part + 64);     // [2 parities][K][32]
  int* ktag = wcnt + 2 * K * 32;                     // MOMENTS: [N] positions
  __shared__ Problem pr;
  if (threadIdx.x == 0)
    pr.load(x0_, width_, ref_, leg_, ev_, meta_, par_, h, D1, P_, LX, LE);
  for (int i = threadIdx.x; i < 9 * N; i += blockDim.x) ring[i] = NEG;
  if constexpr (MOMENTS)
    for (int i = threadIdx.x; i < N; i += blockDim.x) ktag[i] = -1;
  __syncthreads();

  const int b = blockIdx.x;
  const int P = P_;
  const int nd = pr.nd, last = D1 - 1;
  const float* fs = fstack + (size_t)b * D1 * N * NF;
  const double* cv = cvecf + (size_t)b * D1;
  float* inc = b_incr + (size_t)b * D1;
  int* so = slot_cell + (size_t)b * D1 * R;
  float* sv = slot_val + (size_t)b * D1 * R;
  int* cn = cnt + (size_t)b * D1;
  double* kb = MOMENTS ? kx + (size_t)b * 3 * P * LX : nullptr;
  for (int d = nd + 1 + threadIdx.x; d < D1; d += blockDim.x) {
    inc[d] = 0.f;
    cn[d] = 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  // this thread's forward states of diagonal d-1 (the posterior's match,
  // and EXPECT's three), loaded during diagonal d
  float fin_[K][NF];
  auto stage = [&](int dn, int wdn) {
    const float* fd = fs + (size_t)dn * N * NF;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      const int o = c / P, q = c - o * P;
      if (c < N && o < wdn) {
#pragma unroll
        for (int s = 0; s < NF; ++s) fin_[k][s] = __ldg(fd + s * N + q * W + o);
      }
    }
  };
  // band origins of d+2, d+1, d (with its width), d-1 (with its width),
  // each loaded two diagonals ahead; cvecf of d, loaded one ahead
  int xp2 = pr.x0[min(nd + 2, last)], xp1 = pr.x0[min(nd + 1, last)];
  int xd = pr.x0[nd], wd = pr.width[nd];
  int xn = pr.x0[max(nd - 1, 0)], wn = pr.width[max(nd - 1, 0)];
  double cv_d = cv[nd];
  stage(nd, wd);
  const float* t = pr.t;
  float m1 = 0.f, m2 = 0.f;   // the maxima of diagonals d+1 and d+2
  double bo = 0.0;   // running backward offset: Bo(d) = sum of m over >= d
  // EXPECT: this thread's sums of the seven transition posteriors, in the
  // order of texp's rows (mx, xx, mm, xm, ym, my, yy)
  double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  // this thread's cells of diagonal d (raw until its barrier, then
  // normalised), and its survivors of the diagonal before (d+1): value
  // per chunk and rank inside its warp (-1 for none), whose slots are
  // written once the next barrier has published the warp counts
  float vm[K], vx[K], vy[K], pk[K];
  int rk[K];

  for (int d = nd; d >= 0; --d) {
    const bool fin = d == nd;
    const float* b1 = ring + ((d + 1) % 3) * 3 * N;   // diagonal d+1
    const float* b2 = ring + ((d + 2) % 3) * 3 * N;   // diagonal d+2
    float* cur = ring + (d % 3) * 3 * N;
    const int u1 = d + 1 < D1 ? xd - xp1 : W + 5;
    const int u2 = d + 2 < D1 ? xd + 1 - xp2 : W + 5;
    const int r1 = clampi(xd + 1, 0, pr.reflen - W);
    const int r0 = clampi(xd, 0, pr.reflen - W);
    const int es = clampi(pr.lY - d + xd + pr.efp - 1, 0, pr.evlen - W);
    float fpost[K];   // the forward match of each cell, for the posterior
    float tmax = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      float bm = NEG, bx = NEG, by = NEG;
      const int o = c / P, q = c - o * P;   // q: this cell's (source) path
      fpost[k] = fin_[k][MATCH];
      // MOMENTS at P = 2: the into-match posteriors from this source cell
      // to its target on path q and on the other path, and the moments'
      // dx of the target on path q (this thread adds that target's sum)
      float pm_own = 0.f, pm_other = 0.f, dx_own = 0.f;
      if (c < N && o < wd) {
        if (fin) {
          bm = pr.end[MATCH];
          bx = pr.end[GAP_X];
          by = pr.end[GAP_Y];
        } else {
          const BwdIn a = load_bwd_in<HDP>(pr, q, r0 + o, r1 + o, es + o);
          const float ev_mean = a.ev_mean;
          const bool evok = a.ev_ok;
          // gapY TO cell (x, y+1) on the same path
          float e_stay_same;
          if constexpr (HDP) {
            e_stay_same =
                (a.inv_m0 > 0.f && evok)
                    ? hdp_log_emission(a.mu0 + (ev_mean - a.m_hat0) / pr.var,
                                       a.kid0, pr.var, h)
                    : NEG;
          } else {
            const float ay = (ev_mean - a.m_hat0) * a.inv_y0;
            e_stay_same =
                (a.inv_m0 > 0.f && evok) ? a.c_y0 - 0.5f * ay * ay : NEG;
          }
          const float gy_term =
              rdn(b1, GAP_Y, o + u1, q, W, N, P, m1) + e_stay_same;
          // gapX TO (x+1, y) and match TO (x+1, y+1), over the target
          // paths p that may follow q: legal[p, q] at x+1
          float tgx[PAIR_P], tmm[PAIR_P];
#pragma unroll
          for (int p = 0; p < PAIR_P; ++p) {
            if (p < P) {
              const bool leg = (a.lw >> p) & 1u;
              const float inv_m1 = a.inv_m1[p];
              float e_match_to;
              if constexpr (HDP) {
                // only a legal target's emission is read below
                e_match_to =
                    (inv_m1 > 0.f && evok && leg)
                        ? hdp_log_emission(
                              a.mu1[p] + (ev_mean - a.m_hat1[p]) / pr.var,
                              a.kid1[p], pr.var, h)
                        : NEG;
              } else {
                const float am = (ev_mean - a.m_hat1[p]) * inv_m1;
                e_match_to =
                    (inv_m1 > 0.f && evok) ? a.c_m1[p] - 0.5f * am * am : NEG;
              }
              const float gapx_valid = inv_m1 > 0.f ? pr.gapx : NEG;
              tgx[p] = leg ? rdn(b1, GAP_X, o + u1 + 1, p, W, N, P, m1) +
                                 gapx_valid
                           : NEG;
              tmm[p] = leg ? rdn(b2, MATCH, o + u2, p, W, N, P, m2) +
                                 e_match_to - m1
                           : NEG;
            }
          }
          const float gx_red = P == 1 ? tgx[0] : legal_lse(tgx, P);
          const float mm_red = P == 1 ? tmm[0] : legal_lse(tmm, P);
          if constexpr (EXPECT) {
            // transitions out of (x, y) at d; the to-cell reductions are
            // normalised to Bo(d+1), which `bo` still holds here
            const float normA = (float)(cv_d + bo);
            const float f_m = fin_[k][MATCH], f_x = fin_[k][GAP_X],
                        f_y = fin_[k][GAP_Y];
            const float p_mx = expf(f_m + t[T_MX] + gx_red + normA);
            const float p_xx = expf(f_x + t[T_XX] + gx_red + normA);
            const float p_mm = expf(f_m + t[T_MM] + mm_red + normA);
            const float p_xm = expf(f_x + t[T_XM] + mm_red + normA);
            const float p_ym = expf(f_y + t[T_YM] + mm_red + normA);
            const float p_my = expf(f_m + t[T_MY] + gy_term + normA);
            const float p_yy = expf(f_y + t[T_YY] + gy_term + normA);
            acc[0] += (double)p_mx;
            acc[1] += (double)p_xx;
            acc[2] += (double)p_mm;
            acc[3] += (double)p_xm;
            acc[4] += (double)p_ym;
            acc[5] += (double)p_my;
            acc[6] += (double)p_yy;
            if constexpr (MOMENTS) {
              // moments of the into-match posterior at (x+1, y+1) on path
              // p: at P = 1 this cell's three terms; at P = 2 the terms of
              // both source paths, added after the exchange below
              if constexpr (MP == 1) {
                const float mtp = p_mm + p_xm + p_ym;
                if (mtp != 0.f)
                  window_add(kxw, ktag, kb, W, N, 1, LX, r1 + o, 0, mtp,
                             a.inv_m1[0] > 0.f
                                 ? (ev_mean - a.m_hat1[0]) / pr.var : 0.f);
              } else {
                float pm[PAIR_P];
#pragma unroll
                for (int p = 0; p < PAIR_P; ++p)
                  pm[p] = expf(f_m + t[T_MM] + tmm[p] + normA) +
                          expf(f_x + t[T_XM] + tmm[p] + normA) +
                          expf(f_y + t[T_YM] + tmm[p] + normA);
                pm_own = pm[q];
                pm_other = pm[1 - q];
                dx_own = a.inv_m1[q] > 0.f
                             ? (ev_mean - a.m_hat1[q]) / pr.var : 0.f;
              }
            }
          }
          bm = lae(lae(gx_red + t[T_MX], mm_red + t[T_MM]),
                   gy_term + t[T_MY]);
          bx = lae(gx_red + t[T_XX], mm_red + t[T_XM]);
          by = lae(mm_red + t[T_YM], gy_term + t[T_YY]);
        }
      }
      if constexpr (MOMENTS) {
        // P = 2: cells o*2 and o*2+1 (one offset's two paths) are
        // neighbouring lanes, so the other source path's posterior into
        // this cell's target comes by one shuffle (every lane runs it)
        if constexpr (MP == 2) {
          const float mtp =
              pm_own + __shfl_xor_sync(0xffffffffu, pm_other, 1);
          if (!fin && c < N && o < wd && mtp != 0.f)
            window_add(kxw, ktag, kb, W, N, 2, LX, r1 + o, q, mtp, dx_own);
        }
      }
      vm[k] = bm;
      vx[k] = bx;
      vy[k] = by;
      tmax = fmaxf(tmax, fmaxf(bm, fmaxf(bx, by)));
      if (c < N) {
        cur[MATCH * N + c] = fmaxf(bm, NEG);
        cur[GAP_X * N + c] = fmaxf(bx, NEG);
        cur[GAP_Y * N + c] = fmaxf(by, NEG);
      }
    }
    tmax = warp_max(tmax);
    if (nw > 1 && lane == 0) part[(d & 1) * 32 + warp] = tmax;
    // diagonal d-1's forward states, its cvecf and the band of d-2,
    // issued before the barrier and read after it
    double cv_n = cv_d;
    int xnn = xn, wnn = wn;
    if (d > 0) {
      stage(d - 1, wn);
      cv_n = cv[d - 1];
      xnn = pr.x0[max(d - 2, 0)];
      wnn = pr.width[max(d - 2, 0)];
    }
    float m = diag_barrier_max(tmax, part, d & 1, nw);
    m = fin ? 0.f : (m > NEG * 0.5f ? m : 0.f);
    bo += (double)m;                                     // Bo(d)
    // absolute log posterior = f + b + cvecf[d] + Bo(d), b normalised
    const float cd = (float)(cv_d + bo);
    // the survivors of d+1, ranked in cell (= offset, then path) order:
    // chunk, warp, lane; the barrier published their warp counts
    if (!fin) {
      const int* wc = wcnt + ((d + 1) & 1) * K * 32;
      bool mine = threadIdx.x == 0;
#pragma unroll
      for (int k = 0; k < K; ++k) mine |= rk[k] >= 0;
      if (mine) {
        int before = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          int base = before;
          for (int w = 0; w < warp; ++w) base += wc[k * 32 + w];
          const int r = base + rk[k];
          if (rk[k] >= 0 && r < R) {
            so[(size_t)(d + 1) * R + r] = threadIdx.x + k * blockDim.x;
            sv[(size_t)(d + 1) * R + r] = pk[k];
          }
          for (int w = 0; w < nw; ++w) before += wc[k * 32 + w];
        }
        if (threadIdx.x == 0) cn[d + 1] = before;
      }
    }
    int* wc = wcnt + (d & 1) * K * 32;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      vm[k] = fmaxf(vm[k] - m, NEG);
      vx[k] = fmaxf(vx[k] - m, NEG);
      vy[k] = fmaxf(vy[k] - m, NEG);
      bool surv = false;
      float p = 0.f;
      if (c < N) {
        const int o = c / P;
        const int x = xd + o, y = d - x;
        if (o < wd && x > 0 && y > 0 && x <= pr.lX && y <= pr.lY) {
          p = expf(fmaxf(fpost[k] + vm[k] + cd, NEG));
          surv = p >= threshold;
        }
      }
      const unsigned ball = __ballot_sync(0xffffffffu, surv);
      if (lane == 0) wc[k * 32 + warp] = __popc(ball);
      pk[k] = p;
      rk[k] = surv ? __popc(ball & ((1u << lane) - 1u)) : -1;
    }
    if (threadIdx.x == 0) inc[d] = m;
    m2 = m1;
    m1 = m;
    xp2 = xp1;
    xp1 = xd;
    xd = xn;
    wd = wn;
    xn = xnn;
    wn = wnn;
    cv_d = cv_n;
  }
  // publish diagonal 0's warp counts, then its survivor slots
  __syncthreads();
  {
    int before = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int base = before;
      for (int w = 0; w < warp; ++w) base += wcnt[k * 32 + w];
      const int r = base + rk[k];
      if (rk[k] >= 0 && r < R) {
        so[r] = threadIdx.x + k * blockDim.x;
        sv[r] = pk[k];
      }
      for (int w = 0; w < nw; ++w) before += wcnt[k * 32 + w];
    }
    if (threadIdx.x == 0) cn[0] = before;
  }
  const float l = block_lse_cells<K>(vm, vx, vy, pr.start, N, part);
  if (threadIdx.x == 0) lse_b[b] = l;
  if constexpr (EXPECT) {
    if constexpr (MOMENTS) {
      // the positions still in the window (block_lse_cells' barriers
      // ordered their last sums before these reads)
      for (int sl = threadIdx.x; sl < N; sl += blockDim.x)
        if (ktag[sl] >= 0)
          for (int r = 0; r < 3; ++r)
            atomicAdd(kb + ((size_t)r * P + sl % P) * LX + ktag[sl],
                      kxw[r * N + sl]);
    }
    block_texp(acc, texp + (size_t)b * 7);
  }
}

// ------------------------------------- the EM sums of the register buckets

// sa_expect_sums: the expectation sums of a bucket whose backward ran a
// P > 2 register instance (its EXPECT pass stores the three-state stack,
// bstack, and sums nothing), from both stacks at once. It replaces, for
// those buckets, the sums of _bwd_kernel_log's expect mode
// (banded_fb_pallas_batch.py:971-1015) and the JAX XLA
// _expectations_core (signalalign_tpu/ops/banded_fb.py:642) that the JAX
// runner sends P > 1 buckets to, and computes what the plain twin
// expectation_sums (ops/banded_fb.py) computes: at each TO cell (d, p, o)
// every legal (source q, target p) pair's five pair posteriors and the
// two gapY stays, exp(max(src + e_to + t + b + c, NEG)) as float32 terms
// in the twin's order of operations, summed in float64 into texp (B, 7)
// and, Gaussian only, the into-match posteriors' moments into kx (B, 3,
// P, LX).
//
// What bounds it: the bytes of the two stacks, each read once (the other
// inputs are a few percent of them), over the HBM rate; its exponentials
// are five per legal pair and two per cell. In the sweep the same sums
// sat on every diagonal's serial chain, between its barriers, on the
// block's few warps (1.30-1.42x the plain backward on an H100, PERF.md
// §6); here they are bandwidth work over every SM, and nothing waits on
// them. A block owns ES_COLS consecutive reference columns x of one
// (problem, target path p), a lane one column; its ES_WARPS warps split
// the run of TO diagonals whose band may cover the block's columns (found
// by bisection in two envelopes of the band that sa_expect_env_kernel
// writes first), each warp walking its slice in order with all its lanes
// on the same diagonal, so that neighbouring lanes read neighbouring
// offsets of the same stack rows. A lane's reference rows and legality
// words are its column's on every diagonal, loaded once. Sums are float64
// in an order the code fixes (a lane's diagonals in order and the warps'
// slices in warp order for kx; shuffles, then warps, then blocks in index
// order for texp, whose per-block partials sa_expect_texp_kernel adds
// up), never the scheduler: a lane owns its (problem, path, column) of
// kx, there are no atomics, and two launches give the same bits.
constexpr int ES_COLS = 32;                 // columns a block: a warp's lanes
constexpr int ES_WARPS = 8;                 // diagonal slices a block
constexpr int ES_THREADS = 32 * ES_WARPS;

// blocks of sa_expect_sums_kernel a problem and path: its column tiles
__host__ __device__ __forceinline__ int es_tiles(int LX) {
  return (LX + ES_COLS - 1) / ES_COLS;
}

// The scratch of sa_expect_sums per problem, in 8-byte words: its texp
// partials (7 a block) and the two band envelopes (2 D1 ints).
__host__ __device__ __forceinline__ size_t es_scratch_words(int D1, int P,
                                                            int LX) {
  return (size_t)7 * P * es_tiles(LX) + ((size_t)2 * D1 + 1) / 2;
}

// The band's envelopes of each problem over its TO diagonals d = 1..n, n
// = min(n_diag, D1 - 1), where diagonal d covers the reference columns
// [rs(d), rs(d) + width(d)), rs(d) = clamp(x0[d], 0, reflen - W) (the
// twin's windows): hi[d] the largest last column of diagonals 1..d, lo[d]
// the smallest first column of diagonals d..n (an empty diagonal covers
// none). Both are nondecreasing in d, so every diagonal that covers a
// column in [xa, xb] has hi[d] >= xa and lo[d] <= xb: a run that
// bisection finds, whatever the band's shape. One block a problem: each
// thread a run of diagonals, then a scan of the runs' extremes.
__global__ void __launch_bounds__(MAX_THREADS) sa_expect_env_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const int* __restrict__ meta_, int* __restrict__ env, int D1, int W) {
  __shared__ int shi[MAX_THREADS], slo[MAX_THREADS];
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int* x0 = x0_ + (size_t)b * D1;
  const int* width = width_ + (size_t)b * D1;
  const int* meta = meta_ + (size_t)b * NMETA;
  const int n = min(meta[M_NDIAG], D1 - 1), room = meta[M_REFLEN] - W;
  int* hi = env + (size_t)b * 2 * D1;
  int* lo = hi + D1;
  const int run = (n + T - 1) / T;
  const int d0 = 1 + t * run, d1 = min(d0 + run, n + 1);
  auto first = [&](int d) {
    return width[d] > 0 ? clampi(x0[d], 0, room) : INT_MAX;
  };
  auto last = [&](int d) {
    return width[d] > 0 ? clampi(x0[d], 0, room) + width[d] - 1 : INT_MIN;
  };
  int h = INT_MIN, l = INT_MAX;
  for (int d = d0; d < d1; ++d) {
    h = max(h, last(d));
    l = min(l, first(d));
  }
  shi[t] = h;
  slo[t] = l;
  __syncthreads();
  // inclusive prefix max and suffix min over the threads' runs
  for (int off = 1; off < T; off <<= 1) {
    const int a = t >= off ? shi[t - off] : INT_MIN;
    const int c = t + off < T ? slo[t + off] : INT_MAX;
    __syncthreads();
    shi[t] = max(shi[t], a);
    slo[t] = min(slo[t], c);
    __syncthreads();
  }
  h = t > 0 ? shi[t - 1] : INT_MIN;
  l = t + 1 < T ? slo[t + 1] : INT_MAX;
  for (int d = d0; d < d1; ++d) hi[d] = h = max(h, last(d));
  for (int d = d1 - 1; d >= d0; --d) lo[d] = l = min(l, first(d));
}

template <bool HDP>
__global__ void __launch_bounds__(ES_THREADS) sa_expect_sums_kernel(
    const int* __restrict__ x0_, const int* __restrict__ width_,
    const float* __restrict__ ref_, const unsigned* __restrict__ leg_,
    const float* __restrict__ ev_, const int* __restrict__ meta_,
    const float* __restrict__ par_, const HdpTab h,
    const float* __restrict__ fstack, const float* __restrict__ bstack,
    const double* __restrict__ cvecf, const double* __restrict__ bo_,
    const int* __restrict__ env, double* __restrict__ part,
    double* __restrict__ kx, int D1, int W, int P, int LX, int LE) {
  __shared__ double ksum[ES_WARPS][3][32];
  __shared__ double tsum[ES_WARPS][7];
  const int tile = blockIdx.x, p = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = tile * ES_COLS + lane;
  const int N = P * W, NW = leg_words(P);
  const int* meta = meta_ + (size_t)b * NMETA;
  const float* par = par_ + (size_t)b * NPACK;
  const int lY = meta[M_LY], efp = meta[M_EVPAD];
  const int reflen = meta[M_REFLEN], evlen = meta[M_EVLEN];
  const int n = min(meta[M_NDIAG], D1 - 1);
  const int* x0 = x0_ + (size_t)b * D1;
  const int* width = width_ + (size_t)b * D1;
  const float* ev = ev_ + (size_t)b * NEV * LE;
  const float* fs = fstack + (size_t)b * D1 * 3 * N;
  const float* bs = bstack + (size_t)b * D1 * 3 * N + (size_t)p * W;
  const double* cv = cvecf + (size_t)b * D1;
  const double* bo = bo_ + (size_t)b * D1;
  const float* tr = par + PACK_TRANS;
  const float gapx = par[PACK_GAPX], var = par[PACK_VAR];

  // the run of TO diagonals that may cover the block's columns, and this
  // warp's slice of it
  const int* hi = env + (size_t)b * 2 * D1;
  const int* lo = hi + D1;
  const int xa = tile * ES_COLS, xb = min(xa + ES_COLS, LX) - 1;
  int a = 1, z = n + 1;   // the first d with hi[d] >= xa
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (hi[mid] >= xa) z = mid; else a = mid + 1;
  }
  const int dlo = a;
  a = 1;
  z = n + 1;              // the first d with lo[d] > xb
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (lo[mid] > xb) z = mid; else a = mid + 1;
  }
  const int len = max(a - dlo, 0);
  const int dbeg = dlo + (int)((long long)len * warp / ES_WARPS);
  const int dend = dlo + (int)((long long)len * (warp + 1) / ES_WARPS);

  // this lane's column: its reference rows and legality words (target
  // path p: bit q, legal from source path q), the same on every diagonal
  const bool col = x < LX;
  float m_hat = 0.f, inv_m = 0.f, c_m = 0.f, inv_y = 0.f, c_y = 0.f;
  float mu = 0.f;
  int kid = 0;
  const unsigned* lw = nullptr;
  if (col) {
    const size_t plane = (size_t)P * LX, i = (size_t)p * LX + x;
    const float* rf = ref_ + (size_t)b * NREF * plane + i;
    m_hat = rf[0];
    inv_m = rf[plane];
    c_m = rf[2 * plane];
    inv_y = rf[3 * plane];
    c_y = rf[4 * plane];
    if constexpr (HDP) {
      kid = h.kid[(size_t)b * plane + i];
      mu = h.mu[(size_t)b * plane + i];
    }
    lw = leg_ + (((size_t)b * LX + x) * P + p) * NW;
  }
  const bool kvalid = inv_m > 0.f;
  const float e_gapx = kvalid ? gapx : NEG;

  double tacc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double k0 = 0.0, k1 = 0.0, k2 = 0.0;
  for (int d = dbeg; d < dend; ++d) {
    const int xd = x0[d];
    const int o = x - clampi(xd, 0, reflen - W);
    if (!col || o < 0 || o >= width[d]) continue;
    const int je = clampi(lY - d + xd + efp, 0, evlen - W) + o;
    const float ev_mean = ev[je];
    const bool ok = kvalid && ev[LE + je] > 0.5f;
    float e_match, e_stay;
    if constexpr (HDP) {
      e_match = e_stay =
          ok ? hdp_log_emission(mu + (ev_mean - m_hat) / var, kid, var, h)
             : NEG;
    } else {
      const float am = (ev_mean - m_hat) * inv_m;
      const float ay = (ev_mean - m_hat) * inv_y;
      e_match = ok ? c_m - 0.5f * am * am : NEG;
      e_stay = ok ? c_y - 0.5f * ay * ay : NEG;
    }
    const float* bd = bs + (size_t)d * 3 * N + o;
    const float b_m = bd[MATCH * N], b_x = bd[GAP_X * N],
                b_y = bd[GAP_Y * N];
    const float c1 = (float)(cv[d - 1] + bo[d]);
    const float c2 = (float)(cv[d >= 2 ? d - 2 : 0] + bo[d]);
    // the sources (x-1, y) and (x, y-1) on diagonal d-1 and (x-1, y-1)
    // on d-2, in the twin's windows (NEG outside them)
    const int i1 = o + xd - x0[d - 1] - 1;
    const int i2 = d >= 2 ? o + xd - x0[d - 2] - 1 : W + 5;
    const bool in1 = i1 >= 0 && i1 < W, in2 = i2 >= 0 && i2 < W;
    const bool iny = i1 + 1 >= 0 && i1 + 1 < W;
    const float* f1 = fs + (size_t)(d - 1) * 3 * N;
    const float* f2 = fs + (size_t)(in2 ? d - 2 : 0) * 3 * N;
    // the two gapY stays, on path p
    const float fy_m = iny ? f1[MATCH * N + p * W + i1 + 1] : NEG;
    const float fy_y = iny ? f1[GAP_Y * N + p * W + i1 + 1] : NEG;
    tacc[5] += (double)expf(fmaxf(fy_m + e_stay + tr[T_MY] + b_y + c1, NEG));
    tacc[6] += (double)expf(fmaxf(fy_y + e_stay + tr[T_YY] + b_y + c1, NEG));
    // the pairs from the legal source paths q, in path order
    float mtp = 0.f;
    for (int w = 0; w < NW; ++w)
      for (unsigned m = lw[w]; m; m &= m - 1) {
        const int q = 32 * w + __ffs(m) - 1;
        const float f1m = in1 ? f1[MATCH * N + q * W + i1] : NEG;
        const float f1x = in1 ? f1[GAP_X * N + q * W + i1] : NEG;
        const float f2m = in2 ? f2[MATCH * N + q * W + i2] : NEG;
        const float f2x = in2 ? f2[GAP_X * N + q * W + i2] : NEG;
        const float f2y = in2 ? f2[GAP_Y * N + q * W + i2] : NEG;
        const float p_mx =
            expf(fmaxf(f1m + e_gapx + tr[T_MX] + b_x + c1, NEG));
        const float p_xx =
            expf(fmaxf(f1x + e_gapx + tr[T_XX] + b_x + c1, NEG));
        const float p_mm =
            expf(fmaxf(f2m + e_match + tr[T_MM] + b_m + c2, NEG));
        const float p_xm =
            expf(fmaxf(f2x + e_match + tr[T_XM] + b_m + c2, NEG));
        const float p_ym =
            expf(fmaxf(f2y + e_match + tr[T_YM] + b_m + c2, NEG));
        tacc[0] += (double)p_mx;
        tacc[1] += (double)p_xx;
        tacc[2] += (double)p_mm;
        tacc[3] += (double)p_xm;
        tacc[4] += (double)p_ym;
        mtp += p_mm + p_xm + p_ym;
      }
    if constexpr (!HDP) {
      const float dxv = kvalid ? (ev_mean - m_hat) / var : 0.f;
      k0 += (double)mtp;
      k1 += (double)(mtp * dxv);
      k2 += (double)(mtp * dxv * dxv);
    }
  }

  // texp: the lanes by shuffles, then the warps in order, to the block's
  // partial
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    double v = tacc[i];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) tsum[warp][i] = v;
  }
  if constexpr (!HDP) {
    ksum[warp][0][lane] = k0;
    ksum[warp][1][lane] = k1;
    ksum[warp][2][lane] = k2;
  }
  __syncthreads();
  if (threadIdx.x < 7) {
    double s = 0.0;
    for (int w = 0; w < ES_WARPS; ++w) s += tsum[w][threadIdx.x];
    part[(((size_t)b * P + p) * gridDim.x + tile) * 7 + threadIdx.x] = s;
  }
  if constexpr (!HDP) {
    // kx row `warp` of this column: the warps' slices in warp order
    if (warp < 3 && col) {
      double s = 0.0;
      for (int w = 0; w < ES_WARPS; ++w) s += ksum[w][warp][lane];
      kx[(((size_t)b * 3 + warp) * P + p) * LX + x] = s;
    }
  }
}

// texp of each problem: its nblk blocks' partials in block order
__global__ void sa_expect_texp_kernel(const double* __restrict__ part,
                                      double* __restrict__ texp, int nblk) {
  const int b = blockIdx.x, i = threadIdx.x;
  if (i >= 7) return;
  const double* pb = part + (size_t)b * nblk * 7;
  double s = 0.0;
  for (int j = 0; j < nblk; ++j) s += pb[(size_t)j * 7 + i];
  texp[(size_t)b * 7 + i] = s;
}

// ------------------------------------------------------------- dispatch

int round_warps(int n) { return ((n + 31) / 32) * 32; }

// cells per thread of a P > 2 instance: rounded up to an instantiated K
// up to REG_CELLS cells, every MAX_THREADS-th cell of the diagonal past
// them (the wide instance)
int paths_k(int N) {
  const int k = (N + MAX_THREADS - 1) / MAX_THREADS;
  if (N > REG_CELLS) return k;
  return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8;
}

bool pair_bucket(int W, int P) { return P <= PAIR_P && P * W <= PAIR_CELLS; }

// Cells per thread of the per-pair instances by P * W: the fastest of K =
// 1, 2, 4 and 8 timed on every class of the pipeline's P <= 2 buckets on
// an H100 (PERF.md §6), the most threads the budget allows (one warp, K =
// 8 at W = 256, was 3-4x slower), except for the EXPECT backward (98
// registers a thread at K = 1), which fits twice the blocks on an SM at K
// = 2 and measured faster there above 128 cells. At most PAIR_THREADS
// threads at N <= PAIR_CELLS.
int pair_k(int N, bool expect_bwd) {
  return N <= (expect_bwd ? 128 : 512) ? 1 : N <= 1024 ? 2 : 4;
}

bool shape_ok(int W, int P) { return W >= 1 && P >= 1; }

// The device pointers and sizes of one bucket.
struct Bucket {
  const int* x0;
  const int* width;
  const float* ref;
  const unsigned* leg;
  const float* ev;
  const int* meta;
  const float* par;
  HdpTab h;
  int B, D1, W, P, LX, LE;
};

// the kernel's dynamic shared memory; a refusal is the launch's error
template <typename Kern>
int launch_setup(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The cluster instance's launch for a bucket: C blocks of T threads a
// problem, nk <= MAX_K cells a thread, its dynamic shared memory (the
// ring slice and the stage; cluster_smem). C = 0 where it does not take
// the bucket: P * W <= REG_CELLS (the register instances), or past CAP
// (the scratch instance).
struct ClusterCfg {
  int C, T, nk;
  size_t smem;
};

size_t cluster_smem(int W, int P, int C, bool expect) {
  const size_t opc = (W + C - 1) / C;
  return (6 * opc * P + (expect ? 3 : 1) * P * (opc + 1)) * sizeof(float);
}

// (C, threads) of the cluster instance: of C = 2, 4, 8 at 512 and 1,024
// threads (scripts/time_torch_cluster.py --scan, PERF.md §6), 8 blocks of
// 1,024 threads were the fastest on an H100 at P = 64, W = 256 and 512,
// and within 5% of 8 x 512 at P = 16, W = 768, plain and EXPECT: the
// most blocks, so the fewest cells a thread, won where the cells fit.
constexpr int CLUSTER_C = 8, CLUSTER_T = 1024;

// The cluster instance's launch for a bucket at (CLUSTER_C, CLUSTER_T),
// C = 0 past CAP: where its cells or shared memory do not fit.
ClusterCfg cluster_cfg(int W, int P, bool expect, bool backward) {
  (void)backward;   // both sweeps take the same slices
  if (!shape_ok(W, P) || P * W <= REG_CELLS) return {0, 0, 0, 0};
  const int C = CLUSTER_C, T = CLUSTER_T;
  const int nk = ((W + C - 1) / C * P + T - 1) / T;
  const size_t smem = cluster_smem(W, P, C, expect);
  if (nk > MAX_K || smem > SMEM_OPTIN - SMEM_STATIC_ROOM) return {0, 0, 0, 0};
  return {C, T, nk, smem};
}

// The launch configuration of a cluster instance `kern` on B problems:
// its shared memory set, and at least one cluster of its size, threads and
// shared memory schedulable on the card (else cudaErrorLaunchOutOfResources).
template <typename Kern>
int cluster_setup(Kern kern, const ClusterCfg& g, int B, cudaStream_t stream,
                  cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (int e = launch_setup(kern, g.smem)) return e;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * g.C);
  cfg.blockDim = dim3(g.T);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg))
    return (int)e;
  return n >= 1 ? 0 : (int)cudaErrorLaunchOutOfResources;
}

// cudaLaunchKernelEx's error, else cudaGetLastError()
int launch_error(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int K, bool HDP, bool EXPECT>
int fwd_pair_launch(const Bucket& a, float* fstack, float* f_incr,
                    float* lse_f, cudaStream_t stream) {
  const int N = a.P * a.W;
  const size_t smem = (9 * (size_t)N + 64) * sizeof(float);
  if (int e = launch_setup(sa_fwd_pair_kernel<K, HDP, EXPECT>, smem)) return e;
  sa_fwd_pair_kernel<K, HDP, EXPECT>
      <<<a.B, round_warps((N + K - 1) / K), smem, stream>>>(
          a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack,
          f_incr, lse_f, a.D1, a.W, a.P, a.LX, a.LE);
  return (int)cudaGetLastError();
}

// threads of a P > 2 instance: a thread a cell, at most MAX_THREADS
int paths_threads(int N) {
  return N >= MAX_THREADS ? MAX_THREADS : round_warps(N);
}

template <int K, bool HDP, bool EXPECT>
int fwd_paths_launch(const Bucket& a, float* fstack, float* f_incr,
                     float* lse_f, float* scratch, cudaStream_t stream) {
  const int N = a.P * a.W;
  const size_t smem = ((K == WIDE ? 0 : 6 * (size_t)N) + 32) * sizeof(float);
  if (int e = launch_setup(sa_fwd_paths_kernel<K, HDP, EXPECT>, smem)) return e;
  sa_fwd_paths_kernel<K, HDP, EXPECT>
      <<<a.B, paths_threads(N), smem, stream>>>(
      a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack, f_incr,
      lse_f, scratch, a.D1, a.W, a.P, a.LX, a.LE);
  return (int)cudaGetLastError();
}

template <int K, bool HDP, bool EXPECT>
int fwd_cluster_launch(const Bucket& a, const ClusterCfg& g, float* fstack,
                       float* f_incr, float* lse_f, cudaStream_t stream) {
  auto kern = sa_fwd_cluster_kernel<K, HDP, EXPECT>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int e = cluster_setup(kern, g, a.B, stream, cfg, attr)) return e;
  return launch_error(cudaLaunchKernelEx(
      &cfg, kern, a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h,
      fstack, f_incr, lse_f, a.D1, a.W, a.P, a.LX, a.LE, g.C));
}

template <bool HDP, bool EXPECT>
int fwd_pair_dispatch(const Bucket& a, int K, float* fstack, float* f_incr,
                      float* lse_f, cudaStream_t s) {
  switch (K) {
    case 1: return fwd_pair_launch<1, HDP, EXPECT>(a, fstack, f_incr, lse_f, s);
    case 2: return fwd_pair_launch<2, HDP, EXPECT>(a, fstack, f_incr, lse_f, s);
    default:
      return fwd_pair_launch<4, HDP, EXPECT>(a, fstack, f_incr, lse_f, s);
  }
}

template <bool HDP, bool EXPECT>
int fwd_paths_dispatch(const Bucket& a, float* fstack, float* f_incr,
                       float* lse_f, float* scratch, cudaStream_t s) {
  switch (paths_k(a.P * a.W)) {
    case 1:
      return fwd_paths_launch<1, HDP, EXPECT>(a, fstack, f_incr, lse_f, 0, s);
    case 2:
      return fwd_paths_launch<2, HDP, EXPECT>(a, fstack, f_incr, lse_f, 0, s);
    case 4:
      return fwd_paths_launch<4, HDP, EXPECT>(a, fstack, f_incr, lse_f, 0, s);
    case 8:
      return fwd_paths_launch<8, HDP, EXPECT>(a, fstack, f_incr, lse_f, 0, s);
    default: {
      const ClusterCfg g = cluster_cfg(a.W, a.P, EXPECT, false);
      if (!g.C)   // past CAP
        return fwd_paths_launch<WIDE, HDP, EXPECT>(a, fstack, f_incr, lse_f,
                                                   scratch, s);
      return g.nk <= 4 ? fwd_cluster_launch<4, HDP, EXPECT>(a, g, fstack,
                                                            f_incr, lse_f, s)
                       : fwd_cluster_launch<8, HDP, EXPECT>(a, g, fstack,
                                                            f_incr, lse_f, s);
    }
  }
}

// The backward's outputs: the survivor slots, and for an expectation
// pass texp (B, 7) and kx (B, 3, P, LX), or in the P > 2 register
// instances' (expect_split) the three-state stack bstack (B, D1, 3, P, W)
// (null otherwise).
struct BwdOut {
  float* b_incr;
  float* lse_b;
  int* slot_cell;
  float* slot_val;
  int* cnt;
  double* texp;
  double* kx;
  float* bstack;
};

template <int K, bool HDP, bool EXPECT, int MP = 1>
int bwd_pair_launch(const Bucket& a, const float* fstack, const double* cvecf,
                    const BwdOut& o, int R, float threshold,
                    cudaStream_t stream) {
  const int N = a.P * a.W;
  constexpr bool MOMENTS = EXPECT && !HDP;
  const size_t smem = (MOMENTS ? 3 * (size_t)N * sizeof(double) : 0) +
                      (9 * (size_t)N + 64) * sizeof(float) +
                      (2 * K * 32 + (MOMENTS ? N : 0)) * sizeof(int);
  if (int e = launch_setup(sa_bwd_pair_kernel<K, HDP, EXPECT, MP>, smem))
    return e;
  sa_bwd_pair_kernel<K, HDP, EXPECT, MP>
      <<<a.B, round_warps((N + K - 1) / K), smem, stream>>>(
          a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack,
          cvecf, o.b_incr, o.lse_b, o.slot_cell, o.slot_val, o.cnt, o.texp,
          o.kx, a.D1, a.W, a.P, a.LX, a.LE, R, threshold);
  return (int)cudaGetLastError();
}

template <int K, bool HDP, bool EXPECT>
int bwd_paths_launch(const Bucket& a, const float* fstack, const double* cvecf,
                     const BwdOut& o, int R, float threshold, float* scratch,
                     cudaStream_t stream) {
  const int N = a.P * a.W;
  const size_t smem = K == WIDE ? 32 * sizeof(float)
                                : (6 * (size_t)N + 32) * sizeof(float) +
                                      K * 32 * sizeof(int);
  if (int e = launch_setup(sa_bwd_paths_kernel<K, HDP, EXPECT>, smem))
    return e;
  sa_bwd_paths_kernel<K, HDP, EXPECT>
      <<<a.B, paths_threads(N), smem, stream>>>(
          a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack,
          cvecf, o.b_incr, o.lse_b, o.slot_cell, o.slot_val, o.cnt, o.texp,
          o.kx, o.bstack, scratch, a.D1, a.W, a.P, a.LX, a.LE, R, threshold);
  return (int)cudaGetLastError();
}

template <int K, bool HDP, bool EXPECT>
int bwd_cluster_launch(const Bucket& a, const ClusterCfg& g,
                       const float* fstack, const double* cvecf,
                       const BwdOut& o, int R, float threshold,
                       const unsigned* leg_tgt, cudaStream_t stream) {
  auto kern = sa_bwd_cluster_kernel<K, HDP, EXPECT>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int e = cluster_setup(kern, g, a.B, stream, cfg, attr)) return e;
  return launch_error(cudaLaunchKernelEx(
      &cfg, kern, a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h,
      fstack, cvecf, o.b_incr, o.lse_b, o.slot_cell, o.slot_val, o.cnt,
      o.texp, o.kx, leg_tgt, a.D1, a.W, a.P, a.LX, a.LE, R, threshold,
      g.C));
}

template <bool HDP, bool EXPECT>
int bwd_pair_dispatch(const Bucket& a, int K, const float* fstack,
                      const double* cvecf, const BwdOut& o, int R,
                      float threshold, cudaStream_t s) {
  if constexpr (EXPECT && !HDP) {
    if (a.P == 2) switch (K) {
        case 1: return bwd_pair_launch<1, HDP, EXPECT, 2>(a, fstack, cvecf, o,
                                                          R, threshold, s);
        case 2: return bwd_pair_launch<2, HDP, EXPECT, 2>(a, fstack, cvecf, o,
                                                          R, threshold, s);
        default: return bwd_pair_launch<4, HDP, EXPECT, 2>(a, fstack, cvecf,
                                                           o, R, threshold,
                                                           s);
      }
  }
  switch (K) {
    case 1: return bwd_pair_launch<1, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                   threshold, s);
    case 2: return bwd_pair_launch<2, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                   threshold, s);
    default: return bwd_pair_launch<4, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                    threshold, s);
  }
}

template <bool HDP, bool EXPECT>
int bwd_paths_dispatch(const Bucket& a, const float* fstack,
                       const double* cvecf, const BwdOut& o, int R,
                       float threshold, float* scratch,
                       const unsigned* leg_tgt, cudaStream_t s) {
  switch (paths_k(a.P * a.W)) {
    case 1: return bwd_paths_launch<1, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                    threshold, 0, s);
    case 2: return bwd_paths_launch<2, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                    threshold, 0, s);
    case 4: return bwd_paths_launch<4, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                    threshold, 0, s);
    case 8: return bwd_paths_launch<8, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                    threshold, 0, s);
    default: {
      const ClusterCfg g = cluster_cfg(a.W, a.P, EXPECT, true);
      if (!g.C)   // past CAP
        return bwd_paths_launch<WIDE, HDP, EXPECT>(a, fstack, cvecf, o, R,
                                                   threshold, scratch, s);
      return g.nk <= 4
                 ? bwd_cluster_launch<4, HDP, EXPECT>(a, g, fstack, cvecf, o,
                                                      R, threshold, leg_tgt,
                                                      s)
                 : bwd_cluster_launch<8, HDP, EXPECT>(a, g, fstack, cvecf, o,
                                                      R, threshold, leg_tgt,
                                                      s);
    }
  }
}

// A Gaussian bucket passes null HDP pointers; an HDP bucket all four
// pointers and a grid of at least two knots.
bool hdp_ok(const HdpTab& h) {
  if (!h.dens) return !h.kid && !h.mu && !h.slopes;
  return h.kid && h.mu && h.slopes && h.nk >= 1 && h.ng >= 2 && h.dx > 0.f;
}

// The cells per thread the forward (`backward` false) or the backward
// sweep launches a bucket of P paths at width W with: K of a per-pair
// instance, -K of a P > 2 (PATHS) one (K > MAX_K: the wide instance); 0
// for a shape they do not take.
// The expectation pass takes the same instances as the plain sweeps: at
// P = 2 the per-pair instance measured 7-32% faster than the P > 2
// instances' expectation pass on every P = 2 class (PERF.md §6).
int launch_k(int W, int P, bool expect, bool backward) {
  if (!shape_ok(W, P)) return 0;
  return pair_bucket(W, P) ? pair_k(P * W, expect && backward)
                           : -paths_k(P * W);
}

// Whether the backward's expectation pass on a bucket of P paths at
// width W runs a P > 2 register instance, which stores the three-state
// stack and leaves texp and kx to sa_expect_sums (the per-pair, cluster
// and scratch instances sum in the sweep).
bool expect_split(int W, int P) {
  const int K = launch_k(W, P, true, true);
  return K < 0 && K >= -MAX_K;
}

// sa_expect_sums on a bucket: the envelopes, the sums, then texp from the
// partials, on one stream; `scratch` holds B es_scratch_words.
template <bool HDP>
int expect_sums_launch(const Bucket& a, const float* fstack,
                       const float* bstack, const double* cvecf,
                       const double* bo, double* texp, double* kx,
                       double* scratch, cudaStream_t s) {
  const int tiles = es_tiles(a.LX);
  double* part = scratch;
  int* env = reinterpret_cast<int*>(scratch + (size_t)a.B * 7 * a.P * tiles);
  sa_expect_env_kernel<<<a.B, MAX_THREADS, 0, s>>>(a.x0, a.width, a.meta,
                                                   env, a.D1, a.W);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  sa_expect_sums_kernel<HDP>
      <<<dim3(tiles, a.P, a.B), ES_THREADS, 0, s>>>(
          a.x0, a.width, a.ref, a.leg, a.ev, a.meta, a.par, a.h, fstack,
          bstack, cvecf, bo, env, part, kx, a.D1, a.W, a.P, a.LX, a.LE);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  sa_expect_texp_kernel<<<a.B, 32, 0, s>>>(part, texp, a.P * tiles);
  return (int)cudaGetLastError();
}

// the scratch bytes per problem of the sweep's launch (0 unless it is the
// scratch instance's: past CAP)
size_t scratch_bytes(int W, int P, bool expect, bool backward) {
  const int K = launch_k(W, P, expect, backward);
  return K < -MAX_K && !cluster_cfg(W, P, expect, backward).C
             ? 4 * wide_scratch_words(P * W, backward) : 0;
}

}  // namespace

// C interface, loaded with ctypes. Every pointer is a device pointer of a
// contiguous tensor; the kernels launch on `stream`, allocate nothing and
// do not synchronise. leg holds (B, LX, P, ceil(P / 32)) uint32 legality
// masks: the forward's by target path (ProblemTensors.leg), the
// backward's by source path (ProblemTensors.leg_src). `scratch` holds
// B x sa_sweep_scratch_bytes bytes, which the scratch instance (P * W
// past CAP) uses for its ring and cells (null, and unread, otherwise).
// kid, mu, dens and slopes are the HDP tables (kid and mu (B, P, LX),
// dens and slopes (nk, ng) on the grid g0 + i * dx with last knot gN),
// all null for a Gaussian bucket. `expect` != 0 runs the EM expectation
// instances: fstack is (B, D1, 3, P, W), and the backward writes texp (B,
// 7) and adds into kx (B, 3, P, LX), which the caller zeroes, or, on a
// bucket of the P > 2 register instances (expect_split, sa_expect_split),
// writes the three-state stack bstack (B, D1, 3, P, W) instead, from
// which sa_expect_sums then sums them (unused pointers null). Each
// returns cudaGetLastError() after its launch (a
// refused shared-memory size or cluster launch among them; a cluster
// that cannot be scheduled: cudaErrorLaunchOutOfResources), or
// cudaErrorInvalidValue for a shape it does not take (W or P below 1), an
// incomplete set of HDP tables, missing expectation outputs or a missing
// scratch. The backward also takes leg_tgt, the forward's masks
// (ProblemTensors.leg), for its expectation pass (null otherwise).

// launch_k and scratch_bytes, for the Python side
extern "C" int sa_cells_per_thread(int W, int P, int expect, int backward) {
  return launch_k(W, P, expect, backward);
}

// the cluster instance's blocks a problem (C) and threads a block, 0 for
// a bucket it does not take
extern "C" int sa_cluster_ctas(int W, int P, int expect, int backward) {
  return cluster_cfg(W, P, expect, backward).C;
}

extern "C" int sa_cluster_threads(int W, int P, int expect, int backward) {
  return cluster_cfg(W, P, expect, backward).T;
}

extern "C" long long sa_sweep_scratch_bytes(int W, int P, int expect,
                                            int backward) {
  return (long long)scratch_bytes(W, P, expect, backward);
}

// expect_split, and the bytes a problem of sa_expect_sums' scratch
extern "C" int sa_expect_split(int W, int P) { return expect_split(W, P); }

extern "C" long long sa_expect_sums_scratch_bytes(int D1, int P, int LX) {
  return (long long)(8 * es_scratch_words(D1, P, LX));
}

extern "C" int sa_fwd_sweep(const int* x0, const int* width, const float* ref,
                            const unsigned* leg, const float* ev,
                            const int* meta, const float* par, const int* kid,
                            const float* mu, const float* dens,
                            const float* slopes, float* fstack,
                            float* f_incr, float* lse_f, float* scratch,
                            int B, int D1, int W,
                            int P, int LX, int LE, int expect, int nk,
                            int ng, float g0, float dx, float gN,
                            void* stream) {
  const Bucket a{x0, width, ref, leg, ev, meta, par,
                 HdpTab{kid, mu, dens, slopes, nk, ng, g0, dx, gN},
                 B, D1, W, P, LX, LE};
  const int K = launch_k(W, P, expect, false);
  if (K == 0 || !hdp_ok(a.h) ||
      (!scratch && scratch_bytes(W, P, expect, false)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 0 && expect)
    return dens
        ? fwd_paths_dispatch<true, true>(a, fstack, f_incr, lse_f, scratch, s)
        : fwd_paths_dispatch<false, true>(a, fstack, f_incr, lse_f, scratch,
                                          s);
  if (K < 0)
    return dens
        ? fwd_paths_dispatch<true, false>(a, fstack, f_incr, lse_f, scratch,
                                          s)
        : fwd_paths_dispatch<false, false>(a, fstack, f_incr, lse_f, scratch,
                                           s);
  if (expect)
    return dens
        ? fwd_pair_dispatch<true, true>(a, K, fstack, f_incr, lse_f, s)
        : fwd_pair_dispatch<false, true>(a, K, fstack, f_incr, lse_f, s);
  return dens
      ? fwd_pair_dispatch<true, false>(a, K, fstack, f_incr, lse_f, s)
      : fwd_pair_dispatch<false, false>(a, K, fstack, f_incr, lse_f, s);
}

extern "C" int sa_bwd_sweep_compact(
    const int* x0, const int* width, const float* ref, const unsigned* leg,
    const float* ev, const int* meta, const float* par, const int* kid,
    const float* mu, const float* dens, const float* slopes,
    const float* fstack, const double* cvecf, float* b_incr, float* lse_b,
    int* slot_cell, float* slot_val, int* cnt, double* texp, double* kx,
    float* bstack, float* scratch, const unsigned* leg_tgt, int B, int D1,
    int W, int P, int LX, int LE, int R,
    int expect,
    int nk, int ng, float threshold, float g0, float dx,
    float gN, void* stream) {
  const Bucket a{x0, width, ref, leg, ev, meta, par,
                 HdpTab{kid, mu, dens, slopes, nk, ng, g0, dx, gN},
                 B, D1, W, P, LX, LE};
  const int K = launch_k(W, P, expect, true);
  const bool split = expect && expect_split(W, P);
  if (K == 0 || !hdp_ok(a.h) ||
      (expect && (split ? !bstack : !texp || !kx || !leg_tgt)) ||
      (!scratch && scratch_bytes(W, P, expect, true)))
    return (int)cudaErrorInvalidValue;
  const BwdOut o{b_incr, lse_b, slot_cell, slot_val, cnt, texp, kx, bstack};
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 0 && expect)
    return dens ? bwd_paths_dispatch<true, true>(a, fstack, cvecf, o, R,
                                                 threshold, scratch, leg_tgt, s)
                : bwd_paths_dispatch<false, true>(a, fstack, cvecf, o, R,
                                                  threshold, scratch, leg_tgt, s);
  if (K < 0)
    return dens ? bwd_paths_dispatch<true, false>(a, fstack, cvecf, o, R,
                                                  threshold, scratch, leg_tgt, s)
                : bwd_paths_dispatch<false, false>(a, fstack, cvecf, o, R,
                                                   threshold, scratch, leg_tgt, s);
  if (expect)
    return dens ? bwd_pair_dispatch<true, true>(a, K, fstack, cvecf, o, R,
                                                threshold, s)
                : bwd_pair_dispatch<false, true>(a, K, fstack, cvecf, o, R,
                                                 threshold, s);
  return dens ? bwd_pair_dispatch<true, false>(a, K, fstack, cvecf, o, R,
                                               threshold, s)
              : bwd_pair_dispatch<false, false>(a, K, fstack, cvecf, o, R,
                                                threshold, s);
}

// sa_expect_sums: texp (B, 7) and, in a Gaussian bucket, kx (B, 3, P, LX)
// (every entry written; null and untouched in an HDP bucket) of a bucket
// of the P > 2 register instances (expect_split) from the forward's and
// the backward's three-state stacks (B, D1, 3, P, W), cvecf (B, D1) =
// Fo(d) - total_f and the backward offsets bo (B, D1) = Bo(d), both
// float64; leg holds the forward's masks (ProblemTensors.leg), scratch
// B x sa_expect_sums_scratch_bytes bytes. Three launches on `stream`;
// returns the first error, or cudaErrorInvalidValue for a bucket that is
// not expect_split, incomplete HDP tables or a missing output.
extern "C" int sa_expect_sums(
    const int* x0, const int* width, const float* ref, const unsigned* leg,
    const float* ev, const int* meta, const float* par, const int* kid,
    const float* mu, const float* dens, const float* slopes,
    const float* fstack, const float* bstack, const double* cvecf,
    const double* bo, double* texp, double* kx, double* scratch, int B,
    int D1, int W, int P, int LX, int LE, int nk, int ng, float g0, float dx,
    float gN, void* stream) {
  const Bucket a{x0, width, ref, leg, ev, meta, par,
                 HdpTab{kid, mu, dens, slopes, nk, ng, g0, dx, gN},
                 B, D1, W, P, LX, LE};
  if (!expect_split(W, P) || !hdp_ok(a.h) || !texp || !scratch ||
      (!dens && !kx))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dens ? expect_sums_launch<true>(a, fstack, bstack, cvecf, bo, texp,
                                         nullptr, scratch, s)
              : expect_sums_launch<false>(a, fstack, bstack, cvecf, bo, texp,
                                          kx, scratch, s);
}
