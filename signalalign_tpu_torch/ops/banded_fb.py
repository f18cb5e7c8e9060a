"""Banded forward-backward for the port: the host problem build (numpy,
field for field with ``signalalign_tpu.ops.banded_fb``) and the plain
PyTorch DP.

The DP is the ``MODE_MEAN_ONLY`` and ``MODE_HDP`` specialisation of the
JAX ``_banded_sweeps_core`` for any number P >= 1 of paths per cell: a
Python loop over anti-diagonals, vectorised over problems x paths x band
offsets, in the band-offset frame (cell (d, p, o) is x = x0[d] + o, y =
d - x on path p). gapX and match take the legal logsumexp over source paths, gapY
stays on its path, and one max over all states, paths and offsets
normalises a diagonal, so a problem's paths share one frame per diagonal
and the totals are joint over paths. Every stored diagonal is
max-normalised and
the per-diagonal offsets are returned as increments whose float64 prefix
sums restore absolute log-probabilities. It is the CPU path of the port
and the plain version each Hopper kernel (``banded_fb_hopper``) is held
against on the card.

``sweep_forward_prob`` / ``sweep_backward_prob`` are the same DP in
probability space at P = 1 (the JAX ``log_space=False`` kernels): f32
probabilities rescaled to 2^100 per diagonal, event-normalised
emissions, the same output contract; exact only while a band's range
fits f32, which the callers check (``HopperAligner``'s
``numerics_suspect``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from signalalign_tpu_torch.models.pore_model import (GAP_X, GAP_Y, LOG_ZERO,
                                                     MATCH, PoreModel,
                                                     ScalingParams, T_MM,
                                                     T_MX, T_MY, T_XM, T_XX,
                                                     T_YM, T_YY)
from signalalign_tpu_torch.ops.band_geometry import band_widths, build_band
from signalalign_tpu_torch.utils.alphabet import expand_kmer_paths

NEG = -1.0e30  # finite log-zero: no inf - inf NaNs
DTYPE = np.float32
LOG_GAPX_EMISSION = math.log(0.1)  # stateMachine3_construct (stateMachine.c:1586)

# emission modes
MODE_MEAN_ONLY = 0      # log(1/var) + N(descaled mean; mu, sd)     [production]
MODE_FULL = 1           # N(mean; mu, sd) + invGauss(noise; nm, lam) [no descale]
MODE_FULL_DESCALED = 2  # N(descaled) + invGauss(noise)
MODE_HDP = 3            # log((1/var) * hdp_spline(descaled mean))

# per-position match/stay parameter layout (NPAR, P, LX):
#   0: m_hat   = scale*mu + shift          (expected scaled level mean)
#   1: inv_m   = 1/(var*sd_match)
#   2: c_m     = -log sqrt(2pi) - log sd_match - log var   (match const)
#   3: inv_y   = 1/(var*sd_stay)
#   4: c_y     = const for stay (sd*1.75 table)
#   5: nm      = noise mean (possibly rescaled)
#   6: nlam    = noise lambda
#   7: mu      = unscaled level mean (descaling ref, full modes)
#   8: sd_m    = level sd
#   9: sd_y    = stay level sd
NPAR = 10
# event parameter layout (NEVP, LE) in REVERSED order (see prepare):
#   0: mean (drift-adjusted)   1: noise (sd)   2: log(noise)   3: valid(0/1)
NEVP = 4

# ---- device layout of one bucket (ProblemTensors), read by the kernels
NREF = 5    # ref rows: m_hat, inv_m, c_m, inv_y, c_y (ref_params rows 0-4)
NEV = 2     # ev rows: reversed event mean, valid flag (ev_params rows 0, 3)
# meta columns (int32)
M_LX, M_LY, M_NDIAG, M_EVPAD, M_REFLEN, M_EVLEN = range(6)
NMETA = 8
# par columns (float32)
PACK_TRANS = 0    # 9 log transitions
PACK_START = 9    # 3 start-state logs
PACK_END = 12     # 3 end-state logs
PACK_GAPX = 15    # gapX log emission
PACK_VAR = 16     # the read's var (HDP descaling and density prefactor)
NPACK = 17

# ---- the probability-space DP (the JAX ``log_space=False`` kernels,
# ``ops/banded_fb_pallas_batch.py:65-75``): each diagonal's max rescaled
# to SCALE, so f32 covers ~157 nats below a diagonal's ridge
SCALE = float(2.0 ** 100)
LOG_SCALE = float(100.0 * np.log(2.0))
PROB_MAX_W = 512     # the widest band the JAX runner sends to them


@dataclasses.dataclass
class BandedProblem:
    """Host-side arrays describing one read segment's banded DP."""
    # static-ish metadata
    lX: int
    lY: int
    n_diag: int                    # lX + lY (index of final diagonal)
    mode: int
    log_trans: np.ndarray          # (9,) f32
    start_logs: np.ndarray         # (3,) f32
    end_logs: np.ndarray           # (3,) f32
    var: float
    # per-diagonal geometry (length Dpad+1)
    x0: np.ndarray                 # i32
    width: np.ndarray              # i32
    # per-position tables
    ref_params: np.ndarray         # (NPAR, P, LXpad) f32
    kmer_ids: np.ndarray           # (P, LXpad) i32  (for HDP / outputs)
    path_valid: np.ndarray         # (P, LXpad) bool
    legal: np.ndarray              # (P, P, LXpad) bool  legal[p_to, q_from, x]
    n_paths: np.ndarray            # (LXpad,) i32
    # reversed event tables
    ev_params: np.ndarray          # (NEVP, LEpad) f32
    ev_front_pad: int              # index offset of j=0 in ev arrays
    # HDP density tables (MODE_HDP): (num_kmers, grid), (num_kmers, grid),
    # (2,)=[grid_start, grid_step]
    hdp_dens: Optional[np.ndarray] = None
    hdp_slopes: Optional[np.ndarray] = None
    hdp_grid: Optional[np.ndarray] = None
    # per-event best-case match log-emission + its sum over valid events,
    # which only the probability-space sweeps read: formed by
    # event_normaliser from norm_source (Gaussian problems: the float64
    # event means, the model and the read's scaling)
    ev_best: Optional[np.ndarray] = None
    ev_norm_total: float = 0.0
    norm_source: Optional[tuple] = None
    # bookkeeping for output decoding
    num_kmers: int = 0             # model alphabet size**k (emission EM)
    seq: str = ""                  # segment nucleotide sequence
    kmer_len: int = 0
    path_kmers: Optional[List[List[str]]] = None  # per position path kmers
                                                  # (None for canonical P==1)
    # lane packing: per packed sub-segment (orig_problem, ox, oy, d_start,
    # d_end); None for ordinary problems
    segments: Optional[List[Tuple]] = None
    # per-x 1/var (cross-read packing; scalar ``var`` otherwise)
    ivar_by_x: Optional[np.ndarray] = None

    def path_kmer_at(self, x: int, p: int) -> Optional[str]:
        """Path k-mer string for cell x (1-based), path slot p."""
        if self.path_kmers is not None:
            row = self.path_kmers[x - 1]
            return row[p] if p < len(row) else None
        return self.seq[x - 1:x - 1 + self.kmer_len] if p == 0 else None


def start_state_logs(model: PoreModel, ragged: bool) -> np.ndarray:
    """Start-state log weights (match only, or the two gap states for a
    ragged start); the float64 oracle's ``start_state_logs``."""
    out = np.full(3, LOG_ZERO)
    if ragged:
        out[GAP_X] = 0.0
        out[GAP_Y] = 0.0
    else:
        out[MATCH] = 0.0
    return out


def end_state_logs(model: PoreModel, ragged: bool) -> np.ndarray:
    """End-state log weights from the model's transitions; the float64
    oracle's ``end_state_logs``."""
    t = model.log_transitions
    out = np.empty(3)
    if ragged:
        out[MATCH] = (t[T_MX] + t[T_MY]) / 2.0
        out[GAP_X] = t[T_XX]
        out[GAP_Y] = t[T_YY]
    else:
        out[MATCH] = t[T_MM]
        out[GAP_X] = t[T_XM]
        out[GAP_Y] = t[T_YM]
    return out


def _gauss_const(sd):
    return -0.91893853320467267 - np.log(sd)


def prepare_problem(
    seq: str,
    events: np.ndarray,            # (lY, >=3): mean, noise, [duration, start]
    model: PoreModel,
    params: ScalingParams,
    ambig_map: Dict[str, str],
    W: int,
    Dpad: int,
    P: int,
    mode: int = MODE_MEAN_ONLY,
    anchor_pairs: Sequence[Tuple[int, int]] = (),
    expansion: int = 20,
    ragged_start: bool = True,
    ragged_end: bool = True,
    scale_noise: bool = False,
    drift_deltas: Optional[np.ndarray] = None,
    hdp=None,
) -> BandedProblem:
    """Precompute all device arrays for one segment.

    ``W`` must be >= the maximum band width; ``Dpad`` >= lX+lY; ``P`` >= the
    maximum paths per cell. ``drift_deltas`` optionally supplies per-event
    delta-times for drift correction of event means (nanopore.c:633-653).
    The probability-space sweeps' event normaliser is left to
    ``event_normaliser``: a best case over every k-mer of the model for
    each event, the bulk of a Gaussian problem's prep at 46,656 k-mers.
    """
    k = model.kmer_length
    lX = len(seq) - k + 1
    lY = len(events)
    if lX < 1 or lY < 1:
        raise ValueError("empty sequence or events")

    xmyL, xmyR = build_band(anchor_pairs, lX, lY, expansion)
    widths = band_widths(xmyL, xmyR)
    if widths.max() > W:
        raise ValueError(f"band width {widths.max()} exceeds W={W}")
    D = lX + lY
    if D > Dpad:
        raise ValueError(f"diagonal count {D} exceeds Dpad={Dpad}")

    x0 = np.zeros(Dpad + 1, dtype=np.int32)
    width = np.zeros(Dpad + 1, dtype=np.int32)
    x0[:D + 1] = (np.arange(D + 1) + xmyL) // 2
    width[:D + 1] = widths
    # pad diagonals: keep slice starts in range (masked anyway)
    if Dpad > D:
        x0[D + 1:] = x0[D]

    # ---- per-position path expansion
    LXpad = lX + 1 + W
    kmer_ids = np.zeros((P, LXpad), dtype=np.int32)
    path_valid = np.zeros((P, LXpad), dtype=bool)
    n_paths = np.zeros(LXpad, dtype=np.int32)
    n_paths[0] = 1  # null boundary cell
    legal = np.zeros((P, P, LXpad), dtype=bool)
    has_ambig = any(c in ambig_map for c in set(seq))

    if P == 1 and not has_ambig:
        # canonical fast path: fully vectorized, k-mer strings decoded lazily
        path_kmers = None
        kmer_ids[0, 1:lX + 1] = model.alphabet.seq_to_kmer_ids(seq)
        path_valid[0, 1:lX + 1] = True
        n_paths[1:lX + 1] = 1
        legal[0, 0, 1:lX + 1] = True
    else:
        path_kmers = []
        for i in range(lX):
            paths = expand_kmer_paths(seq[i:i + k], ambig_map)
            if len(paths) > P:
                raise ValueError(
                    f"position {i} expands to {len(paths)} paths > P={P}")
            path_kmers.append(paths)
            x = i + 1
            n_paths[x] = len(paths)
            for p, pk in enumerate(paths):
                kmer_ids[p, x] = model.alphabet.kmer_index(pk)
                path_valid[p, x] = True
        # legality masks: legal[p, q, x] == transition from path q of cell
        # x-1 into path p of cell x is legal (path_checkLegal semantics)
        for x in range(1, lX + 1):
            if x == 1:
                for p in range(int(n_paths[1])):
                    legal[p, 0, 1] = True  # from the null boundary path
            else:
                prev = path_kmers[x - 2]
                cur = path_kmers[x - 1]
                for p, pk in enumerate(cur):
                    for q, qk in enumerate(prev):
                        legal[p, q, x] = qk[1:] == pk[:-1]

    # ---- per-position emission parameters
    if scale_noise:
        nm_t, ns_t, nl_t = model.scaled_noise_tables(params)
    else:
        nm_t, ns_t, nl_t = model.noise_mean, model.noise_sd, model.noise_lambda

    ref_params = np.zeros((NPAR, P, LXpad), dtype=np.float64)
    ids = kmer_ids[path_valid]
    mu = model.level_mean
    sd_m = model.level_sd
    sd_y = model.gap_y_level_sd

    def fill(slot, values_per_kmer):
        buf = np.zeros((P, LXpad))
        buf[path_valid] = values_per_kmer[ids]
        ref_params[slot] = buf

    fill(0, params.scale * mu + params.shift)
    with np.errstate(divide="ignore"):
        fill(1, 1.0 / (params.var * sd_m))
        fill(2, _gauss_const(sd_m) - math.log(params.var))
        fill(3, 1.0 / (params.var * sd_y))
        fill(4, _gauss_const(sd_y) - math.log(params.var))
    fill(5, nm_t)
    fill(6, nl_t)
    fill(7, mu)
    fill(8, sd_m)
    fill(9, sd_y)

    # ---- reversed event arrays
    ev_front_pad = 2
    LEpad = lY + ev_front_pad + W + 4
    ev_params = np.zeros((NEVP, LEpad), dtype=np.float64)
    means = events[:, 0].astype(np.float64).copy()
    if drift_deltas is not None and params.drift != 0.0:
        means = means - params.drift * np.asarray(drift_deltas, dtype=np.float64)
    noise = events[:, 1].astype(np.float64)
    noise = np.where(noise == 0.0, 1e-9, noise)
    # j = lY - y for y in 1..lY  ->  reversed order
    rev = slice(ev_front_pad, ev_front_pad + lY)
    ev_params[0, rev] = means[::-1]
    ev_params[1, rev] = noise[::-1]
    ev_params[2, rev] = np.log(noise[::-1])
    ev_params[3, rev] = 1.0

    hdp_dens = hdp_slopes = hdp_grid = None
    if mode == MODE_HDP:
        if hdp is None:
            raise ValueError("MODE_HDP requires an hdp model")
        # the HDP's own float32 tables, converted once and shared by every
        # problem (not copied per problem)
        hdp_dens, hdp_slopes, g0, dx = hdp.density_arrays()
        hdp_grid = np.array([g0, dx], dtype=np.float32)

    start = start_state_logs(model, ragged_start)
    end = end_state_logs(model, ragged_end)
    return BandedProblem(
        lX=lX, lY=lY, n_diag=D, mode=mode,
        log_trans=np.where(np.isfinite(model.log_transitions),
                           model.log_transitions, NEG).astype(DTYPE),
        start_logs=np.where(np.isfinite(start), start, NEG).astype(DTYPE),
        end_logs=np.where(np.isfinite(end), end, NEG).astype(DTYPE),
        var=float(params.var),
        x0=x0, width=width,
        ref_params=ref_params.astype(DTYPE),
        kmer_ids=kmer_ids, path_valid=path_valid, legal=legal, n_paths=n_paths,
        ev_params=ev_params.astype(DTYPE), ev_front_pad=ev_front_pad,
        norm_source=((means, model, params) if mode == MODE_MEAN_ONLY
                     else None),
        hdp_dens=hdp_dens, hdp_slopes=hdp_slopes, hdp_grid=hdp_grid,
        num_kmers=model.alphabet.num_kmers,
        seq=seq, kmer_len=k, path_kmers=path_kmers,
    )


def event_normaliser(p: BandedProblem) -> BandedProblem:
    """Form ``p.ev_best`` and ``p.ev_norm_total`` once, from
    ``p.norm_source``: for each event the best-case match log-emission
    over ALL model k-mers (the probability-space sweeps subtract it inside
    each emission's exponent and add the sum back to the totals), the JAX
    ``prepare_problem``'s fields."""
    if p.ev_best is not None or p.norm_source is None:
        return p
    means, model, params = p.norm_source
    mu_hat_all = params.scale * model.level_mean + params.shift
    with np.errstate(divide="ignore"):
        inv_all = 1.0 / (params.var * model.level_sd)
        cst_all = _gauss_const(model.level_sd) - math.log(params.var)
    best = np.full(p.lY, -1e30)
    for k0 in range(0, len(mu_hat_all), 512):
        z = (means[:, None] - mu_hat_all[None, k0:k0 + 512]) \
            * inv_all[None, k0:k0 + 512]
        cand = cst_all[None, k0:k0 + 512] - 0.5 * z * z
        best = np.maximum(best, cand.max(axis=1))
    ev_best = np.zeros(p.ev_params.shape[1], dtype=DTYPE)
    ev_best[p.ev_front_pad:p.ev_front_pad + p.lY] = best[::-1]
    p.ev_best, p.ev_norm_total = ev_best, float(best.sum())
    return p


def extract_aligned_pairs(problem: BandedProblem, post: np.ndarray,
                          threshold: float = 0.01) -> List[Tuple[int, int, int, str]]:
    """Threshold the posterior band tensor into (prob_int, x, y, kmer) pairs.

    Output matches diagonalCalculationPosteriorMatchProbs
    (pairwiseAligner.c:1355-1420): coordinates are 0-based sequence indices,
    probability is floor(p * 1e7).
    """
    D = problem.n_diag
    out = []
    hits = np.argwhere(post[:D + 1] >= threshold)
    for d, p, o in hits:
        x = int(problem.x0[d]) + int(o)
        y = int(d) - x
        if x <= 0 or y <= 0 or x > problem.lX or y > problem.lY:
            continue
        kmer = problem.path_kmer_at(x, p)
        if kmer is None:
            continue
        prob = min(float(post[d, p, o]), 1.0)
        out.append((int(prob * 10000000), x - 1, y - 1, kmer))
    out.sort(key=lambda r: (r[1] + r[2], r[1]))
    return out


# --------------------------------------------------------------------------
# device layout of one bucket
# --------------------------------------------------------------------------

def leg_words(P: int) -> int:
    """32-bit legality words per (position, path) at P paths per cell:
    one bit per path at the other end of a transition."""
    return (P + 31) // 32


@dataclasses.dataclass
class ProblemTensors:
    """The problems of one bucket as padded tensors on one device: the
    layout both the plain DP below and the Hopper kernels read.

    ``D1`` = max(n_diag) + 1 diagonals; ``ref``/``leg``/``ev`` are padded
    along their last axis to the bucket's longest problem, and each
    problem's own lengths sit in ``meta`` (M_REFLEN, M_EVLEN) so windows
    clamp exactly as the JAX package's per-problem dynamic slices do.
    ``leg[b, x, p_to * NW + q_from // 32]`` holds ``legal[p_to, q_from,
    x]`` in bit q_from % 32, NW = ``leg_words(P)`` words per (position,
    path): one word at P <= 32; ``leg_src[b, x, q_from * NW + p_to //
    32]`` the same in bit p_to % 32 (the backward kernel's reads: the
    legal targets of a source path), derived from ``leg`` on the device
    for a CUDA bucket (None on the CPU).
    Path slots a position does not use have zero ``ref`` rows (inv_m = 0
    marks them invalid, as in the JAX emissions).
    """
    W: int
    P: int
    n_diag: List[int]      # host copy of meta[:, M_NDIAG]
    x0: torch.Tensor       # (B, D1) int32 band origin per diagonal
    width: torch.Tensor    # (B, D1) int32 band width per diagonal
    ref: torch.Tensor      # (B, NREF, P, LX) f32
    leg: torch.Tensor      # (B, LX, P * NW) int32 legality masks by target
    leg_src: Optional[torch.Tensor]  # (B, LX, P * NW) int32 by source path
    ev: torch.Tensor       # (B, NEV, LE) f32
    meta: torch.Tensor     # (B, NMETA) int32
    par: torch.Tensor      # (B, NPACK) f32
    # MODE_HDP buckets only (None for Gaussian ones): per-(problem, path,
    # position) k-mer ids and unscaled level means (ref_params row 7), in
    # the layout of ``ref``, and the run's shared density tables; the
    # k-mer ids also in Gaussian buckets made for EM (the kexp keys)
    kid: Optional[torch.Tensor] = None    # (B, P, LX) int32
    mu: Optional[torch.Tensor] = None     # (B, P, LX) f32
    hdp: Optional["HdpTables"] = None
    # probability-space buckets only (``problem_tensors(..., prob=True)``)
    prob: Optional["ProbTensors"] = None

    @property
    def device(self) -> torch.device:
        return self.x0.device


@dataclasses.dataclass
class ProbTensors:
    """What the probability-space sweeps read beside ``ProblemTensors``
    (P = 1, Gaussian): the JAX aligner's pre-exponentiated emission
    constants and pack, and the event normaliser
    (``banded_fb_pallas_batch.py:2295-2313``)."""
    cexp: torch.Tensor     # (B, 2, LX) f32 exp(c_m), exp(c_y) (ref rows 2, 4)
    ev_best: torch.Tensor  # (B, LE) f32 per-event best-case match log-emission
    par: torch.Tensor      # (B, NPACK) f32 exp of ``par``'s logs (NEG -> 0)
    ev_norm: torch.Tensor  # (B,) f64 sum of ev_best over each problem's events


def prob_pack(problem: BandedProblem) -> np.ndarray:
    """The JAX ``_pack16`` in the ``par`` layout: the exp of the
    transition, start, end and gapX log parameters taken in float64, so
    that NEG gives an exact 0 (PACK_VAR keeps the var)."""
    out = np.full(NPACK, NEG, np.float64)
    out[PACK_TRANS:PACK_TRANS + 9] = problem.log_trans
    out[PACK_START:PACK_START + 3] = problem.start_logs
    out[PACK_END:PACK_END + 3] = problem.end_logs
    out[PACK_GAPX] = LOG_GAPX_EMISSION
    with np.errstate(over="ignore"):
        out = np.exp(out).astype(np.float32)
    out[PACK_VAR] = problem.var
    return out


def check_prob(W: int, P: int, hdp: bool, expect: bool = False) -> None:
    """The probability-space sweeps take what the JAX ``log_space=False``
    kernels take (``PallasBatchAligner`` ``:2197-2212``): one path per
    cell, Gaussian emissions, no expectation pass; and bands of at most
    PROB_MAX_W offsets, the runner's gate."""
    if P != 1 or hdp or expect or W > PROB_MAX_W:
        raise ValueError(
            f"the probability-space sweeps take P = 1 Gaussian buckets of "
            f"W <= {PROB_MAX_W} without expectations (P={P}, W={W}, HDP "
            f"{hdp}, expect {expect})")


@dataclasses.dataclass
class HdpTables:
    """An HDP's float32 density and slope tables on one device, with its
    grid g0 + i * dx, i < NG (``gN`` its last knot). g0, dx and gN are
    float32 values (held as Python floats), computed as the JAX package
    computes them, so the kernels and their twins use the same numbers.
    One instance serves every bucket of a run."""
    dens: torch.Tensor     # (K, NG) f32
    slopes: torch.Tensor   # (K, NG) f32
    g0: float
    dx: float
    gN: float

    @property
    def NG(self) -> int:
        return self.dens.shape[1]

    @property
    def K(self) -> int:
        return self.dens.shape[0]


def hdp_spline_density(x, kid, tables: HdpTables):
    """Hermite spline density of k-mer ``kid`` at ``x`` (same shapes) on
    the HDP grid, linear past either end, clamped at 0: the plain twin of
    the kernels' spline and the JAX ``hdp_spline_density``
    (``ops/banded_fb.py:351``), whose formula it keeps. The interval index
    is floor((x - g0) / dx) clamped to [0, NG - 2], as in the kernels."""
    NG, g0, dx, gN = tables.NG, tables.g0, tables.dx, tables.gN
    # divide by a tensor on x's device: PyTorch's CUDA division by a
    # Python number multiplies by its reciprocal, which rounds otherwise
    # than the kernels' (and the JAX package's) division
    dx_t = torch.tensor(dx, dtype=x.dtype, device=x.device)
    il = torch.clamp(torch.floor((x - g0) / dx_t), 0, NG - 2)
    row = torch.clamp(kid.long(), 0, tables.K - 1) * NG
    i = row + il.long()
    dens = tables.dens.reshape(-1)
    slopes = tables.slopes.reshape(-1)
    yl, yr = dens[i], dens[i + 1]
    sl, sr = slopes[i], slopes[i + 1]
    dy = yr - yl
    a = sl * dx - dy
    b = dy - sr * dx
    tl = (x - (g0 + il * dx)) / dx_t
    tr = 1.0 - tl
    mid = tr * yl + tl * yr + tl * tr * (a * tr + b * tl)
    below = dens[row] - slopes[row] * (g0 - x)
    above = dens[row + NG - 1] + slopes[row + NG - 1] * (x - gN)
    v = torch.where(x <= g0, below, torch.where(x >= gN, above, mid))
    return torch.clamp(v, min=0.0)


def hdp_log_emission(x, kid, var, tables: HdpTables):
    """log((1/var) * spline density), NEG where the density is 0 (the XLA
    ``_emissions_at`` MODE_HDP)."""
    v = hdp_spline_density(x, kid, tables) / var
    return torch.where(v > 0, torch.log(torch.clamp(v, min=1e-37)), NEG)


# --------------------------------------------------------------------------
# plain PyTorch DP (P >= 1 paths, MODE_MEAN_ONLY or MODE_HDP)
# --------------------------------------------------------------------------

def _lae(a, b):
    return torch.logaddexp(a, b)


def _cols(table, start, length, W: int):
    """(B, ..., L) table -> (B, ..., W) columns [s, s+W) per problem, with
    s = start clamped to [0, length - W] (jax.lax.dynamic_slice's clamp);
    returns the window and its (B, W) column indices."""
    s = torch.minimum(torch.clamp(start, min=0), length - W)
    idx = s[:, None] + torch.arange(W, device=table.device)
    flat = table.reshape(table.shape[0], -1, table.shape[-1])
    win = torch.gather(flat, 2, idx[:, None, :].expand(-1, flat.shape[1], -1))
    return win.reshape(*table.shape[:-1], W), idx


def _legal(legT, start, length, W: int, P: int):
    """(B, P_to, P_from, W) bool legality window at columns [s, s+W) of
    the masks ``legT`` (B, P * NW, LX) (``ProblemTensors.leg``
    transposed): bit q % 32 of word q // 32 of each target path."""
    win, _ = _cols(legT, start, length, W)
    win = win.reshape(win.shape[0], P, -1, W)          # (B, P, NW, W)
    q = torch.arange(P, device=win.device)
    words = win[:, :, q // 32]                         # (B, P, P, W)
    return ((words >> (q % 32)[None, None, :, None]) & 1).bool()


def _window(prev, shift, W: int, fill: float = NEG):
    """(B, S, P, W) diagonal -> (B, S, P, W+1) with out[..., i] =
    prev[..., i+shift] where 0 <= i+shift < W and ``fill`` elsewhere (the
    JAX ``_window2``; 0 in probability space)."""
    idx = shift[:, None] + torch.arange(W + 1, device=prev.device)
    ok = (idx >= 0) & (idx < W)
    g = torch.gather(prev, 3, idx.clamp(0, W - 1)[:, None, None, :]
                     .expand(-1, prev.shape[1], prev.shape[2], -1))
    return torch.where(ok[:, None, None, :], g, fill)


def _legal_reduce(src, legal):
    """logsumexp over source paths q of ``src`` (B, Q, W) where
    ``legal`` (B, P, Q, W) allows it -> (B, P, W); the JAX
    ``_legal_reduce``, summing the paths in order (as the kernels do).
    At P = 1 it returns the masked source bit for bit (exp(0) = 1,
    log(1) = 0)."""
    masked = torch.where(legal, src[:, None], NEG)
    m = masked.amax(dim=2)
    e = torch.exp(masked - m[:, :, None])
    s = e[:, :, 0]
    for q in range(1, e.shape[2]):
        s = s + e[:, :, q]
    return m + torch.log(torch.clamp(s, min=1e-37))


def _emissions(refw, evw, gapx, hdpw=None):
    """Match / stay / gapX log emissions, (B, P, W) each, from
    (B, NREF, P, W) reference and (B, NEV, W) event windows: mean-only
    Gaussian, or with ``hdpw`` = (k-mer id window, level-mean window (B,
    P, W), var (B, 1, 1), HdpTables) the HDP spline of the descaled mean
    x = mu + (mean - m_hat) / var, stay = match (the XLA formula)."""
    m_hat, inv_m, c_m, inv_y, c_y = refw.unbind(1)
    ev_mean = evw[:, 0, None]
    if hdpw is None:
        am = (ev_mean - m_hat) * inv_m
        ay = (ev_mean - m_hat) * inv_y
        e_match = c_m - 0.5 * am * am
        e_stay = c_y - 0.5 * ay * ay
    else:
        kidw, muw, var, tables = hdpw
        e_match = e_stay = hdp_log_emission(muw + (ev_mean - m_hat) / var,
                                            kidw, var, tables)
    kvalid = inv_m > 0.0
    ok = kvalid & (evw[:, 1, None] > 0.5)
    return (torch.where(ok, e_match, NEG), torch.where(ok, e_stay, NEG),
            torch.where(kvalid, gapx, NEG))


def _diag_max(cur):
    """Per-problem max over a (B, 3, P, W) diagonal; 0 for an empty one."""
    m = cur.amax(dim=(1, 2, 3))
    return torch.where(m > NEG * 0.5, m, 0.0)


def _lse(cur, logs):
    """Per-problem logsumexp of a (B, 3, P, W) diagonal weighted by (B, 3)."""
    v = torch.clamp(cur + logs[:, :, None, None], min=NEG)
    return torch.logsumexp(v.reshape(v.shape[0], -1), dim=1)


def _hdp_window(pt: ProblemTensors, start, length):
    """The HDP arguments of ``_emissions`` at columns [s, s+W) of each
    problem; None for a Gaussian bucket."""
    if pt.hdp is None:
        return None
    kidw, _ = _cols(pt.kid, start, length, pt.W)
    muw, _ = _cols(pt.mu, start, length, pt.W)
    return kidw, muw, pt.par[:, PACK_VAR, None, None], pt.hdp


def _unpack(pt: ProblemTensors):
    meta = pt.meta.long()
    t = pt.par[:, PACK_TRANS:PACK_TRANS + 9, None, None]  # t[:, T_xx]: (B, 1, 1)
    return (meta[:, M_LX], meta[:, M_LY], meta[:, M_NDIAG], meta[:, M_EVPAD],
            meta[:, M_REFLEN], meta[:, M_EVLEN], t,
            pt.par[:, PACK_START:PACK_START + 3],
            pt.par[:, PACK_END:PACK_END + 3], pt.par[:, PACK_GAPX, None, None])


def sweep_forward(pt: ProblemTensors, store_full: bool = False):
    """Forward sweep over diagonals 0..D1-1.

    Returns (fstack (B, D1, P, W) f32 normalised match rows, f_incr
    (B, D1) per-diagonal offsets, lse_f (B,) end-weighted logsumexp over
    all states and paths at n_diag: the joint total's log-sum term).
    ``store_full`` keeps all three states, fstack (B, D1, 3, P, W) (the
    JAX ``store_full``; the EM expectation pass reads them).
    """
    B, D1 = pt.x0.shape
    W, P = pt.W, pt.P
    dev = pt.device
    lX, lY, nd, efp, reflen, evlen, t, start, end, gapx = _unpack(pt)
    x0 = pt.x0.long()
    width = pt.width.long()
    o = torch.arange(W, device=dev)
    no_diag = torch.full((B,), W + 5, dtype=torch.long, device=dev)

    fstack = torch.full((B, D1, 3, P, W) if store_full else (B, D1, P, W),
                        NEG, device=dev)
    f_incr = torch.zeros(B, D1, device=dev)
    lse_f = torch.zeros(B, device=dev)
    prev1 = torch.full((B, 3, P, W), NEG, device=dev)
    prev1[:, :, 0, 0] = start
    fstack[:, 0] = prev1 if store_full else prev1[:, MATCH]
    prev2 = torch.full((B, 3, P, W), NEG, device=dev)
    m_prev = torch.zeros(B, device=dev)
    finals = set(pt.n_diag)
    legT = pt.leg.transpose(1, 2).contiguous()
    for d in range(1, D1):
        xd = x0[:, d]
        refw, _ = _cols(pt.ref, xd, reflen, W)
        legw = _legal(legT, xd, reflen, W, P)
        evw, _ = _cols(pt.ev, lY - d + xd + efp, evlen, W)
        e_match, e_stay, e_gapx = _emissions(refw, evw, gapx,
                                             _hdp_window(pt, xd, reflen))

        shift1 = xd - x0[:, d - 1] - 1
        shift2 = xd - x0[:, d - 2] - 1 if d >= 2 else no_diag
        w1 = _window(prev1, shift1, W)    # [..., :W] lower, [..., 1:] upper
        w2 = _window(prev2, shift2, W)    # relative to offset(prev1) + m_prev

        # gapX from (x-1, y) and match from (x-1, y-1), both over the legal
        # source paths; gapY from (x, y-1) on its own path
        src_x = _lae(w1[:, MATCH, :, :W] + t[:, T_MX],
                     w1[:, GAP_X, :, :W] + t[:, T_XX])
        gx = _legal_reduce(src_x, legw) + e_gapx
        src_m = _lae(_lae(w2[:, MATCH, :, :W] + t[:, T_MM],
                          w2[:, GAP_X, :, :W] + t[:, T_XM]),
                     w2[:, GAP_Y, :, :W] + t[:, T_YM]) - m_prev[:, None, None]
        mm = _legal_reduce(src_m, legw) + e_match
        gy = _lae(w1[:, MATCH, :, 1:] + t[:, T_MY],
                  w1[:, GAP_Y, :, 1:] + t[:, T_YY]) + e_stay

        cur = torch.stack([mm, gx, gy], dim=1)
        inband = (o < width[:, d, None]) & (d <= nd)[:, None]
        cur = torch.where(inband[:, None, None, :], cur, NEG)
        m = _diag_max(cur)
        cur = torch.clamp(cur - m[:, None, None, None], min=NEG)
        fstack[:, d] = cur if store_full else cur[:, MATCH]
        f_incr[:, d] = m
        if d in finals:
            lse_f = torch.where(nd == d, _lse(cur, end), lse_f)
        prev2, prev1, m_prev = prev1, cur, m
    return fstack, f_incr, lse_f


def sweep_backward(pt: ProblemTensors, store_full: bool = False):
    """Backward sweep over diagonals D1-1..0.

    Returns (bstack (B, D1, P, W) f32 normalised match rows, b_incr
    (B, D1) per-diagonal offsets, lse_b (B,) start-weighted logsumexp at
    d = 0); ``store_full``: bstack (B, D1, 3, P, W), all three states.
    """
    B, D1 = pt.x0.shape
    W, P = pt.W, pt.P
    dev = pt.device
    lX, lY, nd, efp, reflen, evlen, t, start, end, gapx = _unpack(pt)
    x0 = pt.x0.long()
    width = pt.width.long()
    o = torch.arange(W, device=dev)
    no_diag = torch.full((B,), W + 5, dtype=torch.long, device=dev)

    bstack = torch.full((B, D1, 3, P, W) if store_full else (B, D1, P, W),
                        NEG, device=dev)
    b_incr = torch.zeros(B, D1, device=dev)
    b1 = torch.full((B, 3, P, W), NEG, device=dev)
    b2 = torch.full((B, 3, P, W), NEG, device=dev)
    m_prev = torch.zeros(B, device=dev)
    cur = b1
    legT = pt.leg.transpose(1, 2).contiguous()
    for d in range(D1 - 1, -1, -1):
        xd = x0[:, d]
        # TO-cell windows: match/gapX targets at x+1 (every legal target
        # path), gapY target at x (own path), all consuming event y+1
        refx1, _ = _cols(pt.ref, xd + 1, reflen, W)
        refx0, _ = _cols(pt.ref, xd, reflen, W)
        # legal[p_to, q_from] at x+1, read from the source path q
        leg_t = _legal(legT, xd + 1, reflen, W, P).transpose(1, 2)
        evy1, _ = _cols(pt.ev, lY - d + xd + efp - 1, evlen, W)
        e_match_to = _emissions(refx1, evy1, gapx,
                                _hdp_window(pt, xd + 1, reflen))[0]
        e_stay_same = _emissions(refx0, evy1, gapx,
                                 _hdp_window(pt, xd, reflen))[1]
        gapx_valid = torch.where(refx1[:, 1] > 0.0, gapx, NEG)

        u1 = xd - x0[:, d + 1] if d + 1 < D1 else no_diag
        u2 = xd + 1 - x0[:, d + 2] if d + 2 < D1 else no_diag
        wb1 = _window(b1, u1, W)   # [..., :W] gapY target, [..., 1:] gapX target
        wb2 = _window(b2, u2, W)   # [..., :W] match target, offset -m_prev

        gx_red = _legal_reduce(wb1[:, GAP_X, :, 1:] + gapx_valid, leg_t)
        mm_red = _legal_reduce(wb2[:, MATCH, :, :W] + e_match_to
                               - m_prev[:, None, None], leg_t)
        gy_term = wb1[:, GAP_Y, :, :W] + e_stay_same

        b_match = _lae(_lae(gx_red + t[:, T_MX], mm_red + t[:, T_MM]),
                       gy_term + t[:, T_MY])
        b_gapx = _lae(gx_red + t[:, T_XX], mm_red + t[:, T_XM])
        b_gapy = _lae(mm_red + t[:, T_YM], gy_term + t[:, T_YY])

        cur = torch.stack([b_match, b_gapx, b_gapy], dim=1)
        inband = (o < width[:, d, None]) & (d <= nd)[:, None]
        cur = torch.where(inband[:, None, None, :], cur, NEG)
        fin = nd == d
        bfin = torch.where(inband[:, None, None, :], end[:, :, None, None], NEG)
        cur = torch.where(fin[:, None, None, None], bfin, cur)
        m = torch.where(fin, 0.0, _diag_max(cur))
        cur = torch.clamp(cur - m[:, None, None, None], min=NEG)
        bstack[:, d] = cur if store_full else cur[:, MATCH]
        b_incr[:, d] = m
        b2, b1, m_prev = b1, cur, m
    return bstack, b_incr, _lse(cur, start)


# --------------------------------------------------------------------------
# plain PyTorch DP in probability space (P = 1, MODE_MEAN_ONLY)
# --------------------------------------------------------------------------

def _prob_emissions(refw, pexw, evw, cw, gapx):
    """Event-normalised match / stay probabilities and the gapX weight,
    (B, W) each, from (B, NREF, 1, W) reference, (B, 2, W) exp-constant,
    (B, NEV, W) event and (B, W) best-case windows: exp(c - z^2/2 -
    ev_best), the JAX ``_fwd_kernel`` ``:253-261``, in its order."""
    m_hat, inv_m, _, inv_y, _ = refw[:, :, 0].unbind(1)
    ev_mean = evw[:, 0]
    kvalid = inv_m > 0.0
    ok = kvalid & (evw[:, 1] > 0.5)
    am = (ev_mean - m_hat) * inv_m
    ay = (ev_mean - m_hat) * inv_y
    e_match = torch.where(ok, pexw[:, 0], 0.0) * torch.exp(-(0.5 * am * am + cw))
    e_stay = torch.where(ok, pexw[:, 1], 0.0) * torch.exp(-(0.5 * ay * ay + cw))
    return e_match, e_stay, torch.where(kvalid, gapx, 0.0)


def _prob_frames(lr):
    """The max-frame leapfrog's damping of diagonals d-1 and d-2 (forward;
    d+1 and d+2 backward) from lr = log(FRAME(d-1) / FRAME(d-2)): both
    exp(<= 0), (B, 1) each."""
    return (torch.exp(torch.clamp(lr, max=0.0))[:, None],
            torch.exp(-torch.clamp(lr, min=0.0))[:, None])


def _prob_rescale(cur, m):
    """cur (B, 3, W) rescaled so that its max m becomes SCALE, as 1/m then
    * SCALE (SCALE/m overflows f32 on a near-dead diagonal); with the
    normalised log match row (NEG where the probability is 0) and the
    log frame factor log(m) - LOG_SCALE."""
    cur = (cur * (1.0 / m)[:, None, None]) * SCALE
    row = torch.clamp(torch.log(cur[:, MATCH]) - LOG_SCALE, min=NEG)
    return cur, row, torch.log(m) - LOG_SCALE


def _prob_lse(cur, w):
    """log(sum of the (B, 3, W) diagonal weighted by the (B, 3) state
    probabilities) - LOG_SCALE, summed state by state as the JAX kernels."""
    s = ((cur[:, MATCH] * w[:, 0, None]).sum(dim=1)
         + (cur[:, GAP_X] * w[:, 1, None]).sum(dim=1)
         + (cur[:, GAP_Y] * w[:, 2, None]).sum(dim=1))
    return torch.log(s) - LOG_SCALE


def sweep_forward_prob(pt: ProblemTensors):
    """The probability-space forward sweep of a P = 1 Gaussian bucket:
    the JAX ``_fwd_kernel`` (``ops/banded_fb_pallas_batch.py:230-344``),
    one diagonal at a time. Values are f32 probabilities, each diagonal's
    max rescaled to SCALE, the step taken in the larger frame of d-1 and
    d-2 (both damped into it), emissions event-normalised by ev_best.

    Returns (fstack (B, D1, 1, W) = log(value) - LOG_SCALE of the match
    row, NEG where the value is 0; f_incr (B, D1) the frame increments
    lr(d), whose prefix sums are the log frames, 0 past n_diag; lse_f (B,)
    the end-weighted log-sum at each problem's n_diag): the contract of
    ``sweep_forward``, with totals short of ``ev_norm``. NaN propagates
    as in the JAX kernel (a tripped lane)."""
    B, D1 = pt.x0.shape
    W = pt.W
    dev = pt.device
    _, lY, nd, efp, reflen, evlen = _unpack(pt)[:6]
    pr = pt.prob
    t = pr.par[:, PACK_TRANS:PACK_TRANS + 9, None]
    start = pr.par[:, PACK_START:PACK_START + 3]
    end = pr.par[:, PACK_END:PACK_END + 3]
    gapx = pr.par[:, PACK_GAPX, None]
    x0 = pt.x0.long()
    width = pt.width.long()
    o = torch.arange(W, device=dev)
    no_diag = torch.full((B,), W + 5, dtype=torch.long, device=dev)

    fstack = torch.full((B, D1, 1, W), NEG, device=dev)
    f_incr = torch.zeros(B, D1, device=dev)
    lse_f = torch.zeros(B, device=dev)
    prev1 = prev2 = torch.zeros(B, 3, W, device=dev)
    lr = torch.zeros(B, device=dev)
    finals = set(pt.n_diag)
    for d in range(D1):
        if d == 0:
            # the start cell (0, 0), and nothing else
            cur = torch.zeros(B, 3, W, device=dev)
            cur[:, :, 0] = start * SCALE
        else:
            xd = x0[:, d]
            refw, _ = _cols(pt.ref, xd, reflen, W)
            pexw, _ = _cols(pr.cexp, xd, reflen, W)
            ecol = lY - d + xd + efp
            evw, _ = _cols(pt.ev, ecol, evlen, W)
            cw, _ = _cols(pr.ev_best, ecol, evlen, W)
            e_match, e_stay, e_gapx = _prob_emissions(refw, pexw, evw, cw,
                                                      gapx)
            w1, w2 = _prob_frames(lr)
            shift2 = xd - x0[:, d - 2] - 1 if d >= 2 else no_diag
            a = _window(prev1[:, :, None], xd - x0[:, d - 1] - 1, W, 0.0)[:, :, 0]
            c = _window(prev2[:, :, None], shift2, W, 0.0)[:, :, 0]
            gx = (a[:, MATCH, :W] * (t[:, T_MX] * w1)
                  + a[:, GAP_X, :W] * (t[:, T_XX] * w1)) * e_gapx
            mm = ((c[:, MATCH, :W] * t[:, T_MM] + c[:, GAP_X, :W] * t[:, T_XM]
                   + c[:, GAP_Y, :W] * t[:, T_YM]) * w2) * e_match
            gy = (a[:, MATCH, 1:] * (t[:, T_MY] * w1)
                  + a[:, GAP_Y, 1:] * (t[:, T_YY] * w1)) * e_stay
            inband = (o < width[:, d, None]) & (d <= nd)[:, None]
            cur = torch.where(inband[:, None], torch.stack([mm, gx, gy], 1),
                              0.0)
        mx = cur.amax(dim=(1, 2))
        cur, row, lm = _prob_rescale(cur, torch.where(mx > 0.0, mx, SCALE))
        lr = torch.clamp(-lr, min=0.0) + lm
        fstack[:, d, 0] = row
        f_incr[:, d] = torch.where(d <= nd, lr, 0.0)
        if d in finals:
            lse_f = torch.where(nd == d, _prob_lse(cur, end), lse_f)
        prev2, prev1 = prev1, cur
    return fstack, f_incr, lse_f


def sweep_backward_prob(pt: ProblemTensors):
    """The probability-space backward sweep of a P = 1 Gaussian bucket:
    the JAX ``_bwd_kernel`` (``ops/banded_fb_pallas_batch.py:444-553``),
    from each problem's n_diag (the end row: end * SCALE, frame factor 1)
    down to 0, with the leapfrog frames of d+1 and d+2.

    Returns (bstack (B, D1, 1, W) log match rows as in
    ``sweep_forward_prob``, b_incr (B, D1) frame increments (0 past
    n_diag; their suffix sums are the log frames), lse_b (B,) the
    start-weighted log-sum at d = 0); totals short of ``ev_norm``."""
    B, D1 = pt.x0.shape
    W = pt.W
    dev = pt.device
    _, lY, nd, efp, reflen, evlen = _unpack(pt)[:6]
    pr = pt.prob
    t = pr.par[:, PACK_TRANS:PACK_TRANS + 9, None]
    start = pr.par[:, PACK_START:PACK_START + 3]
    end = pr.par[:, PACK_END:PACK_END + 3]
    gapx = pr.par[:, PACK_GAPX, None]
    x0 = pt.x0.long()
    width = pt.width.long()
    o = torch.arange(W, device=dev)
    no_diag = torch.full((B,), W + 5, dtype=torch.long, device=dev)

    bstack = torch.full((B, D1, 1, W), NEG, device=dev)
    b_incr = torch.zeros(B, D1, device=dev)
    b1 = b2 = cur = torch.zeros(B, 3, W, device=dev)
    lr = torch.zeros(B, device=dev)
    for d in range(D1 - 1, -1, -1):
        xd = x0[:, d]
        # TO cells: match (x+1, y+1) and gapX (x+1, y) at x+1, gapY (x, y+1)
        # at x, the first two with event y+1
        refx1, _ = _cols(pt.ref, xd + 1, reflen, W)
        refx0, _ = _cols(pt.ref, xd, reflen, W)
        pex1, _ = _cols(pr.cexp, xd + 1, reflen, W)
        pex0, _ = _cols(pr.cexp, xd, reflen, W)
        ecol = lY - d + xd + efp - 1
        evy1, _ = _cols(pt.ev, ecol, evlen, W)
        cw, _ = _cols(pr.ev_best, ecol, evlen, W)
        e_match_to = _prob_emissions(refx1, pex1, evy1, cw, gapx)[0]
        e_stay_same = _prob_emissions(refx0, pex0, evy1, cw, gapx)[1]
        gapx_ok = torch.where(refx1[:, 1, 0] > 0.0, gapx, 0.0)
        u1 = xd - x0[:, d + 1] if d + 1 < D1 else no_diag
        u2 = xd + 1 - x0[:, d + 2] if d + 2 < D1 else no_diag
        a = _window(b1[:, :, None], u1, W, 0.0)[:, :, 0]
        c = _window(b2[:, :, None], u2, W, 0.0)[:, :, 0]
        w1, w2 = _prob_frames(lr)
        gx_red = (a[:, GAP_X, 1:] * w1) * gapx_ok
        mm_red = (c[:, MATCH, :W] * w2) * e_match_to
        gy_term = (a[:, GAP_Y, :W] * w1) * e_stay_same
        cur = torch.stack([
            gx_red * t[:, T_MX] + mm_red * t[:, T_MM] + gy_term * t[:, T_MY],
            gx_red * t[:, T_XX] + mm_red * t[:, T_XM],
            mm_red * t[:, T_YM] + gy_term * t[:, T_YY]], dim=1)
        fin = nd == d
        cur = torch.where(fin[:, None, None], end[:, :, None] * SCALE, cur)
        inband = (o < width[:, d, None]) & (d <= nd)[:, None]
        cur = torch.where(inband[:, None], cur, 0.0)
        mx = cur.amax(dim=(1, 2))
        cur, row, lm = _prob_rescale(
            cur, torch.where(fin, SCALE, torch.where(mx > 0.0, mx, SCALE)))
        # a problem's sweep starts at its n_diag with lr = 0
        lr = torch.where(d <= nd, torch.clamp(-lr, min=0.0) + lm, 0.0)
        bstack[:, d, 0] = row
        b_incr[:, d] = lr
        b2, b1 = b1, cur
    return bstack, b_incr, _prob_lse(cur, start)


def forward_offsets(f_incr, lse_f, n_diag):
    """Float64 prefix offsets Fo (B, D1) and total_f (B,)."""
    fo = torch.cumsum(f_incr, dim=1, dtype=torch.float64)
    total_f = lse_f.double() + fo.gather(1, n_diag.long()[:, None])[:, 0]
    return fo, total_f


def backward_offsets(b_incr, lse_b):
    """Float64 suffix offsets Bo (B, D1) and total_b (B,)."""
    bo = torch.cumsum(b_incr.flip(1), dim=1, dtype=torch.float64).flip(1)
    return bo, lse_b.double() + bo[:, 0]


def cell_mask(pt: ProblemTensors):
    """(B, D1, 1, W) cells that may report a pair: in band, 1 <= x <= lX,
    1 <= y <= lY and d <= n_diag (broadcast over paths)."""
    B, D1 = pt.x0.shape
    dev = pt.device
    meta = pt.meta.long()
    d = torch.arange(D1, device=dev)[None, :, None]
    o = torch.arange(pt.W, device=dev)[None, None, :]
    x = pt.x0.long()[:, :, None] + o
    y = d - x
    return ((o < pt.width.long()[:, :, None]) & (x > 0) & (y > 0)
            & (x <= meta[:, M_LX, None, None]) & (y <= meta[:, M_LY, None, None])
            & (d <= meta[:, M_NDIAG, None, None]))[:, :, None, :]


def posterior(fstack, bstack, cvec, pt: ProblemTensors):
    """Posterior match probabilities (B, D1, P, W) from normalised stacks
    and cvec[d] = Fo[d] + Bo[d] - total (float32)."""
    logp = fstack + bstack + cvec[:, :, None, None]
    post = torch.exp(torch.clamp(logp, min=NEG))
    post = torch.where(cell_mask(pt), post, 0.0)
    return torch.clamp(post, max=1.0)


# --------------------------------------------------------------------------
# EM expectations (any P)
# --------------------------------------------------------------------------

# the seven live transitions (from state, to state), in the order of the
# backward kernel's texp rows (the JAX ``execute_expect`` ``rows``)
TEXP_ROWS = ((MATCH, GAP_X), (GAP_X, GAP_X), (MATCH, MATCH), (GAP_X, MATCH),
             (GAP_Y, MATCH), (MATCH, GAP_Y), (GAP_Y, GAP_Y))


def expect_cvecs(cvecf, bo):
    """The expectation normalisers from cvecf = Fo(d) - total and Bo, (B,
    D1) float64 each: cvec_d1[d] = Fo(d-1) + Bo(d) - total and cvec_d2[d]
    = Fo(d-2) + Bo(d) - total, with Fo(-1) = Fo(-2) = 0 as the JAX host
    builds them; Fo(0) = 0, so cvecf[:, 0] = -total stands for those."""
    c0 = cvecf[:, :1]
    return (torch.cat([c0, cvecf[:, :-1]], dim=1) + bo,
            torch.cat([c0, c0, cvecf[:, :-2]], dim=1) + bo)


def texp_matrix(texp7):
    """(B, 7) texp rows -> (B, 3, 3) [from state, to state]."""
    out = texp7.new_zeros(texp7.shape[0], 3, 3)
    for r, (a, b) in enumerate(TEXP_ROWS):
        out[:, a, b] = texp7[:, r]
    return out


def kexp_by_kmer(kx, kid, K: int):
    """Per-kmer emission moments (B, 3, K) float64 from the moments ``kx``
    (B, 3, *S) of the expectation pass at each cell of S (a (P, LX)
    (path, position) grid, or (LX,)), keyed by that cell's k-mer id ``kid``
    (B, *S): a float64 ``index_add_`` on kx's device. The counterpart of
    the XLA ``_kexp_reduce_banked`` (``ops/banded_fb_pallas_batch.py:2116``)
    and of the XLA core's ``kexp.at[r, kw].add``; cells the pass never
    reached hold zeros."""
    B = kx.shape[0]
    kx = kx.reshape(B, 3, -1)
    key = (torch.arange(B * 3, device=kx.device)[:, None] * K
           + kid.reshape(B, -1).long().repeat_interleave(3, dim=0)).reshape(-1)
    out = torch.zeros(B * 3 * K, dtype=torch.float64, device=kx.device)
    out.index_add_(0, key, kx.reshape(-1).double())
    return out.view(B, 3, K)


def expectation_sums(pt: ProblemTensors, fstack, bstack, cvec_d1, cvec_d2,
                     moments: bool = True):
    """Transition posteriors and per-(path, position) Gaussian moments of
    a bucket of P paths, accumulated over TO diagonals d = 1..D1-1 as the
    JAX ``_expectations_core`` (``ops/banded_fb.py:642-753``) does, term
    for term.

    ``fstack`` / ``bstack`` are the three-state stacks (B, D1, 3, P, W)
    (``store_full``); ``cvec_d1[d]`` = Fo(d-1) + Bo(d) - total and
    ``cvec_d2[d]`` = Fo(d-2) + Bo(d) - total (cast to float32 here, as the
    JAX host casts them). A transition from source path q to target path
    p counts where its TO cell is in the band, d <= n_diag and legal[p,
    q] holds at the TO position (``pair_post``); the two gapY transitions
    stay on their path and need the band alone (``val_my`` / ``val_yy``);
    end-state transitions do not count.

    Returns (texp (B, 7) float64 in ``TEXP_ROWS`` order, kx (B, 3, P, LX)
    float64 [Σp, Σp·dx, Σp·dx²] of the into-match posteriors of each TO
    (path, position), summed over their legal source paths, dx = (event
    mean − m̂)/var, zero where inv_m <= 0; all zero unless ``moments``).
    Per-cell terms are float32 in the JAX order (src + e_to + t + b + c);
    sums are float64. The JAX ``match_tp`` (per-cell into-match
    posteriors) has no reader on the EM path and is not computed.
    """
    B, D1 = pt.x0.shape
    W, P = pt.W, pt.P
    dev = pt.device
    lX, lY, nd, efp, reflen, evlen, t, start, end, gapx = _unpack(pt)
    x0 = pt.x0.long()
    width = pt.width.long()
    o = torch.arange(W, device=dev)
    no_diag = torch.full((B,), W + 5, dtype=torch.long, device=dev)
    c1s, c2s = cvec_d1.float(), cvec_d2.float()
    var = pt.par[:, PACK_VAR, None, None]
    texp = torch.zeros(B, 7, dtype=torch.float64, device=dev)
    kx = torch.zeros(B, 3, P, pt.ref.shape[-1], dtype=torch.float64,
                     device=dev)
    legT = pt.leg.transpose(1, 2).contiguous()
    for d in range(1, D1):
        xd = x0[:, d]
        refw, idx = _cols(pt.ref, xd, reflen, W)
        legw = _legal(legT, xd, reflen, W, P)           # (B, P_to, Q_from, W)
        evw, _ = _cols(pt.ev, lY - d + xd + efp, evlen, W)
        e_match, e_stay, e_gapx = _emissions(refw, evw, gapx,
                                             _hdp_window(pt, xd, reflen))
        shift1 = xd - x0[:, d - 1] - 1
        shift2 = xd - x0[:, d - 2] - 1 if d >= 2 else no_diag
        f1 = _window(fstack[:, d - 1], shift1, W)       # (B, 3, P, W+1)
        f2 = _window(fstack[:, max(d - 2, 0)], shift2, W)
        bcur = bstack[:, d]
        c1 = c1s[:, d, None, None]
        c2 = c2s[:, d, None, None]
        inband = ((o < width[:, d, None]) & (d <= nd)[:, None])[:, None, :]
        ok = legw & inband[:, :, None, :]

        def pair(src, e_to, t_log, b_state, c):
            # (B, P_to, Q_from, W): source path q's state into target p
            val = (src[:, None] + e_to[:, :, None] + t_log[:, :, :, None]
                   + bcur[:, b_state][:, :, None] + c[:, :, :, None])
            return torch.exp(torch.clamp(torch.where(ok, val, NEG), min=NEG))

        def stay(src, t_log):
            val = src + e_stay + t_log + bcur[:, GAP_Y] + c1
            return torch.exp(torch.clamp(torch.where(inband, val, NEG),
                                         min=NEG))

        p_mx = pair(f1[:, MATCH, :, :W], e_gapx, t[:, T_MX], GAP_X, c1)
        p_xx = pair(f1[:, GAP_X, :, :W], e_gapx, t[:, T_XX], GAP_X, c1)
        p_mm = pair(f2[:, MATCH, :, :W], e_match, t[:, T_MM], MATCH, c2)
        p_xm = pair(f2[:, GAP_X, :, :W], e_match, t[:, T_XM], MATCH, c2)
        p_ym = pair(f2[:, GAP_Y, :, :W], e_match, t[:, T_YM], MATCH, c2)
        p_my = stay(f1[:, MATCH, :, 1:], t[:, T_MY])
        p_yy = stay(f1[:, GAP_Y, :, 1:], t[:, T_YY])
        texp += torch.stack([p.double().flatten(1).sum(dim=1) for p in (
            p_mx, p_xx, p_mm, p_xm, p_ym, p_my, p_yy)], dim=1)
        if moments:
            mtp = (p_mm + p_xm + p_ym).sum(dim=2)       # (B, P, W)
            # divide by a tensor: PyTorch's CUDA division by a Python
            # number multiplies by its reciprocal (see hdp_spline_density)
            dx = (evw[:, 0, None] - refw[:, 0]) / var
            dx = torch.where(refw[:, 1] > 0.0, dx, 0.0)
            at = idx[:, None, :].expand(-1, P, -1)
            for r, v in enumerate((mtp, mtp * dx, mtp * dx * dx)):
                kx[:, r].scatter_add_(2, at, v.double())
    return texp, kx


def expectations(pt: ProblemTensors, fstack, bstack, cvec_d1, cvec_d2,
                 num_kmers: int):
    """The JAX ``_expectations_core`` of a bucket: texp (B, 3, 3) [from,
    to] and kexp (B, 3, num_kmers) [Σp, Σp·dx, Σp·dx²] by k-mer, both
    float64 (``expectation_sums``, then ``kexp_by_kmer`` over ``pt.kid``,
    each (path, position) keyed by its k-mer). ``num_kmers`` = 0 skips the
    moments and returns kexp zeros (B, 3, 1), as the JAX core does.
    Emission modes are treated alike, as in the XLA core: the port's EM
    path asks for no moments in MODE_HDP (see
    ``ops.batch.run_banded_fb_batch``)."""
    texp7, kx = expectation_sums(pt, fstack, bstack, cvec_d1, cvec_d2,
                                 moments=num_kmers > 0)
    if num_kmers > 0:
        if pt.kid is None:
            raise ValueError("kexp needs the k-mer ids: problem_tensors(..., "
                             "kmer_ids=True)")
        kexp = kexp_by_kmer(kx, pt.kid, num_kmers)
    else:
        kexp = torch.zeros(pt.x0.shape[0], 3, 1, dtype=torch.float64,
                           device=pt.device)
    return texp_matrix(texp7), kexp


def run_banded_fb(problem: BandedProblem, W: int, P: int,
                  with_expectations: bool = False, *,
                  device: torch.device) -> Dict:
    """Sweeps, float64 offsets and the posterior for one problem on
    ``device``.

    Returns {"post": (Dpad+1, P, W) numpy, "total_f", "total_b"} like the
    JAX ``run_banded_fb``, and with ``with_expectations`` "texp" and
    "kexp" (``ops.batch.run_banded_fb_batch``).
    """
    from signalalign_tpu_torch.ops.batch import run_banded_fb_batch
    return run_banded_fb_batch([problem], W, P, with_expectations,
                               device=device)[0]
