"""Carry the JAX package's state into the port, and stack problems into
device tensors.

The JAX package's host objects hold numpy arrays, so
``pore_model_from_numpy`` and ``problem_from_numpy`` copy them field for
field into the port's own classes (the port imports nothing of the JAX
package, so it takes any object with the same fields);
``problem_tensors`` stacks problems into the padded tensors the kernels
and their plain twins read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from signalalign_tpu_torch.models.hdp_model import NanoporeHDP
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.utils.alphabet import Alphabet


def pore_model_from_numpy(src) -> PoreModel:
    """The port's PoreModel from any object with the same fields (a JAX
    ``signalalign_tpu.models.pore_model.PoreModel``); arrays are copied."""
    model = PoreModel(src.alphabet.letters, src.kmer_length,
                      likelihood=src.likelihood)
    for name in ("transitions", "log_transitions", "level_mean", "level_sd",
                 "noise_mean", "noise_sd", "noise_lambda"):
        setattr(model, name, np.array(getattr(src, name)))
    return model


def hdp_from_numpy(src) -> NanoporeHDP:
    """The port's NanoporeHDP from any object with the same fields (a JAX
    ``signalalign_tpu.models.hdp_model.NanoporeHDP``); arrays are copied."""

    def cp(v):
        if isinstance(v, list):
            return [None if a is None else np.array(a) for a in v]
        return None if v is None else np.array(v)

    return NanoporeHDP(
        alphabet=Alphabet(src.alphabet.letters, src.alphabet.kmer_length),
        grid=np.array(src.grid), densities=np.array(src.densities),
        slopes=np.array(src.slopes), observed=np.array(src.observed),
        num_dps=int(src.num_dps), dp_densities=cp(src.dp_densities),
        dp_slopes=cp(src.dp_slopes), dp_parent=cp(src.dp_parent))


def hdp_tables(dens: np.ndarray, slopes: np.ndarray, g0: float, dx: float,
               device: torch.device) -> bfb.HdpTables:
    """Upload an HDP's (K, NG) float32 density and slope tables
    (``NanoporeHDP.density_arrays()``, or a problem's ``hdp_dens``,
    ``hdp_slopes`` and ``hdp_grid``) to ``device``, one copy each, to be
    shared by every bucket of a run; g0 and dx are rounded to float32 and
    the last knot is g0 + (NG - 1) * dx in float32, as the JAX package
    computes it."""
    if dens.shape != slopes.shape or dens.ndim != 2 or dens.shape[1] < 2:
        raise ValueError(f"HDP tables of shapes {dens.shape}, {slopes.shape}")
    g0_, dx_ = np.float32(g0), np.float32(dx)
    gN = g0_ + np.float32(dens.shape[1] - 1) * dx_
    return bfb.HdpTables(
        dens=torch.from_numpy(np.ascontiguousarray(dens, np.float32)).to(device),
        slopes=torch.from_numpy(
            np.ascontiguousarray(slopes, np.float32)).to(device),
        g0=float(g0_), dx=float(dx_), gN=float(gN))


def problem_from_numpy(src) -> bfb.BandedProblem:
    """The port's BandedProblem from any object with the same fields (a
    JAX ``signalalign_tpu.ops.banded_fb.BandedProblem``); arrays are
    copied, so the two never share memory."""
    kw = {}
    for f in dataclasses.fields(bfb.BandedProblem):
        if not hasattr(src, f.name):
            continue            # norm_source: the JAX problem forms ev_best
        v = getattr(src, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return bfb.BandedProblem(**kw)


def _check_slice(p: bfb.BandedProblem) -> None:
    if p.mode not in (bfb.MODE_MEAN_ONLY, bfb.MODE_HDP):
        raise NotImplementedError(
            f"emission mode {p.mode}: the port runs MODE_MEAN_ONLY and "
            "MODE_HDP (ROADMAP §3 item 4)")


def _pack_words(bits: np.ndarray) -> np.ndarray:
    """(..., P) bool -> (..., NW) uint32: bit q % 32 of word q // 32."""
    P = bits.shape[-1]
    NW = bfb.leg_words(P)
    pad = np.zeros(bits.shape[:-1] + (NW * 32,), np.uint32)
    pad[..., :P] = bits
    pad = pad.reshape(bits.shape[:-1] + (NW, 32))
    return (pad << np.arange(32, dtype=np.uint32)).sum(axis=-1,
                                                       dtype=np.uint32)


def legality_bits(legal: np.ndarray) -> np.ndarray:
    """(P, P, LX) bool ``legal[p_to, q_from, x]`` -> (LX, P * NW) int32
    masks, NW = ``bfb.leg_words(P)`` words per (position, target path):
    bit q_from % 32 of ``[x, p_to * NW + q_from // 32]`` is set where the
    transition is legal (one word, bit q_from, at P <= 32)."""
    P, _, LX = legal.shape
    masks = _pack_words(legal.transpose(2, 0, 1))      # (LX, P, NW)
    return np.ascontiguousarray(masks.reshape(LX, -1)).view(np.int32)


def masks_by_source(leg: torch.Tensor, P: int) -> torch.Tensor:
    """(..., P * NW) int32 masks of P paths by target path
    (``legality_bits``' layout) -> the same masks by source path, on
    ``leg``'s device: bit p % 32 of word p // 32 of source path q is bit q
    % 32 of word q // 32 of target path p (the backward kernel's reads:
    the legal targets of a source path)."""
    if P == 1:
        return leg
    NW = bfb.leg_words(P)
    shape = leg.shape[:-1]
    q = torch.arange(P, device=leg.device)
    words = leg.reshape(*shape, P, NW).to(torch.int64)[..., q // 32]
    bits = (words >> (q % 32)) & 1                     # [..., p, q]
    pad = torch.zeros(*shape, P, NW * 32, dtype=torch.int64,
                      device=leg.device)
    pad[..., :P] = bits.transpose(-1, -2)              # [..., q, p]
    w = (pad.reshape(*shape, P, NW, 32)
         << torch.arange(32, device=leg.device)).sum(-1)
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    return w.reshape(*shape, P * NW)


def problem_tensors(problems: Sequence[bfb.BandedProblem], W: int,
                    device: torch.device,
                    hdp: Optional[bfb.HdpTables] = None,
                    kmer_ids: bool = False,
                    prob: bool = False) -> bfb.ProblemTensors:
    """Stack one bucket's problems (the bucket's P is their largest path
    count) into padded tensors on ``device`` (one host-to-device copy
    per tensor). A MODE_HDP bucket also gets per-(problem, path, position)
    k-mer ids and level means, and needs ``hdp``: the run's tables on
    ``device``, uploaded once (``hdp_tables``) and shared, not copied.
    ``kmer_ids`` gives a Gaussian bucket the k-mer ids too (the keys of
    the EM emission moments). ``prob`` adds what the probability-space
    sweeps read (``bfb.ProbTensors``; P = 1 Gaussian buckets of W <=
    ``bfb.PROB_MAX_W`` only), leaving the other tensors as they are.
    Mixed-mode buckets raise."""
    if not problems:
        raise ValueError("empty bucket")
    modes = {p.mode for p in problems}
    if len(modes) > 1:
        raise ValueError(f"bucket mixes emission modes {sorted(modes)}")
    hdp_mode = problems[0].mode == bfb.MODE_HDP
    if hdp_mode:
        if hdp is None:
            raise ValueError("a MODE_HDP bucket needs the HDP tables (hdp=)")
    elif hdp is not None:
        raise ValueError("HDP tables given for a MODE_MEAN_ONLY bucket")
    P = max(p.ref_params.shape[1] for p in problems)
    if prob:
        bfb.check_prob(W, P, hdp_mode)
    for p in problems:
        _check_slice(p)
        if hdp_mode and (p.hdp_dens.shape != tuple(hdp.dens.shape)
                         or np.float32(p.hdp_grid[0]) != np.float32(hdp.g0)
                         or np.float32(p.hdp_grid[1]) != np.float32(hdp.dx)):
            raise ValueError("a problem was prepared with other HDP tables")
        if int(p.width.max()) > W:
            raise ValueError(f"band width {int(p.width.max())} exceeds W={W}")
        # the W-wide windows of the sweeps must fit in the problem's tables
        if min(p.ref_params.shape[-1], p.ev_params.shape[-1]) < W:
            raise ValueError(f"problem tables shorter than W={W}: prepare "
                             "it with the bucket's W")
    B = len(problems)
    D1 = max(p.n_diag for p in problems) + 1
    LX = max(p.ref_params.shape[-1] for p in problems)
    LE = max(p.ev_params.shape[-1] for p in problems)
    x0 = np.zeros((B, D1), np.int32)
    width = np.zeros((B, D1), np.int32)
    ref = np.zeros((B, bfb.NREF, P, LX), np.float32)
    NW = bfb.leg_words(P)
    leg = np.zeros((B, LX, P * NW), np.int32)
    ev = np.zeros((B, bfb.NEV, LE), np.float32)
    meta = np.zeros((B, bfb.NMETA), np.int32)
    par = np.zeros((B, bfb.NPACK), np.float32)
    with_kid = hdp_mode or kmer_ids
    kid = np.zeros((B, P, LX), np.int32) if with_kid else None
    mu = np.zeros((B, P, LX), np.float32) if hdp_mode else None
    for i, p in enumerate(problems):
        n = min(D1, p.x0.shape[0])
        x0[i, :n] = p.x0[:n]
        x0[i, n:] = p.x0[n - 1]
        width[i, :n] = p.width[:n]
        lx = p.ref_params.shape[-1]
        le = p.ev_params.shape[-1]
        ref[i, :, :p.ref_params.shape[1], :lx] = p.ref_params[:bfb.NREF]
        legal = p.legal
        if legal.shape[0] < P:   # its words at the bucket's stride
            legal = np.zeros((P, P, lx), bool)
            legal[:p.legal.shape[0], :p.legal.shape[0]] = p.legal
        leg[i, :lx] = legality_bits(legal)
        ev[i, 0, :le] = p.ev_params[0]
        ev[i, 1, :le] = p.ev_params[3]
        meta[i, [bfb.M_LX, bfb.M_LY, bfb.M_NDIAG, bfb.M_EVPAD, bfb.M_REFLEN,
                 bfb.M_EVLEN]] = [p.lX, p.lY, p.n_diag, p.ev_front_pad, lx, le]
        par[i, bfb.PACK_TRANS:bfb.PACK_TRANS + 9] = p.log_trans
        par[i, bfb.PACK_START:bfb.PACK_START + 3] = p.start_logs
        par[i, bfb.PACK_END:bfb.PACK_END + 3] = p.end_logs
        par[i, bfb.PACK_GAPX] = bfb.LOG_GAPX_EMISSION
        par[i, bfb.PACK_VAR] = p.var
        if with_kid:
            kid[i, :p.kmer_ids.shape[0], :lx] = p.kmer_ids
        if hdp_mode:
            mu[i, :p.ref_params.shape[1], :lx] = p.ref_params[7]

    def dev(a):
        return torch.from_numpy(a).to(device)

    x0 = dev(x0)
    leg = dev(leg)
    pt_prob = _prob_tensors(problems, ref, LE, dev) if prob else None
    if hdp_mode and hdp.dens.device != x0.device:
        raise ValueError(f"HDP tables on {hdp.dens.device}, bucket on "
                         f"{x0.device}")
    return bfb.ProblemTensors(
        W=W, P=P, n_diag=[p.n_diag for p in problems], x0=x0,
        width=dev(width), ref=dev(ref), leg=leg,
        leg_src=(masks_by_source(leg, P) if leg.device.type == "cuda"
                 else None),
        ev=dev(ev), meta=dev(meta), par=dev(par),
        kid=dev(kid) if with_kid else None, mu=dev(mu) if hdp_mode else None,
        hdp=hdp, prob=pt_prob)


def _prob_tensors(problems, ref: np.ndarray, LE: int, dev) -> bfb.ProbTensors:
    """``bfb.ProbTensors`` of a P = 1 Gaussian bucket whose ``ref`` rows
    are stacked: exp(c_m) and exp(c_y) taken in float32 as the JAX
    aligner takes them (``banded_fb_pallas_batch.py:2296-2300``), the
    best-case event row, the ``_pack16`` pack and the normaliser."""
    ev_best = np.zeros((len(problems), LE), np.float32)
    for i, p in enumerate(problems):
        ev_best[i, :p.ev_best.shape[0]] = bfb.event_normaliser(p).ev_best
    return bfb.ProbTensors(
        cexp=dev(np.ascontiguousarray(np.exp(ref[:, [2, 4], 0]))),
        ev_best=dev(ev_best),
        par=dev(np.stack([bfb.prob_pack(p) for p in problems])),
        ev_norm=dev(np.array([p.ev_norm_total for p in problems],
                             np.float64)))
