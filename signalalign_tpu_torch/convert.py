"""Carry the JAX package's state into the port.

The pore model is the shared numpy ``PoreModel`` and needs no
conversion. A JAX ``BandedProblem`` holds numpy arrays, so
``problem_from_numpy`` copies it field for field into the port's
``BandedProblem``; ``problem_tensors`` stacks problems into the padded
tensors the kernels and their plain twins read.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from signalalign_tpu_torch.ops import banded_fb as bfb


def problem_from_numpy(src) -> bfb.BandedProblem:
    """The port's BandedProblem from any object with the same fields (a
    JAX ``signalalign_tpu.ops.banded_fb.BandedProblem``); arrays are
    copied, so the two never share memory."""
    kw = {}
    for f in dataclasses.fields(bfb.BandedProblem):
        v = getattr(src, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return bfb.BandedProblem(**kw)


def _check_slice(p: bfb.BandedProblem) -> None:
    if p.mode != bfb.MODE_MEAN_ONLY:
        raise NotImplementedError(
            f"emission mode {p.mode}: the port runs MODE_MEAN_ONLY; HDP "
            "emissions come with ROADMAP slice 2b")
    P = p.ref_params.shape[1]
    if P > bfb.MAX_P:
        raise NotImplementedError(
            f"P={P} paths per cell: the port runs P <= {bfb.MAX_P} "
            "(ambiguity codes of three or more bases can exceed it)")


def legality_bits(legal: np.ndarray) -> np.ndarray:
    """(P, P, LX) bool ``legal[p_to, q_from, x]`` -> (LX,) int64 with bit
    p_to*MAX_P + q_from set where the transition is legal."""
    P = legal.shape[0]
    bit = (np.arange(P)[:, None] * bfb.MAX_P + np.arange(P)[None, :])
    words = (legal.astype(np.uint64) << bit[:, :, None].astype(np.uint64))
    return words.sum(axis=(0, 1), dtype=np.uint64).view(np.int64)


def problem_tensors(problems: Sequence[bfb.BandedProblem], W: int,
                    device: torch.device) -> bfb.ProblemTensors:
    """Stack one bucket's mean-only problems (P <= 8 paths, the bucket's
    P is their largest) into padded tensors on ``device`` (one
    host-to-device copy per tensor)."""
    if not problems:
        raise ValueError("empty bucket")
    for p in problems:
        _check_slice(p)
        if int(p.width.max()) > W:
            raise ValueError(f"band width {int(p.width.max())} exceeds W={W}")
        # the W-wide windows of the sweeps must fit in the problem's tables
        if min(p.ref_params.shape[-1], p.ev_params.shape[-1]) < W:
            raise ValueError(f"problem tables shorter than W={W}: prepare "
                             "it with the bucket's W")
    B = len(problems)
    P = max(p.ref_params.shape[1] for p in problems)
    D1 = max(p.n_diag for p in problems) + 1
    LX = max(p.ref_params.shape[-1] for p in problems)
    LE = max(p.ev_params.shape[-1] for p in problems)
    x0 = np.zeros((B, D1), np.int32)
    width = np.zeros((B, D1), np.int32)
    ref = np.zeros((B, bfb.NREF, P, LX), np.float32)
    leg = np.zeros((B, LX), np.int64)
    ev = np.zeros((B, bfb.NEV, LE), np.float32)
    meta = np.zeros((B, bfb.NMETA), np.int32)
    par = np.zeros((B, bfb.NPACK), np.float32)
    for i, p in enumerate(problems):
        n = min(D1, p.x0.shape[0])
        x0[i, :n] = p.x0[:n]
        x0[i, n:] = p.x0[n - 1]
        width[i, :n] = p.width[:n]
        lx = p.ref_params.shape[-1]
        le = p.ev_params.shape[-1]
        ref[i, :, :p.ref_params.shape[1], :lx] = p.ref_params[:bfb.NREF]
        leg[i, :lx] = legality_bits(p.legal)
        ev[i, 0, :le] = p.ev_params[0]
        ev[i, 1, :le] = p.ev_params[3]
        meta[i, [bfb.M_LX, bfb.M_LY, bfb.M_NDIAG, bfb.M_EVPAD, bfb.M_REFLEN,
                 bfb.M_EVLEN]] = [p.lX, p.lY, p.n_diag, p.ev_front_pad, lx, le]
        par[i, bfb.PACK_TRANS:bfb.PACK_TRANS + 9] = p.log_trans
        par[i, bfb.PACK_START:bfb.PACK_START + 3] = p.start_logs
        par[i, bfb.PACK_END:bfb.PACK_END + 3] = p.end_logs
        par[i, bfb.PACK_GAPX] = bfb.LOG_GAPX_EMISSION

    def dev(a):
        return torch.from_numpy(a).to(device)

    return bfb.ProblemTensors(
        W=W, P=P, n_diag=[p.n_diag for p in problems], x0=dev(x0),
        width=dev(width), ref=dev(ref), leg=dev(leg), ev=dev(ev),
        meta=dev(meta), par=dev(par))
