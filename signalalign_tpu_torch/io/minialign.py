"""Dependency-free guide-alignment generation (bwa mem stand-in).

reference: utils/bwaWrapper.py generateGuideAlignment — the upstream shells
out to `bwa mem` to map the nucleotide read and converts the record to an
exonerate-style guide alignment. Here a native Smith-Waterman with affine
gaps (csrc sa_sw_align) aligns the read against each contig in both
orientations and the best local hit becomes the GuideAlignment. Intended
for the reference's test-scale use case (plasmid/amplicon references, 2D
reads without BAMs); contigs above SEEDED_MIN_REF map through the native
minimizer index instead. The port's copy of ``signalalign_tpu.io.minialign``,
without its Python Smith-Waterman fallback: the native library's build
raises where it fails.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from signalalign_tpu_torch.io.guide import GuideAlignment
from signalalign_tpu_torch.utils import native
from signalalign_tpu_torch.utils.alphabet import reverse_complement

_OP_CHARS = "MID"


def _sw(query: str, ref: str) -> Optional[Tuple[float, int, int, int, int,
                                                List[Tuple[int, str]]]]:
    lib = native.load()
    max_ops = 4 * (len(query) + len(ref)) + 16
    ops = np.zeros(max_ops, dtype=np.int32)
    lens = np.zeros(max_ops, dtype=np.int64)
    qs = ctypes.c_long()
    qe = ctypes.c_long()
    rs = ctypes.c_long()
    re_ = ctypes.c_long()
    nops = ctypes.c_long()
    score = ctypes.c_double()
    rc = lib.sa_sw_align(
        query.encode(), ctypes.c_long(len(query)),
        ref.encode(), ctypes.c_long(len(ref)),
        ctypes.c_double(2.0), ctypes.c_double(-3.0),
        ctypes.c_double(-5.0), ctypes.c_double(-2.0),
        ctypes.byref(qs), ctypes.byref(qe), ctypes.byref(rs),
        ctypes.byref(re_),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.c_long(max_ops), ctypes.byref(nops), ctypes.byref(score))
    if rc != 0:
        return None
    cigar = [(int(lens[i]), _OP_CHARS[int(ops[i])])
             for i in range(nops.value)]
    return (score.value, qs.value, qe.value, rs.value, re_.value, cigar)


# references larger than this use the seeded (minimizer index + chain +
# banded extension) path: the full-DP SW is O(lq*lr) time AND memory —
# fine for plasmid/amplicon test references, hopeless against a genome
SEEDED_MIN_REF = 100_000


def _minidx(reference, name: str, k: int = 15, w: int = 10):
    """Lazily build + cache a native minimizer index for one contig.
    The handle is cached on the reference object and never freed
    (``sa_minidx_free`` is not called): it lives as long as the process,
    as the JAX package's does, since references are long-lived."""
    lib = native.load()
    cache = reference.__dict__.setdefault("_minidx_cache", {})
    key = (name, k, w)
    if key not in cache:
        seq = reference.forward[name].encode()
        cache[key] = lib.sa_minidx_build(seq, len(seq), k, w) or None
    return cache[key]


def _seeded_hit(read_seq: str, reference, name: str):
    """Seeded map + banded extension against one (large) contig.

    Returns a hit in generate_guide_alignment's ``best``-tuple frame:
    (score, name, is_fwd, qs, qe, rs, re, cigar, lref) with rs/re on the
    strand-oriented full reference (fwd, or revcomp for rc hits) —
    exactly the coordinates the full-DP path produces.

    reference: impl/pairwiseAligner.c:1660-1703 (getBlastPairs: lastz
    seed-and-extend anchors) / utils/bwaWrapper.py (indexed bwa mem).
    """
    lib = native.load()
    idx = _minidx(reference, name)
    if idx is None:
        return None
    fwd = reference.forward[name]
    lref = len(fwd)
    lq = len(read_seq)
    qrc = reverse_complement(read_seq)
    rs = ctypes.c_long()
    re_ = ctypes.c_long()
    qs = ctypes.c_long()
    qe = ctypes.c_long()
    strand = ctypes.c_int()
    score = ctypes.c_double()
    band = ctypes.c_long()
    score2 = ctypes.c_double()
    n = lib.sa_minidx_map(
        ctypes.c_void_p(idx), read_seq.encode(), qrc.encode(),
        ctypes.c_long(lq), ctypes.c_long(500),
        ctypes.byref(rs), ctypes.byref(re_), ctypes.byref(qs),
        ctypes.byref(qe), ctypes.byref(strand), ctypes.byref(score),
        ctypes.byref(band), ctypes.byref(score2))
    if n == 0 or (qe.value - qs.value) < 50:
        return None
    # bwa-style mapping confidence from best/second-chain separation:
    # a repeat copy elsewhere chaining within ~10% of best => MAPQ~0
    # (utils/bwaWrapper.py maps inherit bwa's MAPQ; same signal here)
    ratio = score2.value / max(score.value, 1e-9)
    mapq = 0 if ratio >= 0.9 else min(60, int(60.0 * (1.0 - ratio)))
    is_fwd = strand.value == 0
    # forward-strand reference window covering the chain + unaligned
    # read tails (which sit right of the window for rc maps)
    head, tail = qs.value, lq - qe.value
    margin = 200
    if is_fwd:
        ws = rs.value - head - margin
        we = re_.value + tail + margin
    else:
        ws = rs.value - tail - margin
        we = re_.value + head + margin
    ws = max(0, ws)
    we = min(lref, we)
    window = fwd[ws:we]
    lwin = we - ws
    target = window if is_fwd else reverse_complement(window)
    # expected corridor diagonals (segment frame j - query frame i)
    if is_fwd:
        c1 = (rs.value - ws) - qs.value
        c2 = (re_.value - ws) - qe.value
    else:
        c1 = (we - re_.value) - qs.value
        c2 = (we - rs.value) - qe.value
    pad = band.value + 300
    diag_lo = min(c1, c2) - pad
    diag_hi = max(c1, c2) + pad
    max_ops = 4 * (lq + lwin) + 16
    ops = np.zeros(max_ops, dtype=np.int32)
    lens = np.zeros(max_ops, dtype=np.int64)
    oqs = ctypes.c_long()
    oqe = ctypes.c_long()
    ors = ctypes.c_long()
    ore = ctypes.c_long()
    nops = ctypes.c_long()
    sw_score = ctypes.c_double()
    rc = lib.sa_sw_align_banded(
        read_seq.encode(), ctypes.c_long(lq),
        target.encode(), ctypes.c_long(lwin),
        ctypes.c_long(diag_lo), ctypes.c_long(diag_hi),
        ctypes.c_double(2.0), ctypes.c_double(-3.0),
        ctypes.c_double(-5.0), ctypes.c_double(-2.0),
        ctypes.byref(oqs), ctypes.byref(oqe), ctypes.byref(ors),
        ctypes.byref(ore),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.c_long(max_ops), ctypes.byref(nops), ctypes.byref(sw_score))
    if rc != 0:
        return None
    cigar = [(int(lens[i]), _OP_CHARS[int(ops[i])])
             for i in range(nops.value)]
    # segment -> strand-oriented full-reference coordinates
    if is_fwd:
        frs, fre = ws + ors.value, ws + ore.value
    else:
        off = lref - we          # window start on the revcomp strand
        frs, fre = off + ors.value, off + ore.value
    return (sw_score.value, name, is_fwd, oqs.value, oqe.value, frs, fre,
            cigar, lref, mapq)


def generate_guide_alignment(read_seq: str, reference,
                             contig: Optional[str] = None,
                             min_score: float = 50.0
                             ) -> Optional[GuideAlignment]:
    """Best local hit of ``read_seq`` against a ProcessedReference.

    Tries every contig (or just ``contig``) in both orientations; query
    coordinates of the returned guide are in the original read, ops in
    target orientation (the frame guide_from_sam_record produces).
    Contigs above SEEDED_MIN_REF bases map via the native seeded path
    (minimizer index + chained anchors + banded extension) instead of
    the full O(lq*lr) DP.
    """
    names = [contig] if contig else list(reference.forward.keys())
    best = None
    second = 0.0          # runner-up across contigs/orientations
    for name in names:
        fwd = reference.forward[name]
        if len(fwd) > SEEDED_MIN_REF:
            hit = _seeded_hit(read_seq, reference, name)
            if hit is not None:
                if best is None or hit[0] > best[0]:
                    if best is not None:
                        second = max(second, best[0])
                    best = hit
                else:
                    second = max(second, hit[0])
            continue
        for is_fwd, target in ((True, fwd), (False, reverse_complement(fwd))):
            hit = _sw(read_seq, target)
            if hit is None:
                continue
            score, qs, qe, rs, re_, cigar = hit
            if best is None or score > best[0]:
                if best is not None:
                    second = max(second, best[0])
                best = (score, name, is_fwd, qs, qe, rs, re_, cigar,
                        len(fwd), None)
            else:
                second = max(second, score)
    if best is None or best[0] < min_score:
        return None
    score, name, is_fwd, qs, qe, rs, re_, cigar, lref, mapq = best
    if mapq is None:
        # full-DP contigs: confidence from the best/runner-up
        # separation across contigs + orientations (single-contig
        # single-orientation maps keep full confidence — the full DP
        # already searched the whole reference)
        ratio = second / max(score, 1e-9)
        mapq = 0 if ratio >= 0.9 else min(60, int(60.0 * (1.0 - ratio)))
    if is_fwd:
        window_start, window_end = rs, re_
    else:
        # coordinates were on the reverse-complement strand
        window_start, window_end = lref - re_, lref - rs
    return GuideAlignment(
        contig=name, forward=is_fwd,
        window_start=window_start, window_end=window_end,
        query_start=qs, query_end=qe, ops=cigar, mapq=mapq)
