"""Per-read alignment records and configuration for the port: the
counterparts of ``AlignmentConfig``, ``ReadAlignment``, the shape
buckets, ``align_read`` and ``align_read_2d`` in
``signalalign_tpu.pipeline.signal_align``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from signalalign_tpu_torch.io.guide import GuideAlignment
from signalalign_tpu_torch.io.output import (build_full_rows, build_vc_rows,
                                             posterior_score)
from signalalign_tpu_torch.io.read import NanoporeReadData
from signalalign_tpu_torch.io.reference import ProcessedReference
from signalalign_tpu_torch.models.pore_model import PoreModel, ScalingParams
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.utils.alphabet import DEFAULT_AMBIG_BASES


@dataclasses.dataclass
class AlignmentConfig:
    threshold: float = 0.01
    diagonal_expansion: int = 50       # signalMachine.c:487 default
    constraint_trim: int = 14
    split_bigger_than: int = 3000 * 3000
    # split segments whose band bulges past this width at the bulge's
    # flanking anchors, and cap segment diagonal counts, so shape buckets
    # stay homogeneous (band_geometry.split_segment_by_width)
    max_band_width: int = 768
    max_segment_diagonals: int = 11800
    estimate_params: bool = True       # signalMachine ESTIMATE_PARAMS
    emission_mode: int = bfb.MODE_MEAN_ONLY
    ambig_map: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_AMBIG_BASES))
    # EM expectation pass: transition posteriors and Gaussian emission
    # moments per read (segments of any P; pipeline.train sets it)
    compute_expectations: bool = False
    # isolate sparse adjacent-degenerate (P>2, then P>4) windows into
    # their own segments (band_geometry.split_segment_by_paths), as the
    # JAX runner does; None = AUTO: on for batches of >= 128 reads. The
    # segments must equal the JAX runner's for the two to be compared.
    path_split: Optional[bool] = None

    def for_batch(self, n_reads: int) -> "AlignmentConfig":
        """This config with ``path_split`` AUTO resolved for a batch of
        ``n_reads`` reads (on from 128 reads, as in the JAX runner)."""
        if self.path_split is not None:
            return self
        return dataclasses.replace(self, path_split=n_reads >= 128)


@dataclasses.dataclass
class ReadAlignment:
    read_label: str
    contig: str
    forward: bool
    strand_template: bool
    aligned_pairs: List[Tuple[int, int, int, str]]  # (prob_int, x, y, kmer)
    score: float
    target: str
    event_offset: int
    ref_offset: int
    params: ScalingParams
    events: np.ndarray            # drift-adjusted full event table
    total_log_prob: float
    rna: bool = False
    # max over the read's segments of |total_f - total_b|: a nat or more
    # means the DP lost precision
    max_total_gap: float = 0.0
    # EM expectation pass (AlignmentConfig.compute_expectations): the
    # (3, 3) transition posterior sums over the read's segments, their
    # reference-style likelihood (sum of total_f * n_diag) and the
    # (3, num_kmers) per-kmer emission moments [Σp, Σp·dx, Σp·dx²]
    # (models.expectations.emission_slots_from_kexp converts them; zeros
    # in MODE_HDP)
    transition_expectations: Optional[np.ndarray] = None
    likelihood: float = 0.0
    emission_expectations: Optional[np.ndarray] = None
    # site-calling mode (run_alignment_batch call_variants): the per-read
    # variant-call table (marginalize_full_variants schema, a pandas
    # DataFrame) from device site sums; aligned_pairs stays empty then
    variant_calls: Optional[object] = None

    def full_rows(self, model: PoreModel):
        return build_full_rows(
            self.aligned_pairs, self.target, self.events, model, self.params,
            self.contig, self.read_label, self.strand_template, self.forward,
            self.event_offset, self.ref_offset, self.rna)

    def vc_rows(self, model: PoreModel, ambig_map=None):
        return build_vc_rows(
            self.aligned_pairs, self.target, model,
            ambig_map or DEFAULT_AMBIG_BASES, self.contig, self.read_label,
            self.strand_template, self.forward, self.event_offset,
            self.ref_offset, self.score, self.rna)


def _bucket_w(w: int) -> int:
    # coarse buckets: padded band compute is cheap next to more buckets
    for b in (64, 128, 256, 512, 768, 1024):
        if w <= b:
            return b
    return ((w + 255) // 256) * 256


def _bucket_d(d: int) -> int:
    # pow2 up to 8192, then 4096-granular (the segment splitter targets
    # max_segment_diagonals so long reads fill the 12288 bucket)
    for b in (2048, 4096, 8192, 12288, 16384):
        if d + 1 <= b:
            return b
    return ((d + 4096) // 4096) * 4096


def align_read(read: NanoporeReadData, guide: GuideAlignment,
               reference: ProcessedReference, model: PoreModel,
               config: Optional[AlignmentConfig] = None, hdp=None, *,
               device: torch.device = torch.device("cuda"),
               strand_template: bool = True) -> ReadAlignment:
    """Align one read strand against its guide window as the JAX
    ``align_read`` does (``signal_align.py:125-274``), as signalMachine
    does: one problem per ``get_split_points`` segment, without the batch
    runner's width, diagonal-count and path-class sub-splits, each run on
    ``device`` through ``HopperAligner`` (the kernels on CUDA, their twins
    on the CPU); pairs, totals and, with ``compute_expectations``, the
    expectations accumulated over the segments in order. ``hdp`` gives
    MODE_HDP its emissions."""
    from signalalign_tpu_torch.convert import hdp_tables
    from signalalign_tpu_torch.ops.banded_fb_hopper import HopperAligner
    from signalalign_tpu_torch.pipeline.runner import (_check_slice,
                                                       read_window,
                                                       segment_shape,
                                                       split_anchors)
    config = config or AlignmentConfig()
    _check_slice(config, hdp)
    k = model.kmer_length
    expect = config.compute_expectations
    target, params, events, ev_start, window_events, anchors, splits = \
        read_window(read, guide, reference, model, config, strand_template)
    tables = (hdp_tables(*hdp.density_arrays(), device)
              if config.emission_mode == bfb.MODE_HDP else None)
    all_pairs: List[Tuple[int, int, int, str]] = []
    texp = np.zeros((3, 3))
    kexp = np.zeros((3, model.alphabet.num_kmers))
    likelihood = total_lp = gap = 0.0
    for (x1, y1, x2, y2), seg_anchors in split_anchors(anchors, splits):
        seg_chars = target[x1:x2 + k - 1]
        seg_events = window_events[y1:y2]
        W, Dpad, P = segment_shape(seg_chars, len(seg_events), seg_anchors,
                                   k, config)
        problem = bfb.prepare_problem(
            seg_chars, seg_events, model, params, config.ambig_map, W=W,
            Dpad=Dpad, P=P, mode=config.emission_mode,
            anchor_pairs=seg_anchors, expansion=config.diagonal_expansion,
            hdp=hdp)
        r = HopperAligner([problem], W, device, tables,
                          expect=expect).execute(config.threshold)[0]
        total_lp += r["total_f"]
        gap = max(gap, abs(r["total_f"] - r["total_b"]))
        if expect:
            texp += r["texp"]
            kexp += r["kexp"]
            likelihood += r["total_f"] * problem.n_diag
        all_pairs += [(prob, x + x1, y + y1, kmer)
                      for prob, x, y, kmer in r["pairs"]]
    all_pairs.sort(key=lambda r: (r[1] + r[2], r[1]))
    if strand_template:
        fwd_out, ref_shift = guide.output_frame(read.rna)
    else:
        fwd_out = guide.forward
        ref_shift = guide.window_end if guide.forward else guide.window_start
    return ReadAlignment(
        read_label=read.read_label, contig=guide.contig, forward=fwd_out,
        strand_template=strand_template, aligned_pairs=all_pairs,
        score=posterior_score(all_pairs), target=target,
        event_offset=ev_start, ref_offset=ref_shift, params=params,
        events=events, total_log_prob=total_lp, rna=read.rna,
        max_total_gap=gap,
        transition_expectations=texp if expect else None,
        likelihood=likelihood,
        emission_expectations=kexp if expect else None)


def align_read_2d(read2d, guide: GuideAlignment,
                  reference: ProcessedReference,
                  template_model: PoreModel, complement_model: PoreModel,
                  config: Optional[AlignmentConfig] = None, *,
                  device: torch.device = torch.device("cuda")
                  ) -> Tuple[ReadAlignment, ReadAlignment]:
    """Both strands of a 2D read (signalMachine.c twoD path, 850-916), as
    the JAX ``align_read_2d`` (``signal_align.py:235-249``): the template
    aligned with the template model against the template target, the
    complement with the complement model against the opposite edition;
    both share the guide anchors remapped through their own 2D event
    maps."""
    t = align_read(read2d.template, guide, reference, template_model,
                   config, strand_template=True,
                   device=device)
    c = align_read(read2d.complement, guide, reference, complement_model,
                   config, strand_template=False,
                   device=device)
    return t, c
