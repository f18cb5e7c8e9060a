"""Per-read alignment records and configuration for the port: the
counterparts of ``AlignmentConfig``, ``ReadAlignment``, the shape
buckets and ``align_read`` in ``signalalign_tpu.pipeline.signal_align``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from signalalign_tpu_torch.io.guide import GuideAlignment
from signalalign_tpu_torch.io.output import build_full_rows, build_vc_rows
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
    # moments per read (P = 1 segments only; pipeline.train sets it)
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
               device: torch.device,
               strand_template: bool = True) -> ReadAlignment:
    """Align one read strand against its guide window (a batch of one);
    ``hdp`` gives MODE_HDP its emissions."""
    from signalalign_tpu_torch.pipeline.runner import run_alignment_batch
    out = run_alignment_batch([(read, guide)], reference, model, config, hdp,
                              device=device, strand_template=strand_template,
                              verbose=True)
    if not out:
        raise ValueError(f"{read.read_label}: alignment failed")
    return out[0]
