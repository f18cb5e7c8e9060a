"""Guide alignments: anchor constraints + coordinate frames for the banded
DP. The port's copy of ``signalalign_tpu.io.guide``: ``GuideAlignment``,
``guide_from_sam_record``, ``find_guide_alignment``,
``adjust_reference_coordinate`` and ``TargetRegions``.

Coordinate conventions (src/signalalign/__init__.py:30-95,
impl/signalMachineUtils.c:130-171 rebasing, impl/signalMachine.c:54-87):

* The alignment window on the reference is [window_start, window_end) in
  forward 0-based coordinates.
* The DP target sequence is the forward window for forward-mapped reads and
  the reverse-complement of the window for reverse-mapped reads; anchor ref
  coordinates are offsets into that target orientation.
* Query (read) coordinates are in the ORIGINAL basecalled read orientation:
  for reverse-mapped reads the BAM SEQ is the reverse-complement of the
  read, so its CIGAR is walked back-to-front (matching the reference's
  op-list reversal) while query positions count forward in the original
  read.
* Anchors from M runs are trimmed by ``trim`` on both sides
  (convertPairwiseForwardStrandAlignmentToAnchorPairs,
  impl/pairwiseAligner.c:1624-1656) and guarded so a full k-mer fits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from signalalign_tpu_torch.io.sam import SamRecord
from signalalign_tpu_torch.ops.band_geometry import filter_to_remove_overlap

ALIGN_OPS = {"M", "=", "X"}
REF_OPS = {"M", "D", "N", "=", "X"}
QUERY_OPS = {"M", "I", "=", "X"}
CLIP_OPS = {"S", "H"}


@dataclasses.dataclass
class GuideAlignment:
    contig: str
    forward: bool                # read maps to forward strand
    window_start: int            # forward 0-based inclusive
    window_end: int              # forward 0-based exclusive
    query_start: int             # original-read coordinates
    query_end: int
    ops: List[Tuple[int, str]]   # CIGAR in target orientation
    mapq: int = 60

    @property
    def window_length(self) -> int:
        return self.window_end - self.window_start

    @property
    def reference_coord_shift(self) -> int:
        """Offset used to map DP x back to genomic coordinates
        (signalMachine.c rCoordinateShift: start1 = window start for forward
        reads, the exclusive right end for reverse reads)."""
        return self.window_start if self.forward else self.window_end

    def output_frame(self, rna: bool) -> Tuple[bool, int]:
        """(forward flag, reference shift) as seen by the output writers;
        for RNA the reference frame is reversed before output
        (impl/fasta_handler.c:74-85)."""
        if not rna:
            return self.forward, self.reference_coord_shift
        return (not self.forward,
                self.window_end if self.forward else self.window_start)

    def anchor_pairs(self, trim: int,
                     kmer_guard: int = 6) -> List[Tuple[int, int]]:
        """(target_offset, read_pos) anchors from trimmed M runs: each M run
        contributes positions [trim, len-trim) subject to offset +
        kmer_guard <= window length."""
        out = []
        j = 0
        k = self.query_start
        for length, op in self.ops:
            if op in ALIGN_OPS:
                for l in range(trim, length - trim):
                    if self.window_length >= j + l + kmer_guard:
                        out.append((j + l, k + l))
            if op in REF_OPS:
                j += length
            if op in QUERY_OPS:
                k += length
        out.sort()
        return filter_to_remove_overlap(out)

    def validate(self, read_length: Optional[int] = None) -> bool:
        if self.window_start >= self.window_end:
            return False
        if self.query_start >= self.query_end:
            return False
        if read_length is not None and self.query_end > read_length:
            return False
        ref_len = sum(l for l, op in self.ops if op in REF_OPS)
        return ref_len == self.window_length


def guide_from_sam_record(rec: SamRecord) -> Optional[GuideAlignment]:
    """Build a GuideAlignment from a mapped primary SAM/BAM record."""
    if not rec.is_mapped or not rec.cigar:
        return None
    forward = not rec.is_reverse

    ops = [(l, op) for l, op in rec.cigar]
    ref_span = sum(l for l, op in ops if op in REF_OPS)
    window_start = rec.pos
    window_end = rec.pos + ref_span

    # leading/trailing clips in SEQ orientation
    lead_clip = 0
    for l, op in ops:
        if op in CLIP_OPS:
            lead_clip += l
        else:
            break
    tail_clip = 0
    for l, op in reversed(ops):
        if op in CLIP_OPS:
            tail_clip += l
        else:
            break
    seq_aln_len = sum(l for l, op in ops if op in QUERY_OPS)
    read_len = lead_clip + seq_aln_len + tail_clip

    aln_ops = [(l, op) for l, op in ops if op not in CLIP_OPS]
    if forward:
        query_start = lead_clip
    else:
        # reverse-mapped: original read = revcomp(SEQ); walk ops backwards
        aln_ops = aln_ops[::-1]
        query_start = tail_clip
    query_end = query_start + seq_aln_len

    return GuideAlignment(
        contig=rec.rname, forward=forward,
        window_start=window_start, window_end=window_end,
        query_start=query_start, query_end=query_end,
        ops=aln_ops, mapq=rec.mapq)


def find_guide_alignment(alignment_file: str, read_label: str) -> Optional[GuideAlignment]:
    """Locate a read's primary mapping in a SAM/BAM file.

    reference: getGuideAlignmentFromAlignmentFile (utils/bwaWrapper.py).
    """
    from signalalign_tpu_torch.io.sam import read_alignment_file
    _, records = read_alignment_file(alignment_file)
    for rec in records:
        if rec.qname == read_label and rec.is_mapped and rec.is_primary:
            return guide_from_sam_record(rec)
    return None


def adjust_reference_coordinate(x: int, ref_offset: int, target_len: int,
                                kmer_length: int, strand_template: bool,
                                forward: bool) -> int:
    """DP x (target-orientation kmer index) -> genomic kmer-start coordinate.

    reference: adjustReferenceCoordinate (signalMachine.c:54-64).
    """
    if (strand_template and forward) or (not strand_template and not forward):
        return x + ref_offset
    return (target_len - kmer_length) - (x + (target_len - ref_offset))


class TargetRegions:
    """Restrict alignments to target regions (2-column tsv of start/end).

    reference: TargetRegions (utils/bwaWrapper.py:34-56): a guide alignment
    is kept only if some region lies fully inside its reference window.
    """

    def __init__(self, tsv: str):
        regions = []
        with open(tsv) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    a, b = int(parts[0]), int(parts[1])
                    regions.append((min(a, b), max(a, b)))
        if not regions:
            raise ValueError(f"empty regions file: {tsv}")
        self.regions = regions

    def check_aligned_region(self, left: int, right: int) -> bool:
        if right < left:
            left, right = right, left
        return any(left <= a and b <= right for a, b in self.regions)

    def accepts(self, guide: "GuideAlignment") -> bool:
        return self.check_aligned_region(guide.window_start,
                                         guide.window_end)
