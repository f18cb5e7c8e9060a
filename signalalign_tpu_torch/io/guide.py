"""Guide alignments: anchor constraints + coordinate frames for the banded
DP. The port's copy of the parts of ``signalalign_tpu.io.guide`` it calls
(``GuideAlignment`` and ``adjust_reference_coordinate``).

Coordinate conventions (src/signalalign/__init__.py:30-95,
impl/signalMachineUtils.c:130-171 rebasing, impl/signalMachine.c:54-87):

* The alignment window on the reference is [window_start, window_end) in
  forward 0-based coordinates.
* The DP target sequence is the forward window for forward-mapped reads and
  the reverse-complement of the window for reverse-mapped reads; anchor ref
  coordinates are offsets into that target orientation.
* Query (read) coordinates are in the ORIGINAL basecalled read orientation.
* Anchors from M runs are trimmed by ``trim`` on both sides
  (convertPairwiseForwardStrandAlignmentToAnchorPairs,
  impl/pairwiseAligner.c:1624-1656) and guarded so a full k-mer fits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from signalalign_tpu_torch.ops.band_geometry import filter_to_remove_overlap

ALIGN_OPS = {"M", "=", "X"}
REF_OPS = {"M", "D", "N", "=", "X"}
QUERY_OPS = {"M", "I", "=", "X"}


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


def adjust_reference_coordinate(x: int, ref_offset: int, target_len: int,
                                kmer_length: int, strand_template: bool,
                                forward: bool) -> int:
    """DP x (target-orientation kmer index) -> genomic kmer-start coordinate.

    reference: adjustReferenceCoordinate (signalMachine.c:54-64).
    """
    if (strand_template and forward) or (not strand_template and not forward):
        return x + ref_offset
    return (target_len - kmer_length) - (x + (target_len - ref_offset))
