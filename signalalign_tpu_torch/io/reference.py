"""Reference FASTA handling, positions files and motif editing: the
port's copy of ``signalalign_tpu.io.reference`` but for ``write_fasta``
and ``find_gatc_motifs``.

reference: src/signalalign/utils/sequenceTools.py (processReferenceFasta,
CustomAmbiguityPositions, motif replacement, make_positions_file) and
impl/fasta_handler.c (window trimming / strand orientation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from signalalign_tpu_torch.utils.alphabet import (DEFAULT_AMBIG_BASES,
                                                  reverse_complement)


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    name, chunks = None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def load_fasta(path: str) -> Dict[str, str]:
    return dict(iter_fasta(path))


@dataclasses.dataclass
class AmbiguityPositions:
    """Positions-file driven reference editing.

    File format (CustomAmbiguityPositions, sequenceTools.py:551-648):
    tab-separated ``contig  position  strand(+/-)  change_from  change_to``.
    """
    data: List[Tuple[str, int, str, str, str]]

    @classmethod
    def from_file(cls, path: str) -> "AmbiguityPositions":
        rows = []
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 5:
                    rows.append((parts[0], int(parts[1]), parts[2], parts[3], parts[4]))
        return cls(rows)

    def edit(self, contig: str, seq: str, strand: str) -> str:
        """``seq`` with this strand's rows applied; a row whose change_from
        does not match the sequence raises, as the reference does
        (sequenceTools.py:629-632). Multi-character change_to values
        collapse to their ambiguity code (AMBIG_BASES inverse)."""
        code_for_set = {"".join(sorted(v)): k
                        for k, v in DEFAULT_AMBIG_BASES.items()}
        s = list(seq)
        for c, pos, st, frm, to in self.data:
            if c != contig or st != strand:
                continue
            if pos >= len(s):
                raise ValueError(f"position {pos} beyond contig {contig}")
            if s[pos].upper() != frm.upper() and s[pos].upper() not in to.upper():
                raise ValueError(
                    f"contig {contig} pos {pos}: expected {frm}, found {s[pos]}")
            if len(to) > 1:
                to = code_for_set.get("".join(sorted(to)), to[0])
            s[pos] = to
        return "".join(s)


def replace_motifs(seq: str, motifs: List[Tuple[str, str]]) -> str:
    """Substitute every occurrence of each motif (e.g. CCAGG -> CEAGG).

    reference: replace_motif (sequenceTools.py:166-257).
    """
    out = seq
    for find, repl in motifs:
        if len(find) != len(repl):
            raise ValueError("motif find/replace must have equal length")
        out = out.replace(find, repl)
    return out


class ProcessedReference:
    """Forward + backward edited reference sequences per contig.

    The "backward" sequence follows fasta_handler.c semantics: the
    complement (not reverse complement) read back-to-front; equivalently we
    store forward and backward editions and take windows with orientation at
    query time.

    reference: processReferenceFasta (sequenceTools.py:652-698) writes flat
    forward/backward files; here both editions stay in memory.
    """

    def __init__(self, fasta_path: str,
                 positions: Optional[AmbiguityPositions] = None,
                 motifs: Optional[List[Tuple[str, str]]] = None):
        self.forward: Dict[str, str] = {}
        self.backward: Dict[str, str] = {}  # complement strand, forward coords
        for name, seq in iter_fasta(fasta_path):
            seq = seq.upper()
            fwd = seq
            bwd = reverse_complement(seq)[::-1]  # = complement, forward coords
            if motifs:
                fwd = replace_motifs(fwd, motifs)
                bwd_rc = replace_motifs(reverse_complement(seq), motifs)
                bwd = bwd_rc[::-1]
            if positions:
                fwd = positions.edit(name, fwd, "+")
                bwd = positions.edit(name, bwd, "-")
            self.forward[name] = fwd
            self.backward[name] = bwd

    def contig_length(self, name: str) -> int:
        return len(self.forward[name])

    def template_target(self, name: str, start: int, end: int,
                        forward_mapped: bool) -> str:
        """Trimmed target sequence for the template strand.

        forward-mapped: the edited forward window [start, end).
        reverse-mapped: reverse of the backward (complement) window = the
        reverse-complement of the window, carrying '-'-strand edits.
        (fasta_handler.c:47-100 with backward file from processReferenceFasta)
        """
        if forward_mapped:
            return self.forward[name][start:end]
        return self.backward[name][start:end][::-1]

    def complement_target(self, name: str, start: int, end: int,
                          forward_mapped: bool) -> str:
        """Target for the complement strand of a 2D read (opposite edition)."""
        if forward_mapped:
            return self.backward[name][start:end][::-1]
        return self.forward[name][start:end]


def find_substring_indices(sequence: str, substring: str, offset: int = 0):
    """Yield indices (plus offset) of every occurrence of ``substring``
    that does not overlap the previous one.

    reference: find_substring_indices (sequenceTools.py:64-88).
    """
    start = 0
    step = max(len(substring), 1)
    while True:
        i = sequence.find(substring, start)
        if i < 0:
            return
        yield i + offset
        start = i + step


def find_motifs_sequence_positions(sequence: str, motifs):
    """(index, old_char, new_char) for each single-character motif edit.

    reference: find_motifs_sequence_positions (sequenceTools.py:182-204)."""
    seen = set()
    for find, repl in motifs:
        diffs = [i for i in range(len(find)) if find[i] != repl[i]]
        if len(diffs) != 1:
            raise ValueError(f"motif {find}->{repl} must differ in exactly "
                             "one character")
        off = diffs[0]
        for idx in find_substring_indices(sequence.upper(), find.upper(),
                                          offset=off):
            if idx in seen:
                raise ValueError("two motif edits hit one position")
            seen.add(idx)
            yield idx, find[off], repl[off]


def make_positions_file(reference_fasta: str, output_path: str,
                        motifs) -> str:
    """Positions tsv (contig position strand change_from change_to) from
    find/replace motifs on both strands.

    reference: make_positions_file (sequenceTools.py:136-161)."""
    rev_motifs = [(f[::-1], r[::-1]) for f, r in motifs]
    with open(output_path, "w") as out:
        for name, seq in iter_fasta(reference_fasta):
            fwd = seq.upper()
            bwd = reverse_complement(fwd)[::-1]  # complement, fwd coords
            for idx, old, new in find_motifs_sequence_positions(fwd, motifs):
                out.write(f"{name}\t{idx}\t+\t{old}\t{new}\n")
            for idx, old, new in find_motifs_sequence_positions(
                    bwd, rev_motifs):
                out.write(f"{name}\t{idx}\t-\t{old}\t{new}\n")
    return output_path
