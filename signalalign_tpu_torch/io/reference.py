"""Reference FASTA handling and motif editing: the port's copy of the parts
of ``signalalign_tpu.io.reference`` it calls.

reference: src/signalalign/utils/sequenceTools.py (processReferenceFasta,
motif replacement) and impl/fasta_handler.c (window trimming / strand
orientation).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from signalalign_tpu_torch.utils.alphabet import reverse_complement


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
    complement (not reverse complement) read back-to-front, in forward
    coordinates; windows are taken with orientation at query time.
    """

    def __init__(self, fasta_path: str,
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
            self.forward[name] = fwd
            self.backward[name] = bwd

    def template_target(self, name: str, start: int, end: int,
                        forward_mapped: bool) -> str:
        """Trimmed target sequence for the template strand: the edited
        forward window, or for reverse-mapped reads the reverse of the
        backward (complement) window (fasta_handler.c:47-100)."""
        if forward_mapped:
            return self.forward[name][start:end]
        return self.backward[name][start:end][::-1]

    def complement_target(self, name: str, start: int, end: int,
                          forward_mapped: bool) -> str:
        """Target for the complement strand of a 2D read (opposite edition)."""
        if forward_mapped:
            return self.backward[name][start:end][::-1]
        return self.forward[name][start:end]
