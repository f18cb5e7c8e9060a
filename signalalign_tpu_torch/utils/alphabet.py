"""Alphabet / k-mer indexing and ambiguity-base handling: the port's copy
of the parts of ``signalalign_tpu.utils.alphabet`` it calls (same
formulas, same order).

* k-mer ranking is the lexicographic rank over the (sorted) model alphabet
  (reference ``kmer_id``, nanopore_hdp.c:405).
* The default ambiguity-base map mirrors ``create_ambig_bases``
  (pairwiseAligner.c:32-65).
* Path expansion of a k-mer containing ambiguity codes follows
  ``hdCell_construct2`` (pairwiseAligner.c:723-801): scan the k-mer left to
  right, and for every ambiguous position fan out one variant per
  substitution base, preserving substitution-base order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# reference: pairwiseAligner.c:32-65 (create_ambig_bases)
DEFAULT_AMBIG_BASES: Dict[str, str] = {
    "R": "AG",
    "Y": "CT",
    "S": "CG",
    "W": "AT",
    "K": "GT",
    "M": "AC",
    "B": "CGT",
    "D": "AGT",
    "H": "ACT",
    "V": "ACG",
    "X": "ACGT",
    "L": "CEO",
    "P": "CE",
    "Q": "AI",
    "f": "AF",
    "U": "ACEGOT",
    "Z": "JT",
    "j": "Tp",
    "k": "Gb",
    "l": "Ad",
    "m": "Ce",
    "n": "Th",
    "o": "Ai",
    "i": "ACGTa",
    "u": "Cb",
    "v": "Ac",
    "w": "Gd",
    "x": "Te",
    "y": "Af",
    "z": "Cg",
    "q": "Gh",
    "r": "Ti",
    "s": "Aj",
    "t": "Ck",
    "a": "Gl",
    "b": "Tm",
}


def load_ambig_map(path: str | None) -> Dict[str, str]:
    """Load a two-column (code, substitution-bases) TSV; None -> defaults.

    reference: impl/pairwiseAligner.c:68-92 (create_ambig_bases2)
    """
    if path is None:
        return dict(DEFAULT_AMBIG_BASES)
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


class Alphabet:
    """A model alphabet with k-mer to rank conversions.

    The rank of a k-mer is its lexicographic index with digit values given by
    each base's position in the *sorted* alphabet.
    """

    def __init__(self, letters: str, kmer_length: int):
        self.letters = "".join(sorted(letters))
        self.size = len(self.letters)
        self.kmer_length = int(kmer_length)
        self.num_kmers = self.size ** self.kmer_length
        self._base_to_digit = {c: i for i, c in enumerate(self.letters)}
        # char-code lookup table for vectorized conversion
        self._code_lut = np.full(256, -1, dtype=np.int64)
        for c, i in self._base_to_digit.items():
            self._code_lut[ord(c)] = i
        # powers alphabet_size**(k-1-j)
        self._powers = self.size ** np.arange(self.kmer_length - 1, -1, -1,
                                              dtype=np.int64)

    def kmer_index(self, kmer: str) -> int:
        """Lexicographic rank of a single k-mer."""
        idx = 0
        for j, c in enumerate(kmer):
            idx += self._base_to_digit[c] * int(self._powers[j])
        return idx

    def index_to_kmer(self, index: int) -> str:
        out = []
        for p in self._powers:
            d, index = divmod(index, int(p))
            out.append(self.letters[d])
        return "".join(out)

    def seq_to_digits(self, seq: str) -> np.ndarray:
        """Per-base digit values; -1 for characters outside the alphabet."""
        codes = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
        return self._code_lut[codes]

    def seq_to_kmer_ids(self, seq: str) -> np.ndarray:
        """Rank of every overlapping k-mer of ``seq`` (len(seq)-k+1 entries).

        Raises ValueError if the sequence contains characters outside the
        alphabet (use path expansion for ambiguity codes first).
        """
        digits = self.seq_to_digits(seq)
        if (digits < 0).any():
            bad = sorted({seq[i] for i in np.nonzero(digits < 0)[0]})
            raise ValueError(f"sequence contains non-alphabet characters {bad}")
        if len(seq) < self.kmer_length:
            return np.zeros(0, dtype=np.int64)
        n = len(seq) - self.kmer_length + 1
        windows = np.lib.stride_tricks.sliding_window_view(
            digits, self.kmer_length)[:n]
        return windows @ self._powers


def expand_kmer_paths(kmer: str, ambig_map: Dict[str, str]) -> List[str]:
    """Expand one (possibly ambiguous) k-mer into its path k-mers, in the
    order of hdCell_construct2 (pairwiseAligner.c:723-801)."""
    kmers = [kmer]
    for i, c in enumerate(kmer):
        repl = ambig_map.get(c)
        if repl is None:
            continue
        kmers = [k[:i] + r + k[i + 1:] for k in kmers for r in repl]
    return kmers


def find_degenerate_positions(kmer: str,
                              ambig_map: Dict[str, str]) -> List[int]:
    """Positions of ambiguity codes in the k-mer (path_findDegeneratePositions,
    pairwiseAligner.c:577, against the active ambiguity map)."""
    return [i for i, c in enumerate(kmer) if c in ambig_map]


def max_paths_per_kmer(seq: str, kmer_length: int,
                       ambig_map: Dict[str, str]) -> int:
    """Maximum number of path k-mers any window of ``seq`` expands into."""
    p = paths_per_kmer(seq, kmer_length, ambig_map)
    return int(p.max()) if len(p) else 1


def paths_per_kmer(seq: str, kmer_length: int, ambig_map: Dict[str, str]):
    """Per-window path-expansion counts (length len(seq) - k + 1)."""
    lX = max(0, len(seq) - kmer_length + 1)
    per_char = np.array([len(ambig_map[c]) if c in ambig_map else 1
                         for c in seq], dtype=np.int64)
    if lX == 0:
        return np.ones(0, dtype=np.int64)
    # product over each window via cumulative products
    logs = np.log(per_char)
    cs = np.concatenate([[0.0], np.cumsum(logs)])
    return np.rint(np.exp(cs[kmer_length:kmer_length + lX]
                          - cs[:lX])).astype(np.int64)


_IUPAC_COMPLEMENT = str.maketrans(
    "ACGTRYSWKMBDHVNacgtryswkmbdhvn",
    "TGCAYRSWMKVHDBNtgcayrswmkvhdbn",
)


def reverse_complement(seq: str) -> str:
    return seq.translate(_IUPAC_COMPLEMENT)[::-1]


def load_ambig_model(path: str) -> dict:
    """Custom ambiguity-expansion table from a 2-column tsv
    (code \t expansion-bases), replacing the built-in table.

    reference: create_ambig_bases2 (impl/pairwiseAligner.c:68-92) /
    CustomAmbiguityPositions.parse_ambig_model (sequenceTools.py:563-584).
    """
    table = dict(DEFAULT_AMBIG_BASES)
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                table[parts[0]] = parts[1]
    return table
