"""Variant / methylation calling from per-site posterior sums: the port's
copy of the parts of ``signalalign_tpu.pipeline.variant_caller`` it calls.

reference: src/signalalign/variantCaller.py — MarginalizeFullVariants (92)
and AggregateOverReadsFull (282).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import pandas as pd


def aggregate_over_reads(per_read: Sequence[pd.DataFrame],
                         variants: str) -> pd.DataFrame:
    """Across-read aggregation with per-position normalization.

    reference: AggregateOverReadsFull.marginalize_over_all_reads
    (variantCaller.py:385-408): sum each candidate's probabilities across
    reads at a position, then renormalize.
    """
    variants = sorted(variants)
    frames = [df for df in per_read if len(df)]
    if not frames:
        return pd.DataFrame(columns=["contig", "position", "strand",
                                     "forward_mapped"] + list(variants))
    allr = pd.concat(frames, ignore_index=True)
    grouped = allr.groupby(["contig", "position", "strand"], as_index=False)[
        list(variants)].sum()
    totals = grouped[list(variants)].sum(axis=1)
    for v in variants:
        grouped[v] = grouped[v] / totals
    return grouped


def variant_calls_dataframe(per_pos: Dict[Tuple[str, int], Dict[str, float]],
                            read_name: str, contig: str,
                            forward_mapped: bool, variants: str
                            ) -> pd.DataFrame:
    """Per-read calls table from {(strand, genomic position): {base: p}}.

    Schema and row order mirror MarginalizeFullVariants.get_data
    (variantCaller.py:123-187): template strand first, positions
    ascending on the '+' mapping strand and descending on '-'.
    """
    vs = sorted(variants)
    data = []
    mapping_strands = ["+", "-"] if forward_mapped else ["-", "+"]
    for si, strand in enumerate(("t", "c")):
        positions = sorted(pos for (s, pos) in per_pos if s == strand)
        if mapping_strands[si] == "-":
            positions = positions[::-1]
        for pos in positions:
            probs = per_pos[(strand, pos)]
            total = sum(probs.get(v, 0.0) for v in vs)
            if total <= 0:
                continue
            data.append([read_name, contig, pos, strand,
                         mapping_strands[si]]
                        + [probs.get(v, 0.0) / total for v in vs])
    cols = ["read_name", "contig", "position", "strand", "forward_mapped"] \
        + list(vs)
    return pd.DataFrame(data, columns=cols)


def per_read_calls_dataframe(position_probs: pd.DataFrame,
                             variants: str) -> pd.DataFrame:
    """Per-read per-strand averages of the per-position calls, with the
    site count (MarginalizeFullVariants.per_read_calls,
    variantCaller.py:120-121, 176-180)."""
    vs = sorted(variants)
    cols = ["read_name", "contig", "strand", "forward_mapped", "n_sites"] \
        + list(vs)
    if not len(position_probs):
        return pd.DataFrame(columns=cols)
    data = []
    for (rn, contig, strand, fwd), grp in position_probs.groupby(
            ["read_name", "contig", "strand", "forward_mapped"],
            sort=False):
        data.append([rn, contig, strand, fwd, len(grp)]
                    + [float(grp[v].mean()) for v in vs])
    return pd.DataFrame(data, columns=cols)


def marginals_from_site_probs(site_cells, site_probs, problem,
                              variants: str, seg_x_offset: int = 0
                              ) -> Dict[int, Dict[str, float]]:
    """Per-site normalized variant probabilities from device site sums:
    each path's posterior mass at a site cell goes to the base its path
    k-mer calls at the k-mer's last position (MarginalizeFullVariants'
    aggregation key, variantCaller.py:123-187), normalized per site.

    site_cells: 1-based segment cell x positions whose k-mer reports at
    the site (the site sits at the k-mer's LAST base); site_probs:
    (P, n_sites) sums; problem: the segment's BandedProblem (for path
    k-mers). Returns {segment position (0-based ref index +
    seg_x_offset): {base: p}}.
    """
    k1 = problem.kmer_len - 1
    out: Dict[int, Dict[str, float]] = {}
    vs = sorted(variants)
    for si, x in enumerate(site_cells):
        acc = {v: 0.0 for v in vs}
        for j in range(site_probs.shape[0]):
            kmer = problem.path_kmer_at(int(x), j)
            if kmer is None:
                continue
            base = kmer[k1]
            if base in acc:
                acc[base] += float(site_probs[j, si])
        total = sum(acc.values())
        if total <= 0:
            continue
        pos = (int(x) - 1) + k1 + seg_x_offset
        out[pos] = {v: p / total for v, p in acc.items()}
    return out
