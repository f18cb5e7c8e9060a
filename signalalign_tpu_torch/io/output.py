"""Output record assembly + TSV writers for the three reference formats:
the port's copy of ``signalalign_tpu.io.output``.

reference: impl/signalMachine.c writePosteriorProbsFull (89),
writePosteriorProbsVC (161), writeAssignments (234).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from signalalign_tpu_torch.io.guide import adjust_reference_coordinate
from signalalign_tpu_torch.models.pore_model import PoreModel, ScalingParams
from signalalign_tpu_torch.utils.alphabet import (find_degenerate_positions,
                                                  reverse_complement)

PAIR_PROB_1 = 10000000


@dataclasses.dataclass
class FullRow:
    contig: str
    reference_index: int
    reference_kmer: str
    read_file: str
    strand: str
    event_index: int
    event_mean: float
    event_noise: float
    event_duration: float
    aligned_kmer: str
    scaled_mean_current: float
    scaled_noise: float
    posterior_probability: float
    descaled_event_mean: float
    ont_model_mean: float
    path_kmer: str

    def tsv(self) -> str:
        return (f"{self.contig}\t{self.reference_index}\t{self.reference_kmer}\t"
                f"{self.read_file}\t{self.strand}\t{self.event_index}\t"
                f"{self.event_mean:f}\t{self.event_noise:f}\t"
                f"{self.event_duration:f}\t{self.aligned_kmer}\t"
                f"{self.scaled_mean_current:f}\t{self.scaled_noise:f}\t"
                f"{self.posterior_probability:f}\t{self.descaled_event_mean:f}\t"
                f"{self.ont_model_mean:f}\t{self.path_kmer}\n")


def build_full_rows(
    aligned_pairs: Sequence[Tuple[int, int, int, str]],  # (prob_int, x, y, path_kmer)
    target: str,
    events: np.ndarray,                  # full drift-adjusted event table
    model: PoreModel,
    params: ScalingParams,
    contig: str,
    read_label: str,
    strand_template: bool,
    forward: bool,
    event_offset: int,
    ref_offset: int,
    rna: bool = False,
) -> List[FullRow]:
    """Assemble 'full' output rows from DP-space aligned pairs.

    Mirrors writePosteriorProbsFull (signalMachine.c:89-160): coordinates
    adjusted back to genomic space, reference k-mer re-oriented to the
    forward strand, model expectations from the PATH k-mer.
    """
    strand_label = "t" if strand_template else "c"
    target_len = len(target)
    rows = []
    for prob_int, x, y, path_kmer in aligned_pairs:
        x_adj = adjust_reference_coordinate(x, ref_offset, target_len,
                                            model.kmer_length, strand_template,
                                            forward)
        y_full = y + event_offset
        p = prob_int / PAIR_PROB_1
        k_i = target[x:x + model.kmer_length]
        kmer_idx = model.alphabet.kmer_index(path_kmer)
        e_mean = model.level_mean[kmer_idx]
        e_noise = model.noise_mean[kmer_idx]
        scaled_e_mean = e_mean * params.scale + params.shift
        scaled_e_noise = e_noise * params.scale_sd
        ev_mean = float(events[y_full, 0])
        descaled = (ev_mean + params.var * e_mean - params.scale * e_mean
                    - params.shift) / params.var
        if (strand_template and forward) or (not strand_template and not forward):
            ref_kmer = k_i
        else:
            ref_kmer = reverse_complement(k_i)
        if rna:
            ref_kmer = reverse_complement(ref_kmer)
        rows.append(FullRow(
            contig=contig, reference_index=x_adj, reference_kmer=ref_kmer,
            read_file=read_label, strand=strand_label, event_index=y_full,
            event_mean=ev_mean, event_noise=float(events[y_full, 1]),
            event_duration=float(events[y_full, 2]), aligned_kmer=k_i,
            scaled_mean_current=scaled_e_mean, scaled_noise=scaled_e_noise,
            posterior_probability=p, descaled_event_mean=descaled,
            ont_model_mean=e_mean, path_kmer=path_kmer))
    return rows


def build_vc_rows(
    aligned_pairs: Sequence[Tuple[int, int, int, str]],
    target: str,
    model: PoreModel,
    ambig_map: Dict[str, str],
    contig: str,
    read_label: str,
    strand_template: bool,
    forward: bool,
    event_offset: int,
    ref_offset: int,
    posterior_score: float,
    rna: bool = False,
) -> List[Tuple]:
    """variantCaller rows: only pairs whose REFERENCE k-mer has ambiguity
    codes report, one row per degenerate position with the path-called base.

    reference: writePosteriorProbsVC (signalMachine.c:161-233).
    """
    strand_label = "t" if strand_template else "c"
    fwd_label_flag = (not forward) if (rna or not strand_template) else forward
    forward_label = "forward" if fwd_label_flag else "backward"
    target_len = len(target)
    k = model.kmer_length
    rows = []
    for prob_int, x, y, path_kmer in aligned_pairs:
        k_i = target[x:x + k]
        if (strand_template and forward) or (not strand_template and not forward):
            ref_kmer = k_i
        else:
            ref_kmer = reverse_complement(k_i)
        qpos = find_degenerate_positions(ref_kmer, ambig_map)
        if not qpos:
            continue
        x_adj = adjust_reference_coordinate(x, ref_offset, target_len, k,
                                            strand_template, forward)
        y_full = y + event_offset
        p = prob_int / PAIR_PROB_1
        for uq in qpos:
            if (strand_template and forward) or (not strand_template and not forward):
                q = uq
            else:
                q = (k - 1) - uq
            base = path_kmer[q]
            rows.append((y_full, x_adj + uq, base, p, strand_label,
                         forward_label, read_label, posterior_score, contig))
    return rows


def write_full_tsv(path: str, rows: Iterable[FullRow], append: bool = True) -> None:
    with open(path, "a" if append else "w") as fh:
        for r in rows:
            fh.write(r.tsv())


def write_vc_tsv(path: str, rows: Iterable[Tuple], append: bool = True) -> None:
    with open(path, "a" if append else "w") as fh:
        for r in rows:
            fh.write(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]:f}\t{r[4]}\t{r[5]}\t"
                     f"{r[6]}\t{r[7]:f}\t{r[8]}\n")


def write_assignments_tsv(path: str, aligned_pairs, events, model, params,
                          strand_template: bool, event_offset: int,
                          append: bool = True) -> None:
    """reference: writeAssignments (signalMachine.c:234-270)."""
    strand_label = "t" if strand_template else "c"
    with open(path, "a" if append else "w") as fh:
        for prob_int, x, y, path_kmer in aligned_pairs:
            y_full = y + event_offset
            kmer_idx = model.alphabet.kmer_index(path_kmer)
            e_mean = model.level_mean[kmer_idx]
            ev_mean = float(events[y_full, 0])
            descaled = (ev_mean + params.var * e_mean - params.scale * e_mean
                        - params.shift) / params.var
            fh.write(f"{path_kmer}\t{strand_label}\t{descaled:f}\t"
                     f"{prob_int / PAIR_PROB_1:f}\n")


def posterior_score(aligned_pairs) -> float:
    """Average posterior match prob per aligned pair x100
    (scoreByPosteriorProbabilityIgnoringGaps, signalMachine.c:407-412)."""
    if not aligned_pairs:
        return 0.0
    total = sum(p for p, *_ in aligned_pairs)
    return 100.0 * total / (len(aligned_pairs) * PAIR_PROB_1)
