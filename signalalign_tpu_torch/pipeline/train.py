"""Baum-Welch EM training in the port: the counterpart of ``EMResult``,
``normalize_transitions_expectations``, ``run_alignment_batch_grouped``,
``em_train`` and ``em_train_transitions`` in
``signalalign_tpu.pipeline.train`` (same M-steps, same checkpoint and
expectations files).

reference: src/signalalign/train/trainModels.py —
expectation_maximization_training (986), train_transitions (922),
train_normal_emmissions (735).

Each iteration runs one expectation pass through ``run_alignment_batch``
(``compute_expectations``): the expectation instances of the Hopper
kernels on a CUDA device, their plain twins on the CPU. The transition
posteriors and, with Gaussian emissions, the per-kmer emission moments
come back per read as small arrays; the M-step is a normalisation on the
host. Reads are prepared anew every iteration, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import random
import sys
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from signalalign_tpu_torch.models.expectations import (
    emission_slots_from_kexp, write_expectations_file)
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.pipeline.runner import run_alignment_batch
from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig


@dataclasses.dataclass
class EMResult:
    model: PoreModel
    likelihoods: List[float]          # reference-style (tot * n_diagonals)
    log_likelihoods: List[float]      # true sum of total log probs
    transitions_history: List[np.ndarray]
    # per-iteration raw (3, num_kmers) emission moments; zeros in MODE_HDP
    kexp_history: List[np.ndarray] = dataclasses.field(default_factory=list)
    expectations_files: List[str] = dataclasses.field(default_factory=list)
    checkpoint_files: List[str] = dataclasses.field(default_factory=list)


def normalize_transitions_expectations(texp: np.ndarray) -> np.ndarray:
    """Row-normalize the 3x3 transition expectation matrix.

    reference: normalize_transitions_expectations
    (hiddenMarkovModel.py:477-487).
    """
    out = texp.astype(np.float64).copy()
    for i in range(3):
        rs = out[i].sum()
        if rs > 0:
            out[i] /= rs
    return out


def run_alignment_batch_grouped(batch, reference, model, config, hdp=None,
                                *,
                                device: torch.device = torch.device("cuda"),
                                strand_template: bool = True,
                                stage_seconds: Optional[Dict[str, float]]
                                = None):
    """run_alignment_batch over entries that may carry a per-read
    reference override: ``(read, guide)`` uses the shared ``reference``,
    ``(read, guide, ref_i)`` aligns against ``ref_i`` (per-sample
    motif/positions-edited genomes, trainModels.py samples[] semantics).
    Entries sharing a reference batch together; result order follows the
    input order. ``stage_seconds`` sums the groups' stage seconds."""
    groups = defaultdict(list)
    refs = {}
    for i, rg in enumerate(batch):
        ref_i = rg[2] if len(rg) > 2 and rg[2] is not None else reference
        refs[id(ref_i)] = ref_i
        groups[id(ref_i)].append((i, rg[0], rg[1]))
    out = [None] * len(batch)
    for key, items in groups.items():
        stages: Dict[str, float] = {}
        res = run_alignment_batch([(r, g) for _, r, g in items],
                                  refs[key], model, config, hdp,
                                  device=device,
                                  strand_template=strand_template,
                                  stage_seconds=stages)
        if stage_seconds is not None:
            for k, v in stages.items():
                stage_seconds[k] = stage_seconds.get(k, 0.0) + v
        # per-read fault isolation can drop reads: match by read_label
        by_label = {}
        for r in res:
            by_label.setdefault(r.read_label, []).append(r)
        for i, read, _ in items:
            lst = by_label.get(read.read_label)
            if lst:
                out[i] = lst.pop(0)
    return [r for r in out if r is not None]


def em_train(
    reads_and_guides,
    reference,
    model: PoreModel,
    iterations: int = 3,
    config: Optional[AlignmentConfig] = None,
    hdp=None,
    update_transitions: bool = True,
    update_emissions: bool = False,
    emission_prior_weight: float = 0.0,
    min_sd: float = 0.0,
    training_bases: Optional[int] = None,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_prefix: str = "template_trained",
    write_expectations: bool = False,
    cross_host: bool = False,
    verbose: bool = False,
    assert_monotonic: bool = False,
    strand_template: bool = True,
    *,
    device: torch.device = torch.device("cuda"),
    stage_seconds: Optional[List[Dict[str, float]]] = None,
) -> EMResult:
    """Unified per-iteration Baum-Welch EM over a read batch on ``device``.

    Each iteration runs one expectation pass (transition posteriors and
    per-kmer emission moments from the same sweeps) and applies both
    M-steps, as the JAX ``em_train`` does. ``training_bases`` caps each
    E-step to a random read subset totalling that many read bases
    (trainModels.py:1144). Entries of ``reads_and_guides`` may be ``(read,
    guide)`` or ``(read, guide, reference)``. ``hdp`` with
    ``config.emission_mode`` MODE_HDP runs the threeStateHdp transition
    EM: its kexp is zero, so only the transitions train.
    ``checkpoint_dir`` writes a model file per iteration and, with
    ``write_expectations``, a reference-format expectations file summing
    the batch. ``stage_seconds``, when given, receives one dict of
    ``run_alignment_batch`` stage seconds per iteration. ``cross_host``
    (summing expectations across processes) raises: several GPUs are
    ROADMAP slice 4.
    """
    if cross_host:
        raise NotImplementedError(
            "cross_host EM (expectations summed across processes) comes with "
            "ROADMAP slice 4 (several GPUs)")
    model = copy.deepcopy(model)
    config = config or AlignmentConfig()
    # segment cap for parity of segmentation with the JAX em_train, which
    # caps segments at 3200 diagonals in its expectation passes: segments
    # change the totals and the expectations
    config = dataclasses.replace(
        config, compute_expectations=True,
        max_segment_diagonals=min(config.max_segment_diagonals, 3200))
    likelihoods: List[float] = []
    lls: List[float] = []
    history: List[np.ndarray] = []
    kexp_history: List[np.ndarray] = []
    exp_files: List[str] = []
    ckpt_files: List[str] = []

    for it in range(iterations):
        batch = list(reads_and_guides)
        if training_bases:
            random.Random(seed + it).shuffle(batch)
            subset, n_bases = [], 0
            for rg in batch:
                if n_bases > training_bases:
                    break
                subset.append(rg)
                n_bases += rg[0].read_length
            batch = subset
        stages: Dict[str, float] = {}
        results = run_alignment_batch_grouped(
            batch, reference, model, config, hdp, device=device,
            strand_template=strand_template, stage_seconds=stages)
        if stage_seconds is not None:
            stage_seconds.append(stages)
        texp = np.zeros((3, 3))
        kexp = np.zeros((3, model.alphabet.num_kmers))
        lik = 0.0
        ll = 0.0
        for r in results:
            texp += r.transition_expectations
            if r.emission_expectations is not None:
                kexp += r.emission_expectations
            lik += r.likelihood
            ll += r.total_log_prob
        mean_exp, sd_exp, posteriors, observed = emission_slots_from_kexp(
            kexp, model.level_mean)
        if write_expectations and checkpoint_dir:
            ep = os.path.join(checkpoint_dir,
                              f"{checkpoint_prefix}_{it}"
                              ".template.expectations.tsv")
            write_expectations_file(
                ep, model, texp.reshape(-1), lik,
                mean_expectations=mean_exp, sd_expectations=sd_exp,
                posteriors=posteriors, observed=observed)
            exp_files.append(ep)
        if update_transitions:
            probs = normalize_transitions_expectations(texp)
            model.set_transitions(probs.reshape(-1))
            history.append(probs)
        if update_emissions:
            # HmmModel.normalize emission M-step
            # (hiddenMarkovModel.py:488-517): µ̂ = Σpx/Σp, σ̂ = √(Σp(x−µ̂)²/Σp).
            # ``emission_prior_weight`` > 0 blends with the current model
            # like train_normal_emmissions (trainModels.py:761-828)
            safe = np.maximum(posteriors, 1e-300)
            u = mean_exp / safe
            o = np.sqrt(sd_exp / safe)
            w = emission_prior_weight
            if w > 0:
                u = (mean_exp + model.level_mean * w) / (posteriors + w)
                o = (o * posteriors + model.level_sd * w) / (posteriors + w)
            upd = observed & (u > 0)
            model.level_mean = np.where(upd, u, model.level_mean)
            model.level_sd = np.maximum(
                np.where(upd & (o > 0), o, model.level_sd), min_sd)
        model.likelihood = lik
        likelihoods.append(lik)
        lls.append(ll)
        kexp_history.append(kexp)
        if checkpoint_dir:
            cp = os.path.join(checkpoint_dir,
                              f"{checkpoint_prefix}_{it}.model")
            model.write(cp)
            ckpt_files.append(cp)
        if verbose:
            print(f"[train] iter {it}: log-likelihood {ll:.2f} "
                  f"({len(batch)} reads)", file=sys.stderr)
        if assert_monotonic and it > 0 and ll + 1e-6 < lls[-2]:
            raise AssertionError(
                f"EM log-likelihood decreased: {lls[-2]} -> {ll}")
    return EMResult(model=model, likelihoods=likelihoods,
                    log_likelihoods=lls, transitions_history=history,
                    kexp_history=kexp_history, expectations_files=exp_files,
                    checkpoint_files=ckpt_files)


def em_train_transitions(
    reads_and_guides,
    reference,
    model: PoreModel,
    iterations: int = 3,
    config: Optional[AlignmentConfig] = None,
    verbose: bool = False,
    assert_monotonic: bool = False,
    *,
    device: torch.device = torch.device("cuda"),
) -> EMResult:
    """Transition-only Baum-Welch EM (train_transitions,
    trainModels.py:922-985). Thin wrapper over em_train."""
    return em_train(reads_and_guides, reference, model,
                    iterations=iterations, config=config,
                    update_transitions=True, update_emissions=False,
                    verbose=verbose, assert_monotonic=assert_monotonic,
                    device=device)
