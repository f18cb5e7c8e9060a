"""Baum-Welch EM training in the port: the counterpart of ``EMResult``,
``normalize_transitions_expectations``, ``run_alignment_batch_grouped``,
``em_train`` and ``em_train_transitions`` in
``signalalign_tpu.pipeline.train`` (same M-steps, same checkpoint and
expectations files), ``train_complement`` (the complement strand's EM of
the JAX CLI's ``train``), and copies of its HDP training-data helpers
(``collect_kmer_observations``, ``train_gaussian_emissions``,
``write_hdp_training_file``, ``build_alignment_from_tsvs``).

reference: src/signalalign/train/trainModels.py —
expectation_maximization_training (986), train_transitions (922),
train_normal_emmissions (735), CreateHdpTrainingData/train_hdp (427/830).

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
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

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
            "cross_host EM (expectations summed across processes) is not "
            "ported yet (ROADMAP §1 item 5, slice 4: several GPUs)")
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


def sample_reference(sample: dict, reference, ref_path: str):
    """A training sample's reference (the JAX ``cmd_train``'s
    ``_sample_reference``, ``cli.py:163-180``): its ``motifs`` or
    ``positions_file`` edition of its ``bwa_reference`` (default
    ``ref_path``), so that an mC sample's alignments carry E-labelled
    k-mers; ``reference`` (the unedited one) when it has neither."""
    from signalalign_tpu_torch.io.reference import (AmbiguityPositions,
                                                    ProcessedReference)
    motifs = sample.get("motifs")
    pf = sample.get("positions_file")
    if not motifs and not pf:
        return reference
    return ProcessedReference(
        sample.get("bwa_reference") or ref_path,
        positions=AmbiguityPositions.from_file(pf) if pf else None,
        motifs=[tuple(m) for m in motifs] if motifs else None)


def sample_observations(samples, sample_refs, rgs_by_sample, model,
                        threshold_default: float,
                        max_per_kmer: Optional[int] = None, *,
                        device: torch.device = torch.device("cuda")):
    """Pool per-sample k-mer observations, each sample aligned against its
    own edited reference so that modified-base k-mers (e.g. CpG -> E)
    label that sample's rows; per-sample ``probability_threshold`` and
    ``number_of_kmer_assignments`` are honoured (the JAX ``cmd_train``'s
    ``_sample_observations``, ``cli.py:254-280``; trainModels.py:427-520).
    Each sample's reads run through ``run_alignment_batch`` on
    ``device``."""
    merged: Dict[str, np.ndarray] = {}
    for si, sample in enumerate(samples):
        if not rgs_by_sample[si]:
            continue
        results = run_alignment_batch(rgs_by_sample[si], sample_refs[si],
                                      model, AlignmentConfig(), device=device)
        thr = float(sample.get("probability_threshold", threshold_default))
        mpk = max_per_kmer
        if mpk is not None:
            mpk = int(sample.get("number_of_kmer_assignments", mpk))
        obs = collect_kmer_observations(results, model, threshold=thr,
                                        max_per_kmer=mpk)
        for kmer, vals in obs.items():
            merged[kmer] = (np.concatenate([merged[kmer], vals])
                            if kmer in merged else vals)
    return merged


def train_models(cfg: dict, samples, sample_refs, rgs, rgs_by_sample,
                 reference, model: PoreModel, output_dir: str,
                 iterations: int, em_hdp=None, *,
                 device: torch.device = torch.device("cuda"),
                 stage_seconds: Optional[Dict[str, float]] = None) -> Dict:
    """The steps of the CLI's ``train`` once its reads are loaded (the JAX
    ``cmd_train``, ``cli.py:237-317`` and ``:368-373``, without the
    complement strand):
    transitions EM over ``rgs`` (``(read, guide, sample reference)``
    triples) with checkpoints and expectations files in ``output_dir``
    (``training.transitions``, default on; ``em_hdp`` with MODE_HDP for
    ``stateMachineType: threeStateHdp``); then ``normal_emissions``
    (Gaussian updates from each sample's pairs) and ``hdp_emissions``
    (each sample's observations -> ``buildAlignment.tsv`` ->
    ``train_hdp_from_alignment`` -> ``template.nhdp``); finally
    ``template_trained.model``. ``rgs_by_sample[i]`` holds sample i's
    ``(read, guide)`` pairs, aligned against ``sample_refs[i]``.

    Returns {"model", "em" (EMResult or None), "model_path", and where
    written "build_alignment", "nhdp"}. ``stage_seconds``, when given,
    receives the wall seconds of "em", "normal_emissions", "observations"
    (the hdp_emissions alignments), "build_alignment", "gibbs" (the
    trainer and the .nhdp write) and "write"."""
    from signalalign_tpu_torch.hdp.train import train_hdp_from_alignment
    from signalalign_tpu_torch.ops import banded_fb as bfb

    stages: Dict[str, float] = defaultdict(float)
    t_stage = time.perf_counter()

    def mark(stage: str):
        nonlocal t_stage
        now = time.perf_counter()
        stages[stage] += now - t_stage
        t_stage = now

    training = cfg.get("training", {})
    trans_args = cfg.get("transitions_args", {})
    out: Dict = {"em": None}
    os.makedirs(output_dir, exist_ok=True)
    if training.get("transitions", True):
        em_cfg = (AlignmentConfig(emission_mode=bfb.MODE_HDP)
                  if em_hdp is not None else None)
        out["em"] = em_train(
            rgs, reference, model, iterations=iterations, verbose=True,
            config=em_cfg, hdp=em_hdp, update_transitions=True,
            update_emissions=bool(training.get("em_emissions", False)),
            training_bases=(trans_args.get("training_bases")
                            or training.get("training_bases")),
            checkpoint_dir=output_dir, write_expectations=True,
            assert_monotonic=bool(trans_args.get("test", False)),
            device=device)
        model = out["em"].model
        mark("em")
    if training.get("normal_emissions", False):
        obs = sample_observations(samples, sample_refs, rgs_by_sample, model,
                                  0.5, device=device)
        model = train_gaussian_emissions(obs, model)
        mark("normal_emissions")
    if training.get("hdp_emissions", False):
        obs = sample_observations(
            samples, sample_refs, rgs_by_sample, model, 0.8,
            max_per_kmer=int(training.get("max_assignments", 100)),
            device=device)
        mark("observations")
        out["build_alignment"] = write_hdp_training_file(
            obs, os.path.join(output_dir, "buildAlignment.tsv"))
        mark("build_alignment")
        hdp_args = cfg.get("hdp_args", {})
        out["nhdp"] = train_hdp_from_alignment(
            out["build_alignment"], model,
            hdp_type=training.get("hdp_type",
                                  hdp_args.get("hdp_type",
                                               "singleLevelFixed")),
            out_path=os.path.join(output_dir, "template.nhdp"),
            grid_start=float(hdp_args.get("grid_start", 30.0)),
            grid_stop=float(hdp_args.get("grid_end", 180.0)),
            grid_length=int(hdp_args.get("grid_length", 1200)),
            base_gamma=float(hdp_args.get("base_gamma", 1.0)),
            middle_gamma=float(hdp_args.get("middle_gamma", 1.0)),
            leaf_gamma=float(hdp_args.get("leaf_gamma", 1.0)),
            base_alpha=float(hdp_args.get("base_alpha", 1.0)),
            base_beta=float(hdp_args.get("base_beta", 1.0)),
            middle_alpha=float(hdp_args.get("middle_alpha", 1.0)),
            middle_beta=float(hdp_args.get("middle_beta", 1.0)),
            leaf_alpha=float(hdp_args.get("leaf_alpha", 1.0)),
            leaf_beta=float(hdp_args.get("leaf_beta", 1.0)),
            gibbs_samples=int(training.get(
                "gibbs_samples", hdp_args.get("gibbs_samples", 1000))),
            burn_in=int(training.get(
                "burnin_multiplier", hdp_args.get("burnin_multiplier", 32))),
            thinning=int(training.get(
                "thinning", hdp_args.get("thinning", 100))))
        mark("gibbs")
    out["model_path"] = os.path.join(output_dir, "template_trained.model")
    model.likelihood = model.likelihood or 0.0
    model.write(out["model_path"])
    out["model"] = model
    mark("write")
    if stage_seconds is not None:
        stage_seconds.update(stages)
    return out


def train_complement(c_rgs, reference, cmodel: PoreModel, output_dir: str,
                     iterations: int, update_emissions: bool = False, *,
                     device: torch.device = torch.device("cuda")) -> EMResult:
    """The complement strand's EM of the CLI's ``train`` (2D chemistry,
    the JAX ``cmd_train`` at ``cli.py:346-370``): transitions EM over
    ``c_rgs`` (complement strands and their guides,
    ``strand_template=False``) from ``cmodel``, with
    ``complement_trained_<i>`` checkpoints and expectations files and
    ``complement_trained.model`` in ``output_dir``."""
    cres = em_train(
        c_rgs, reference, cmodel, iterations=iterations, verbose=True,
        update_transitions=True, update_emissions=update_emissions,
        checkpoint_dir=output_dir, checkpoint_prefix="complement_trained",
        write_expectations=True, strand_template=False, device=device)
    cres.model.likelihood = cres.model.likelihood or 0.0
    cres.model.write(os.path.join(output_dir, "complement_trained.model"))
    return cres


def collect_kmer_observations(results, model: PoreModel,
                              threshold: float = 0.0,
                              max_per_kmer: Optional[int] = None):
    """(kmer -> descaled event means) from alignment results.

    reference: the buildAlignment table path (CreateHdpTrainingData,
    trainModels.py:427-520): per aligned pair above threshold, the
    descaled event mean keyed by the PATH k-mer; optionally keep the top-N
    highest-probability observations per k-mer
    (generate_top_n_kmers_from_sa_output, build_alignments.py).
    """
    per_kmer: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for r in results:
        p = r.params
        for prob_int, x, y, kmer in r.aligned_pairs:
            prob = prob_int / 10000000.0
            if prob < threshold:
                continue
            idx = model.alphabet.kmer_index(kmer)
            mu = model.level_mean[idx]
            ev = float(r.events[y + r.event_offset, 0])
            descaled = (ev + p.var * mu - p.scale * mu - p.shift) / p.var
            per_kmer[kmer].append((prob, descaled))
    out: Dict[str, np.ndarray] = {}
    for kmer, vals in per_kmer.items():
        vals.sort(key=lambda t: -t[0])
        if max_per_kmer:
            vals = vals[:max_per_kmer]
        out[kmer] = np.array([v for _, v in vals])
    return out


def train_gaussian_emissions(observations: Dict[str, np.ndarray],
                             model: PoreModel,
                             prior_weight: float = 100.0,
                             use_median: bool = False,
                             min_sd: float = 0.0,
                             mod_only: bool = False) -> PoreModel:
    """Per-kmer Gaussian update with an original-model prior.

    reference: train_normal_emmissions (trainModels.py:735-828):
    new_mean = (sum(data) + prior_mean*W) / (n + W), likewise for sd,
    with optional median/MAD estimators and a min-sd floor.
    """
    from scipy.stats import median_abs_deviation

    model = copy.deepcopy(model)
    for kmer, data in observations.items():
        if mod_only and set(kmer) <= set("ACGT"):
            continue
        n = len(data)
        if n == 0:
            continue
        if use_median:
            mean_n = float(np.median(data)) * n
            sd_n = float(median_abs_deviation(data, scale="normal")) * n
        else:
            mean_n = float(np.mean(data)) * n
            sd_n = float(np.std(data)) * n
        idx = model.alphabet.kmer_index(kmer)
        pm = model.level_mean[idx] * prior_weight
        ps = model.level_sd[idx] * prior_weight
        model.level_mean[idx] = (mean_n + pm) / (n + prior_weight)
        model.level_sd[idx] = max((sd_n + ps) / (n + prior_weight), min_sd)
    return model


def write_hdp_training_file(observations: Dict[str, np.ndarray], path: str,
                            strand: str = "t") -> str:
    """buildAlignment.tsv for the HDP Gibbs trainer.

    Format (CreateHdpTrainingData.write_hdp_training_file /
    nanopore_hdp update_nhdp_from_alignment): kmer \t strand \t event_mean.
    """
    with open(path, "w") as fh:
        for kmer, vals in sorted(observations.items()):
            for v in vals:
                fh.write(f"{kmer}\t{strand}\t{v:f}\n")
    return path


def build_alignment_from_tsvs(tsv_paths, model: PoreModel,
                              out_path: str,
                              max_per_kmer: int = 100,
                              min_probability: float = 0.8,
                              strands=("t",),
                              full: bool = True) -> str:
    """Top-N highest-probability observations per k-mer from SA output TSVs.

    reference: build_alignments.py generate_top_n_kmers_from_sa_output
    (heap-nlargest per kmer over full-format rows with prob >= threshold);
    output rows are ``kmer \t strand \t descaled_mean \t prob`` sorted by
    kmer, matching the buildAlignment table consumed by HDP training.
    """
    import heapq
    from collections import defaultdict

    per_kmer = defaultdict(list)
    for path in tsv_paths:
        with open(path) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if full:
                    if len(parts) < 16:
                        continue
                    strand, prob = parts[4], float(parts[12])
                    kmer, descaled = parts[15], float(parts[13])
                else:   # assignments format: kmer strand descaled prob
                    if len(parts) < 4:
                        continue
                    kmer, strand = parts[0], parts[1]
                    descaled, prob = float(parts[2]), float(parts[3])
                if strand not in strands or prob < min_probability:
                    continue
                entry = (prob, descaled, strand)
                bucket = per_kmer[kmer]
                if len(bucket) < max_per_kmer:
                    heapq.heappush(bucket, entry)
                elif entry > bucket[0]:
                    heapq.heapreplace(bucket, entry)
    with open(out_path, "w") as fh:
        for kmer in sorted(per_kmer):
            for prob, descaled, strand in sorted(per_kmer[kmer],
                                                 reverse=True):
                fh.write(f"{kmer}\t{strand}\t{descaled:f}\t{prob:f}\n")
    return out_path
