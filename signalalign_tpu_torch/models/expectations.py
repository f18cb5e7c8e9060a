"""The reference's expectations-file format: the port's copy of
``emission_slots_from_kexp``, ``ExpectationsAccumulator`` and
``write_expectations_file`` from ``signalalign_tpu.models.expectations``
(same formats, same formulas).

reference: hiddenMarkovModel.py add_expectations_file:424-486,
normalize:488-517; the files are produced per read by signalMachine
(hmmContinuous_writeToFile, impl/continuousHmm.c) and summed by
trainModels.

ContinuousPairHmm format (6 lines, continuousHmm.c:353-407):
  0: stateNumber \t alphabetSize \t alphabet \t kmerLength
  1: 9 transition expectations + likelihood
  2: event model (5 params per kmer)
  3: event expectations [mean, sd] per kmer
  4: posteriors (1 per kmer)
  5: observed (1 per kmer)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from signalalign_tpu_torch.models.pore_model import PoreModel


def emission_slots_from_kexp(kexp: np.ndarray, level_mean: np.ndarray):
    """Convert the centred per-kmer moments of the expectation pass into
    the reference expectations-file slots.

    kexp rows: [Σp, Σp·dx, Σp·dx²] with dx = descaled_mean − µ_model.
    Returns (mean_expectations = Σp·x, sd_expectations = Σp·(x−µ̂)² with µ̂
    the batch mean, posteriors = Σp, observed). The reference accumulates
    sd around a running mean (continuousHmm.c:159-168), which is
    order-dependent; the batch-centred sum of squared deviations is its
    well-defined limit and what HmmModel.normalize
    (hiddenMarkovModel.py:488-517) divides by Σp.
    """
    kexp = np.asarray(kexp, dtype=np.float64)
    sp, sdx, sdx2 = kexp[0], kexp[1], kexp[2]
    # threshold well above the expectations-file resolution (9 decimal
    # places) so the in-memory M-step and a file round-trip agree exactly
    observed = sp > 1e-6
    sp = np.where(observed, sp, 0.0)
    safe = np.maximum(sp, 1e-300)
    mean_expectations = np.where(observed, sp * level_mean + sdx, 0.0)
    sd_expectations = np.where(observed,
                               np.maximum(sdx2 - sdx * sdx / safe, 0.0), 0.0)
    sd_expectations = np.where(sd_expectations > 1e-8, sd_expectations, 0.0)
    return mean_expectations, sd_expectations, sp, observed


class ExpectationsAccumulator:
    """Sum expectations files and apply the M-step to a model."""

    def __init__(self, model: PoreModel):
        self.model = model
        K = model.alphabet.num_kmers
        self.transitions_expectations = np.zeros(9)
        self.likelihood = 0.0
        self.mean_expectations = np.zeros(K)
        self.sd_expectations = np.zeros(K)
        self.posteriors = np.zeros(K)
        self.observed = np.zeros(K, dtype=bool)
        self.n_files = 0

    def add_file(self, path: str) -> bool:
        model = self.model
        K = model.alphabet.num_kmers
        if not os.path.exists(path) or os.stat(path).st_size == 0:
            return False
        with open(path) as fh:
            header = fh.readline().split()
            assert int(header[0]) == 3, f"{path}: bad state number"
            assert int(header[1]) == model.alphabet.size, \
                f"{path}: alphabet size mismatch"
            assert header[2] == model.alphabet.letters
            assert int(header[3]) == model.kmer_length
            line = list(map(float, fh.readline().split()))
            assert len(line) == 10, f"{path}: bad transitions line"
            self.likelihood += line[-1]
            self.transitions_expectations += np.asarray(line[:9])
            line = list(map(float, fh.readline().split()))
            assert len(line) == K * 5, f"{path}: bad event model line"
            line = np.asarray(list(map(float, fh.readline().split())))
            assert len(line) == K * 2, f"{path}: bad event expectations"
            self.mean_expectations += line[0::2]
            self.sd_expectations += line[1::2]
            line = np.asarray(list(map(float, fh.readline().split())))
            assert len(line) == K, f"{path}: bad posteriors line"
            self.posteriors += line
            line = np.asarray(list(map(float, fh.readline().split())))
            assert len(line) == K, f"{path}: bad observed line"
            self.observed |= line.astype(bool)
        self.n_files += 1
        return True

    def normalize_transitions(self) -> np.ndarray:
        t = self.transitions_expectations.reshape(3, 3)
        t = t / np.maximum(t.sum(axis=1, keepdims=True), 1e-300)
        self.transitions_expectations = t.reshape(-1)
        return t

    def apply(self, update_transitions: bool = True,
              update_emissions: bool = False) -> PoreModel:
        """M-step onto the model (HmmModel.normalize semantics)."""
        model = self.model
        if update_transitions:
            self.normalize_transitions()
            model.set_transitions(self.transitions_expectations)
        if update_emissions:
            ok = self.observed & (self.posteriors > 0)
            u = np.where(ok, self.mean_expectations
                         / np.maximum(self.posteriors, 1e-300), 0.0)
            o = np.sqrt(np.where(ok, self.sd_expectations
                                 / np.maximum(self.posteriors, 1e-300), 0.0))
            upd = ok & (u > 0)
            model.level_mean = np.where(upd, u, model.level_mean)
            # keep the old sd for degenerate (single-event) kmers rather
            # than collapsing the pdf (reference normalize would write 0)
            model.level_sd = np.where(upd & (o > 0), o, model.level_sd)
        model.likelihood = self.likelihood
        return model


def write_expectations_file(path: str, model: PoreModel,
                            transition_expectations: np.ndarray,
                            likelihood: float,
                            mean_expectations: Optional[np.ndarray] = None,
                            sd_expectations: Optional[np.ndarray] = None,
                            posteriors: Optional[np.ndarray] = None,
                            observed: Optional[np.ndarray] = None) -> str:
    """Emit one read's (or batch's) expectations in the reference layout."""
    K = model.alphabet.num_kmers
    mean_expectations = np.zeros(K) if mean_expectations is None \
        else mean_expectations
    sd_expectations = np.zeros(K) if sd_expectations is None \
        else sd_expectations
    posteriors = np.zeros(K) if posteriors is None else posteriors
    observed = np.zeros(K, dtype=bool) if observed is None else observed
    t = np.asarray(transition_expectations).reshape(-1)
    with open(path, "w") as fh:
        fh.write(f"3\t{model.alphabet.size}\t{model.alphabet.letters}\t"
                 f"{model.kmer_length}\n")
        fh.write("\t".join(f"{v:.9f}" for v in t)
                 + f"\t{likelihood:.9f}\n")
        ev = np.stack([model.level_mean, model.level_sd, model.noise_mean,
                       model.noise_sd, model.noise_lambda], axis=1)
        fh.write("\t".join(f"{v:.9f}" for v in ev.reshape(-1)) + "\n")
        me = np.stack([mean_expectations, sd_expectations], axis=1)
        fh.write("\t".join(f"{v:.9f}" for v in me.reshape(-1)) + "\n")
        fh.write("\t".join(f"{v:.9f}" for v in posteriors) + "\n")
        fh.write("\t".join(str(int(v)) for v in observed) + "\n")
    return path
