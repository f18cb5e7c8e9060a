"""Pore model of the 3-state signal HMM: the port's copy of the parts of
``signalalign_tpu.models.pore_model`` it calls (same fields, same
formulas, the same ``.model`` file format).

``.model`` file (stateMachine3_loadFromFile, stateMachine.c:1440-1540;
hiddenMarkovModel.py:252-340):

* line 0: ``stateNumber \t alphabetSize \t alphabet \t kmerLength``
* line 1: nine transition probabilities (row-major 3x3 over states
  [match, gapX, gapY]) followed by the model likelihood
* line 2: five emission parameters per k-mer, for all ``alphabetSize**k``
  k-mers in lexicographic-rank order:
  ``level_mean level_sd noise_mean noise_sd noise_lambda``

* The gap-Y ("extra event" / stay) emission table is the match table with
  ``level_sd`` multiplied by 1.75 (EXTRA_EVENT_NOISE_MULTIPLIER,
  stateMachine.h:34).
* The transitions used by the state machine are the seven of
  stateMachine3_cellCalculate (stateMachine.c:1306-1368); gapX<->gapY
  switching is log-zero.
* Noise rescaling multiplies noise_mean by scale_sd and noise_lambda by
  var_sd, then recomputes noise_sd = sqrt(mean^3/lambda)
  (emissions_signal_scaleNoise, stateMachine.c).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from signalalign_tpu_torch.utils.alphabet import Alphabet

LOG_ZERO = -np.inf
MODEL_PARAMS = 5
EXTRA_EVENT_NOISE_MULTIPLIER = 1.75

# state indices (reference: enum State, stateMachine.h:50)
MATCH, GAP_X, GAP_Y = 0, 1, 2

# transition slot names within the flat 9-vector (row-major from-state major)
T_MM, T_MX, T_MY = 0, 1, 2
T_XM, T_XX, T_XY = 3, 4, 5
T_YM, T_YX, T_YY = 6, 7, 8


@dataclasses.dataclass
class ScalingParams:
    """Per-read signal normalization parameters (defaults of
    nanopore.c:111-119)."""

    shift: float = 0.0
    scale: float = 1.0
    drift: float = 0.0
    var: float = 1.0
    scale_sd: float = 1.0
    var_sd: float = 1.0
    shift_sd: float = 0.0


class PoreModel:
    """In-memory pore model: emission tables + transition log-probs.

    Arrays:
      * ``level_mean, level_sd, noise_mean, noise_sd, noise_lambda`` —
        (num_kmers,) float64 match-emission parameters.
      * ``gap_y_level_sd`` — level_sd * 1.75 for the stay state.
      * ``log_transitions`` — (9,) float64 (log space); unused slots -inf.
    """

    def __init__(self, alphabet: str, kmer_length: int,
                 transitions: Optional[np.ndarray] = None,
                 likelihood: float = 0.0):
        self.alphabet = Alphabet(alphabet, kmer_length)
        self.kmer_length = int(kmer_length)
        self.num_kmers = self.alphabet.num_kmers
        self.state_number = 3
        self.likelihood = float(likelihood)

        if transitions is None:
            # reference: stateMachine3_setTransitionsToNanoporeDefaults
            # (stateMachine.c:1189-1200) stores these as logs already.
            self.log_transitions = np.full(9, LOG_ZERO)
            self.log_transitions[T_MM] = -0.23552123624314988
            self.log_transitions[T_XM] = -0.21880828092192281
            self.log_transitions[T_YM] = -0.013406326748077823
            self.log_transitions[T_MX] = -1.6269694202638481
            self.log_transitions[T_MY] = -4.3187242127300092
            self.log_transitions[T_XX] = -1.6269694202638481
            self.log_transitions[T_YY] = -4.3187242127239411
            self.transitions = np.exp(self.log_transitions)
        else:
            self.set_transitions(np.asarray(transitions, dtype=np.float64))

        z = np.zeros(self.num_kmers, dtype=np.float64)
        self.level_mean = z.copy()
        self.level_sd = z.copy()
        self.noise_mean = z.copy()
        self.noise_sd = z.copy()
        self.noise_lambda = z.copy()

    def set_transitions(self, probs9: np.ndarray) -> None:
        """Set from probability space (as stored in .model files); the
        gapX->gapY and gapY->gapX slots are forced to log-zero."""
        self.transitions = np.asarray(probs9, dtype=np.float64).copy()
        with np.errstate(divide="ignore"):
            logs = np.log(self.transitions)
        logs[T_XY] = LOG_ZERO
        logs[T_YX] = LOG_ZERO
        self.log_transitions = logs

    @classmethod
    def from_file(cls, path: str) -> "PoreModel":
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path) as fh:
            first = fh.readline()
            if first.startswith("#") or first.startswith("kmer\t"):
                # nanopolish-format table (e.g. the shipped
                # r9.4_450bps.*.template.model files)
                return cls.from_nanopolish_file(path)
            header = first.split()
            if len(header) != 4:
                raise ValueError(f"bad .model header in {path}: {header}")
            state_number, alphabet_size, alphabet, kmer_length = (
                int(header[0]), int(header[1]), header[2], int(header[3]))
            if state_number != 3:
                raise ValueError(f"only 3-state models supported, got {state_number}")
            if alphabet_size != len(alphabet):
                raise ValueError("alphabet size mismatch in model header")

            trans_line = [float(x) for x in fh.readline().split()]
            if len(trans_line) != 10:
                raise ValueError("bad transitions line in .model file")
            model = cls(alphabet, kmer_length,
                        transitions=np.array(trans_line[:9]),
                        likelihood=trans_line[9])

            em = np.array([float(x) for x in fh.readline().split()], dtype=np.float64)
            if em.size != model.num_kmers * MODEL_PARAMS:
                raise ValueError(
                    f"bad emissions line: got {em.size} values, want "
                    f"{model.num_kmers * MODEL_PARAMS}")
            em = em.reshape(model.num_kmers, MODEL_PARAMS)
            model.level_mean = em[:, 0].copy()
            model.level_sd = em[:, 1].copy()
            model.noise_mean = em[:, 2].copy()
            model.noise_sd = em[:, 3].copy()
            model.noise_lambda = em[:, 4].copy()
        return model

    @classmethod
    def from_nanopolish_file(cls, path: str,
                             transitions: Optional[np.ndarray] = None) -> "PoreModel":
        """Load a nanopolish-format model table ('#'-prefixed headers then
        ``kmer level_mean level_stdv sd_mean sd_stdv [weight]`` rows);
        noise_lambda is mean^3/sd^2 (hiddenMarkovModel.py:1158-1223)."""
        kmers, rows = [], []
        with open(path) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if not parts or parts[1] == "level_mean":
                    continue
                kmers.append(parts[0])
                rows.append([float(x) for x in parts[1:5]])
        k = len(kmers[0])
        alphabet = "".join(sorted(set("".join(kmers))))
        model = cls(alphabet, k, transitions=transitions)
        data = np.asarray(rows, dtype=np.float64)
        idx = np.array([model.alphabet.kmer_index(km) for km in kmers])
        model.level_mean[idx] = data[:, 0]
        model.level_sd[idx] = data[:, 1]
        model.noise_mean[idx] = data[:, 2]
        model.noise_sd[idx] = data[:, 3]
        model.noise_lambda[idx] = data[:, 2] ** 3 / data[:, 3] ** 2
        return model

    def write(self, path: str) -> None:
        """Write in reference .model format (hiddenMarkovModel.py:304-340)."""
        with open(path, "w") as f:
            f.write(f"{self.state_number}\t{self.alphabet.size}\t"
                    f"{self.alphabet.letters}\t{self.kmer_length}\n")
            f.write("\t".join(str(t) for t in self.transitions))
            f.write(f"\t{self.likelihood}\n")
            em = np.stack([self.level_mean, self.level_sd, self.noise_mean,
                           self.noise_sd, self.noise_lambda], axis=1).reshape(-1)
            f.write("\t".join(str(v) for v in em))
            f.write("\t\n")

    @property
    def gap_y_level_sd(self) -> np.ndarray:
        return self.level_sd * EXTRA_EVENT_NOISE_MULTIPLIER

    def scaled_noise_tables(self, params: ScalingParams):
        """Per-read noise rescaling, returning new (mean, sd, lambda)."""
        nm = self.noise_mean * params.scale_sd
        nl = self.noise_lambda * params.var_sd
        ns = np.sqrt(nm ** 3 / nl)
        return nm, ns, nl
