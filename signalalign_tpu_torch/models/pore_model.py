"""Pore model of the 3-state signal HMM: the port's copy of the parts of
``signalalign_tpu.models.pore_model`` it calls (same fields, same
formulas).

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
from typing import Optional

import numpy as np

from signalalign_tpu_torch.utils.alphabet import Alphabet

LOG_ZERO = -np.inf
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

    @property
    def gap_y_level_sd(self) -> np.ndarray:
        return self.level_sd * EXTRA_EVENT_NOISE_MULTIPLIER

    def scaled_noise_tables(self, params: ScalingParams):
        """Per-read noise rescaling, returning new (mean, sd, lambda)."""
        nm = self.noise_mean * params.scale_sd
        nl = self.noise_lambda * params.var_sd
        ns = np.sqrt(nm ** 3 / nl)
        return nm, ns, nl
