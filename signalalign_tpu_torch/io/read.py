"""In-memory nanopore read container: the port's copy of
``signalalign_tpu.io.read.NanoporeReadData`` (the reference's NanoporeRead,
src/signalalign/nanoporeRead.py, without the file round-trip). The port
aligns reads held in memory; reading fast5 files is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from signalalign_tpu_torch.models.pore_model import ScalingParams


@dataclasses.dataclass
class NanoporeReadData:
    """Everything the aligner needs for one 1D read strand."""
    read_label: str
    template_read: str                 # RNA reads already reversed + U->T
    events: np.ndarray                 # (n, 4): mean, stdv, length, start-start0
    event_map: np.ndarray              # (len(template_read),) event index per base
    model_states: Optional[np.ndarray]  # per-event kmer strings (bytes)
    p_model_state: Optional[np.ndarray]
    kmer_length: int
    params: ScalingParams
    rna: bool = False
    fastq: Optional[str] = None
    fast5_path: Optional[str] = None
    # 2D strands: scaling-parameter estimation runs on the 1D strand read +
    # strand event map (signalUtils_templateOneDAssignmentsFromRead,
    # signalMachineUtils.c:172-184)
    assign_read: Optional[str] = None
    assign_event_map: Optional[np.ndarray] = None
    analysis_path: Optional[str] = None

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def read_length(self) -> int:
        return len(self.template_read)
