"""In-memory nanopore read container and its 1D fast5 reader: the port's
copy of ``NanoporeReadData``, ``make_event_map``, ``sequence_from_events``
and ``mean_fastq_quality`` of ``signalalign_tpu.io.read`` (the reference's
NanoporeRead, src/signalalign/nanoporeRead.py + impl/nanopore.c, without
the .npRead file round-trip). 2D reads are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from signalalign_tpu_torch.io.fast5 import Fast5
from signalalign_tpu_torch.models.pore_model import ScalingParams


def make_event_map(moves: np.ndarray, p_model_state: np.ndarray,
                   n_bases: int, kmer_length: int) -> np.ndarray:
    """Per-base index of the event whose model_state covers that base.

    reference: NanoporeRead.make_event_map (nanoporeRead.py:314-333): walk
    events; move==1 appends the event, move>m repeats the previous event for
    skipped bases then appends, move==0 replaces the last entry if its
    p_model_state improves. The map is padded with the final event for the
    trailing k-1 bases and has exactly one entry per read base.
    """
    event_map = [0]
    previous_prob = 0.0
    for i in range(1, len(moves)):
        move = int(moves[i])
        this_prob = float(p_model_state[i])
        if move == 1:
            event_map.append(i)
        elif move > 1:
            for _ in range(move - 1):
                event_map.append(i - 1)
            event_map.append(i)
        elif move == 0:
            if this_prob > previous_prob:
                event_map[-1] = i
        previous_prob = this_prob
    event_map.extend([event_map[-1]] * (kmer_length - 1))
    out = np.asarray(event_map, dtype=np.int64)
    if len(out) != n_bases:
        raise ValueError(
            f"event map length {len(out)} != read length {n_bases}")
    return out


def sequence_from_events(model_states: np.ndarray, moves: np.ndarray) -> str:
    """Reconstruct the read from an event table.

    reference: NanoporeRead.sequence_from_events (nanoporeRead.py:348-360).
    """
    bases: List[str] = []
    for i in range(len(moves)):
        state = model_states[i]
        state = state.decode() if isinstance(state, bytes) else str(state)
        if i == 0:
            bases.extend(state)
        else:
            move = int(moves[i])
            if move > 0:
                bases.append(state[-move:])
    return "".join(bases)


def mean_fastq_quality(fastq: str) -> float:
    lines = fastq.strip("\n").split("\n")
    if len(lines) < 4:
        return 0.0
    quals = np.frombuffer(lines[3].encode("latin-1"), dtype=np.uint8)
    return float(np.mean(quals - 33)) if len(quals) else 0.0


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

    @classmethod
    def from_fast5(cls, path: str, quality_threshold: Optional[float] = 7.0
                   ) -> "NanoporeReadData":
        """Load from an already-basecalled fast5.

        Mirrors NanoporeRead._initialize (nanoporeRead.py:180-278): find the
        newest basecall analysis with events, read fastq (quality filter),
        apply RNA transforms, build the strand event map.
        """
        with Fast5(path) as f5:
            rna = f5.is_rna()
            analysis = f5.latest_analysis()
            if analysis is None:
                raise ValueError(f"{path}: no basecall events; run kmer-event "
                                 "alignment first")
            events = f5.template_events(analysis)
            if rna and events is not None and \
                    np.issubdtype(events["start"].dtype, np.integer):
                # RNA basecall tables in index scale are unusable
                # (has_valid_event_table_format, nanoporeRead.py:298-311);
                # the reference regenerates them with kmer-event alignment.
                # Prefer an already-embedded re-segmented table.
                resegment = f5.latest_analysis("ReSegmentBasecall")
                if resegment is None:
                    raise ValueError(
                        f"{path}: RNA basecall events are index-scale; run "
                        "kmer-event alignment first")
                analysis = resegment
                events = f5.template_events(analysis)
            fastq = f5.template_fastq(analysis)
            if fastq is None:
                raise ValueError(f"{path}: basecall analysis missing fastq")
            qual_line = fastq.split("\n")[3] if fastq.count("\n") >= 3 else ""
            if quality_threshold is not None and \
                    qual_line.strip("!"):  # all-'!' = placeholder qualities
                q = mean_fastq_quality(fastq)
                if q < quality_threshold:
                    raise ValueError(f"{path}: mean fastq quality {q:.2f} < "
                                     f"{quality_threshold}")
            read = fastq.split("\n")[1]
            if rna:
                read = read.replace("U", "T")[::-1]

            kmer_length = len(events["model_state"][0]) if len(events) else 0
            if kmer_length <= 0 or len(read) == 0:
                raise ValueError(f"{path}: empty events or read")

            event_map = make_event_map(events["move"], events["p_model_state"],
                                       len(read), kmer_length)

            start0 = float(events["start"][0])
            ev = np.stack([
                np.asarray(events["mean"], dtype=np.float64),
                np.asarray(events["stdv"], dtype=np.float64),
                np.asarray(events["length"], dtype=np.float64),
                np.asarray(events["start"], dtype=np.float64) - start0,
            ], axis=1)

            model_attrs = f5.template_model_attrs(analysis)
            params = ScalingParams()
            if model_attrs:
                for k, v in model_attrs.items():
                    setattr(params, k, v)

            return cls(
                read_label=f5.read_id or path,
                template_read=read,
                events=ev,
                event_map=event_map,
                model_states=np.asarray(events["model_state"]),
                p_model_state=np.asarray(events["p_model_state"], dtype=np.float64),
                kmer_length=kmer_length,
                params=params,
                rna=rna,
                fastq=fastq,
                fast5_path=path,
                analysis_path=analysis,
            )
