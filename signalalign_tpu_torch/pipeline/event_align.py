"""Raw-signal to basecalled-event-table initialization ("load_from_raw").

Pipeline (reference: impl/eventAligner.c:1242-1305 load_from_raw2 and
impl/kmerEventAlign.c): raw fast5 signal -> MAD trim -> t-stat event
detection -> method-of-moments scaling -> Suzuki-Kasahara adaptive banded
Viterbi event<->kmer alignment -> basecalled event table (model_state /
move / p_model_state per event) embedded back into the fast5.

The port's copy of ``signalalign_tpu.pipeline.event_align``. The band
fill is data-dependent sequential work and runs in the native library
(csrc/signalalign_native.cpp ``sa_adaptive_banded_align``), with no
Python fallback. ``align_raw_signal`` is ``align_raw_read`` on arrays
(raw current, channel parameters, start time), for hosts without h5py.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np

from signalalign_tpu_torch.io.fast5 import BASECALL_EVENT_COLUMNS, Fast5
from signalalign_tpu_torch.io.read import NanoporeReadData, make_event_map
from signalalign_tpu_torch.models.pore_model import PoreModel, ScalingParams
from signalalign_tpu_torch.ops.event_detect import (detect_events,
                                                    trim_and_segment_raw)
from signalalign_tpu_torch.ops.scaling import estimate_scalings_using_mom
from signalalign_tpu_torch.utils import native
from signalalign_tpu_torch.utils.alphabet import reverse_complement

# QC constants (eventAligner.c:920-921, 1204-1233)
MIN_AVG_LOG_EMISSION = -5.2
MAX_GAP_THRESHOLD = 50
MAX_EVENTS_PER_KMER = 5.0


def read_kmer_ids(seq: str, model: PoreModel, rna: bool) -> np.ndarray:
    """K-mer ranks per read position; RNA k-mers are reversed strings
    (build_kmer_list, eventAligner.c:774-790)."""
    k = model.kmer_length
    seq = seq.replace("U", "T")
    if not rna:
        return model.alphabet.seq_to_kmer_ids(seq)
    n = len(seq) - k + 1
    return np.array([model.alphabet.kmer_index(seq[i:i + k][::-1])
                     for i in range(n)], dtype=np.int64)


def _emission_params(kmer_ids: np.ndarray, model: PoreModel,
                     params: ScalingParams):
    """MeanOnly emission parameters per read position
    (strawMan...WithDescaling_MeanOnly, stateMachine.c:557)."""
    mu = model.level_mean[kmer_ids]
    sd = model.level_sd[kmer_ids]
    m_hat = params.scale * mu + params.shift
    inv = 1.0 / (params.var * sd)
    cst = -0.91893853320467267 - np.log(sd) - math.log(params.var)
    return m_hat, inv, cst


def adaptive_event_align(ev_mean: np.ndarray, kmer_ids: np.ndarray,
                         model: PoreModel, params: ScalingParams):
    """The adaptive banded Viterbi of events against the read's k-mers
    (adaptive_banded_simple_event_align2, eventAligner.c:902-1233) in the
    native library: (kmer_idx, event_idx, qc)."""
    m_hat, inv, cst = _emission_params(kmer_ids, model, params)
    return native.adaptive_banded_align(ev_mean, m_hat, inv, cst)


def qc_passes(qc: np.ndarray) -> Tuple[bool, str]:
    avg, spanned, max_gap, epk = qc
    ok = (avg >= MIN_AVG_LOG_EMISSION and spanned > 0.5
          and max_gap <= MAX_GAP_THRESHOLD and epk <= MAX_EVENTS_PER_KMER)
    msg = (f"avg_emission:{avg:.2f};spanned:{'ok' if spanned > .5 else 'not_ok'};"
           f"max_gap:{int(max_gap)};events_per_kmer:{epk:.2f}")
    return ok, msg


def alignment_to_base_event_map(pairs_k, pairs_e, kmer_ids, ev_mean,
                                model, params, n_events, rna: bool = False):
    """Per-event model_state/move/p_model_state columns from the alignment.

    reference: alignment_to_base_event_map / rna_alignment_to_base_event_map
    (eventAligner.c:1307-1408).
    """
    m_hat, inv, cst = _emission_params(kmer_ids, model, params)
    n_kmers = len(kmer_ids)
    state_idx = np.full(n_events, -1, dtype=np.int64)
    moves = np.zeros(n_events, dtype=np.int64)
    p_model = np.zeros(n_events, dtype=np.float64)

    order = range(len(pairs_k)) if not rna else range(len(pairs_k) - 1, -1, -1)
    prev_event = -1
    prev_kmer = 0 if not rna else n_kmers - 1
    for i in order:
        ki = int(pairs_k[i])
        ei = int(pairs_e[i])
        a = (ev_mean[ei] - m_hat[ki]) * inv[ki]
        lp = cst[ki] - 0.5 * a * a
        delta = (ki - prev_kmer) if not rna else (prev_kmer - ki)
        if ei == prev_event:
            if ki == prev_kmer:
                continue
            if not rna and prev_kmer == 0:
                continue
            p_model[ei] = math.exp(lp)
            state_idx[ei] = ki
            moves[ei] += delta
            prev_kmer, prev_event = ki, ei
        else:
            p_model[ei] = math.exp(lp)
            state_idx[ei] = ki
            moves[ei] = 0 if ki == prev_kmer else delta
            prev_kmer, prev_event = ki, ei
    return state_idx, moves, p_model


@dataclasses.dataclass
class RawAlignResult:
    events: np.ndarray          # (n, 4) mean, stdv, length(s), start(s)-start0
    model_states: np.ndarray    # per-event kmer strings (bytes)
    moves: np.ndarray
    p_model_state: np.ndarray
    params: ScalingParams
    qc: np.ndarray
    qc_ok: bool
    qc_msg: str
    raw_start: np.ndarray
    raw_length: np.ndarray


def align_raw_read(fast5_path: str, model: PoreModel, read_sequence: str,
                   rna: bool = False) -> RawAlignResult:
    """Full load_from_raw pipeline for one read (no fast5 writeback): the
    fast5's raw current, channel parameters and start time through
    ``align_raw_signal``."""
    with Fast5(fast5_path) as f5:
        raw = f5.raw_signal_pA()
        cp = f5.channel_params()
        start_time = f5.start_time()
    return align_raw_signal(raw, cp, start_time, model, read_sequence, rna)


def align_raw_signal(raw: np.ndarray, cp: dict, start_time: float,
                     model: PoreModel, read_sequence: str,
                     rna: bool = False,
                     stage_seconds: Optional[Dict[str, float]] = None
                     ) -> RawAlignResult:
    """``align_raw_read`` on arrays: ``raw`` current in pA, the channel
    parameters ``cp`` (``Fast5.channel_params``: its "sampling_rate" is
    read) and the read's start time in samples. ``stage_seconds``, when
    given, gains the wall seconds of "detect" (trimming and event
    detection) and "adaptive_align" (the rest)."""
    t0 = time.perf_counter()
    trimmed, offset = trim_and_segment_raw(raw, 200, 10, 100, 0.0)
    et = detect_events(trimmed, rna=rna, start_sample=offset)
    if rna:
        et = et[::-1].copy()
    t1 = time.perf_counter()

    kmer_ids = read_kmer_ids(read_sequence, model, rna)
    params = estimate_scalings_using_mom(kmer_ids, model, et[:, 0])
    pairs_k, pairs_e, qc = adaptive_event_align(et[:, 0], kmer_ids, model,
                                                params)
    ok, msg = qc_passes(qc)

    n_events = len(et)
    state_idx, moves, p_model = alignment_to_base_event_map(
        pairs_k, pairs_e, kmer_ids, et[:, 0], model, params, n_events,
        rna=rna)
    if rna:
        state_idx = state_idx[::-1].copy()
        moves = moves[::-1].copy()
        p_model = p_model[::-1].copy()
        et = et[::-1].copy()

    k = model.kmer_length
    seq_t = read_sequence.replace("U", "T")
    kmers = np.array([
        (seq_t[i:i + k] if not rna else seq_t[i:i + k][::-1]).encode()
        if i >= 0 else b"" for i in state_idx], dtype=f"S{k}")

    sample_rate = cp["sampling_rate"]
    starts_sec = et[:, 3] / sample_rate + start_time / sample_rate
    events = np.stack([et[:, 0], et[:, 1], et[:, 2] / sample_rate,
                       starts_sec - starts_sec[0]], axis=1)
    if stage_seconds is not None:
        t2 = time.perf_counter()
        for stage, dt in (("detect", t1 - t0), ("adaptive_align", t2 - t1)):
            stage_seconds[stage] = stage_seconds.get(stage, 0.0) + dt
    return RawAlignResult(
        events=events, model_states=kmers, moves=moves,
        p_model_state=p_model, params=params, qc=qc, qc_ok=ok, qc_msg=msg,
        raw_start=et[:, 3].astype(np.int64),
        raw_length=et[:, 2].astype(np.int64))


def basecall_event_table(result: RawAlignResult) -> np.ndarray:
    """``result`` as a basecaller's event table (``BASECALL_EVENT_COLUMNS``),
    the table ``embed_event_table`` writes."""
    n = len(result.events)
    table = np.zeros(n, dtype=BASECALL_EVENT_COLUMNS)
    table["start"] = result.events[:, 3]
    table["length"] = result.events[:, 2]
    table["mean"] = result.events[:, 0]
    table["stdv"] = result.events[:, 1]
    table["model_state"] = result.model_states
    table["move"] = result.moves
    table["raw_start"] = result.raw_start
    table["raw_length"] = result.raw_length
    table["p_model_state"] = result.p_model_state
    return table


def embed_event_table(fast5_path: str, result: RawAlignResult,
                      fastq: str, analysis_base: str = "SignalAlign_Basecall_1D") -> str:
    """Write the basecalled event table back into the fast5
    (fast5_set_basecall_event_table, eventAligner.c)."""
    table = basecall_event_table(result)
    with Fast5(fast5_path, "r+") as f5:
        return f5.write_event_table(table, fastq, base=analysis_base)


def nanopore_read_from_raw(fast5_path: str, model: PoreModel, sam_record,
                           embed: bool = True):
    """Build a DP-ready NanoporeReadData for a fast5 WITHOUT basecall events.

    reference: NanoporeRead.generate_new_event_table -> load_from_raw2
    (nanoporeRead.py:280-301, event_detection.py:230-330): the nucleotide
    sequence comes from the BAM record (revcomp'd back to read orientation
    for reverse mappings), the event table from raw-signal kmer-event
    alignment, and (optionally) the result is embedded into the fast5.
    """
    seq = sam_record.seq.upper()
    q = sam_record.qual
    if q is None or len(q) == 0:
        qual = "!" * len(seq)
    else:
        qual = "".join(chr(int(v) + 33) for v in q)
    if sam_record.is_reverse:
        seq = reverse_complement(seq)
        qual = qual[::-1]
    with Fast5(fast5_path) as f5:
        rna = f5.is_rna()
        read_id = f5.read_id
    result = align_raw_read(fast5_path, model, seq, rna=rna)
    if not result.qc_ok:
        raise ValueError(f"{fast5_path}: kmer-event alignment QC failed "
                         f"({result.qc_msg})")
    fastq = f"@{read_id}\n{seq}\n+\n{qual}\n"
    analysis = None
    if embed:
        try:
            analysis = embed_event_table(fast5_path, result, fastq)
        except OSError:
            analysis = None  # read-only fast5: keep the in-memory table
    return read_from_raw_result(result, read_id or fast5_path, seq, fastq,
                                model.kmer_length, rna, fast5_path, analysis)


def read_from_raw_result(result: RawAlignResult, read_label: str, seq: str,
                         fastq: Optional[str], kmer_length: int,
                         rna: bool = False, fast5_path: Optional[str] = None,
                         analysis_path: Optional[str] = None
                         ) -> NanoporeReadData:
    """The DP-ready read of a raw alignment ``result`` of the read sequence
    ``seq`` (read orientation): the second half of
    ``nanopore_read_from_raw``, on arrays."""
    stored_read = seq.replace("U", "T")[::-1] if rna else seq
    event_map = make_event_map(result.moves, result.p_model_state,
                               len(stored_read), kmer_length,
                               strict=False)
    return NanoporeReadData(
        read_label=read_label,
        template_read=stored_read,
        events=result.events,
        event_map=event_map,
        model_states=result.model_states,
        p_model_state=result.p_model_state,
        kmer_length=kmer_length,
        params=result.params,
        rna=rna,
        fastq=fastq,
        fast5_path=fast5_path,
        analysis_path=analysis_path,
    )
