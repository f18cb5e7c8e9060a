"""Embed signalAlign output back into fast5 files + read it out again.

reference: SignalAlignment.embed_file (signalAlignment.py:509-566) writes
the full-output rows (with per-event raw coordinates) plus MEA labels and
the guide SAM under /Analyses/SignalAlign_NNN; alignedsignal.CreateLabels
(alignedsignal.py:159-343) reads them back as signal-space labels. The
port's copy of ``signalalign_tpu.io.embed``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from signalalign_tpu_torch.io.fast5 import Fast5
from signalalign_tpu_torch.io.output import FullRow
from signalalign_tpu_torch.pipeline.mea import mea_align

SA_FULL_DTYPE = [
    ("contig", "S100"), ("reference_index", "<i8"), ("reference_kmer", "S10"),
    ("strand", "S1"), ("event_index", "<i8"), ("event_mean", "<f8"),
    ("event_noise", "<f8"), ("event_duration", "<f8"),
    ("aligned_kmer", "S10"), ("scaled_mean_current", "<f8"),
    ("scaled_noise", "<f8"), ("posterior_probability", "<f8"),
    ("descaled_event_mean", "<f8"), ("ont_model_mean", "<f8"),
    ("path_kmer", "S10"),
]

LABEL_DTYPE = [("raw_start", int), ("raw_length", int),
               ("reference_index", int), ("posterior_probability", float),
               ("kmer", "S10")]


def full_rows_to_table(rows: Sequence[FullRow]) -> np.ndarray:
    """FullRow list -> the structured array layout the reference embeds
    (get_events_from_path dtype, mea_algorithm.py:351-358)."""
    out = np.zeros(len(rows), dtype=SA_FULL_DTYPE)
    for i, r in enumerate(rows):
        out[i] = (r.contig.encode(), r.reference_index,
                  r.reference_kmer.encode(), r.strand.encode(),
                  r.event_index, r.event_mean, r.event_noise,
                  r.event_duration, r.aligned_kmer.encode(),
                  r.scaled_mean_current, r.scaled_noise,
                  r.posterior_probability, r.descaled_event_mean,
                  r.ont_model_mean, r.path_kmer.encode())
    return out


def event_raw_coords(events: np.ndarray, sample_rate: float = 4000.0,
                     raw_offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(raw_start, raw_length) per event row.

    Re-segmented tables carry raw coordinates directly; basecall tables in
    the time scale are converted via the channel sampling rate."""
    names = events.dtype.names
    if "raw_start" in names:
        return (np.asarray(events["raw_start"], dtype=np.int64),
                np.asarray(events["raw_length"], dtype=np.int64))
    start = np.asarray(events["start"], dtype=np.float64)
    length = np.asarray(events["length"], dtype=np.float64)
    rs = np.rint(start * sample_rate).astype(np.int64) - raw_offset
    rl = np.rint(length * sample_rate).astype(np.int64)
    return rs, rl


def add_raw_fields(sa: np.ndarray, template_events: np.ndarray,
                   complement_events: Optional[np.ndarray] = None,
                   sample_rate: float = 4000.0) -> np.ndarray:
    """Join per-event raw coordinates onto the signalAlign rows
    (add_events_to_signalalign, mea_algorithm.py:372-392)."""
    dtype = sa.dtype.descr + [("raw_start", "<i8"), ("raw_length", "<i8")]
    out = np.zeros(len(sa), dtype=dtype)
    for name in sa.dtype.names:
        out[name] = sa[name]
    t_rs, t_rl = event_raw_coords(template_events, sample_rate)
    tmask = sa["strand"] == b"t"
    idx = sa["event_index"][tmask]
    out["raw_start"][tmask] = t_rs[idx]
    out["raw_length"][tmask] = t_rl[idx]
    if complement_events is not None:
        c_rs, c_rl = event_raw_coords(complement_events, sample_rate)
        cmask = sa["strand"] == b"c"
        idx = sa["event_index"][cmask]
        out["raw_start"][cmask] = c_rs[idx]
        out["raw_length"][cmask] = c_rl[idx]
    return out


def mea_labels_from_events(sa_with_raw: np.ndarray) -> np.ndarray:
    """MEA-decode one strand's rows -> label table
    (mea_alignment_from_signal_align + create_label_from_events,
    mea_algorithm.py:323-420). Reference positions are shifted to a dense
    0-based frame for the DP then restored."""
    if len(sa_with_raw) == 0:
        return np.zeros(0, dtype=LABEL_DTYPE)
    refs = np.asarray(sa_with_raw["reference_index"], dtype=np.int64)
    evs = np.asarray(sa_with_raw["event_index"], dtype=np.int64)
    post = np.asarray(sa_with_raw["posterior_probability"], dtype=np.float64)
    ref0, ev0 = refs.min(), evs.min()
    # backward-mapped reads have descending reference vs event order; MEA
    # runs in the DP frame where both ascend
    descending = refs[np.argsort(evs)][0] > refs[np.argsort(evs)][-1]
    dp_refs = (refs.max() - refs) if descending else (refs - ref0)
    pairs = list(zip(dp_refs.tolist(), (evs - ev0).tolist(), post.tolist()))
    path = mea_align(pairs)
    chosen = {(r, e) for r, e, _ in path}
    keep = np.array([(int(r), int(e)) in chosen
                     for r, e in zip(dp_refs, evs - ev0)], dtype=bool)
    sel = sa_with_raw[keep]
    label = np.zeros(len(sel), dtype=LABEL_DTYPE)
    label["raw_start"] = sel["raw_start"]
    label["raw_length"] = sel["raw_length"]
    label["reference_index"] = sel["reference_index"]
    label["posterior_probability"] = sel["posterior_probability"]
    label["kmer"] = sel["path_kmer"]
    label.sort(order="raw_start", kind="mergesort")
    return label


def embed_alignment(fast5_path: str, full_rows: Sequence[FullRow],
                    template_events: np.ndarray,
                    complement_events: Optional[np.ndarray] = None,
                    vc_rows: Optional[Sequence[Tuple]] = None,
                    sam_string: Optional[str] = None,
                    sample_rate: float = 4000.0,
                    basecall_events_path: Optional[str] = None) -> str:
    """Write alignment output into /Analyses/SignalAlign_NNN.

    Layout matches SignalAlignment.embed_file: `full` (rows + raw coords),
    `MEA_alignment_labels[_complement]`, optional `variantCaller` and `sam`.
    Returns the created analysis path."""
    sa = full_rows_to_table(full_rows)
    sa = add_raw_fields(sa, template_events, complement_events, sample_rate)
    with Fast5(fast5_path, "r+") as f5:
        path = f5.next_analysis_path("SignalAlign")
        f5.fh.create_dataset(f"{path}/full", data=sa)
        t_rows = sa[sa["strand"] == b"t"]
        f5.fh.create_dataset(f"{path}/MEA_alignment_labels",
                             data=mea_labels_from_events(t_rows))
        c_rows = sa[sa["strand"] == b"c"]
        if len(c_rows):
            f5.fh.create_dataset(f"{path}/MEA_alignment_labels_complement",
                                 data=mea_labels_from_events(c_rows))
        if vc_rows is not None:
            vc_dtype = [("event_index", "<i8"), ("reference_position", "<i8"),
                        ("base", "S1"), ("posterior_probability", "<f8"),
                        ("strand", "S1"), ("forward_mapped", "S8"),
                        ("read_name", "S100")]
            vc = np.zeros(len(vc_rows), dtype=vc_dtype)
            for i, r in enumerate(vc_rows):
                vc[i] = (r[0], r[1], r[2].encode(), r[3], r[4].encode(),
                         r[5].encode(), r[6].encode())
            f5.fh.create_dataset(f"{path}/variantCaller", data=vc)
        if sam_string is not None:
            f5.fh.create_dataset(f"{path}/sam", data=np.bytes_(sam_string))
        if basecall_events_path:
            f5.fh[path].attrs["basecall_events"] = \
                np.bytes_(basecall_events_path)
    return path


def read_signalalign_events(fast5_path: str,
                            number: Optional[int] = None) -> np.ndarray:
    """Load embedded rows back (Fast5.get_signalalign_events equivalent,
    used by alignedsignal.CreateLabels.add_signal_align_predictions)."""
    with Fast5(fast5_path) as f5:
        if number is not None:
            path = f"Analyses/SignalAlign_{number:03d}"
        else:
            path = f5.latest_analysis("SignalAlign")
            if path is None:
                n = -1
                for name in f5.fh.get("Analyses", {}):
                    if name.startswith("SignalAlign_"):
                        n = max(n, int(name.rsplit("_", 1)[1]))
                if n < 0:
                    raise ValueError(f"{fast5_path}: no SignalAlign analysis")
                path = f"Analyses/SignalAlign_{n:03d}"
        return np.asarray(f5.fh[f"{path}/full"][()])


def read_mea_labels(fast5_path: str, complement: bool = False,
                    number: Optional[int] = None) -> np.ndarray:
    with Fast5(fast5_path) as f5:
        n = number
        if n is None:
            ns = [int(name.rsplit("_", 1)[1])
                  for name in f5.fh.get("Analyses", {})
                  if name.startswith("SignalAlign_")]
            if not ns:
                raise ValueError(f"{fast5_path}: no SignalAlign analysis")
            n = max(ns)
        suffix = "_complement" if complement else ""
        return np.asarray(
            f5.fh[f"Analyses/SignalAlign_{n:03d}/MEA_alignment_labels"
                  f"{suffix}"][()])


class CreateLabels:
    """Signal-space label accessor over an embedded fast5.

    reference: alignedsignal.CreateLabels (alignedsignal.py:159-343) — load
    SignalAlign predictions / MEA labels / basecall-guide labels for one
    read, keyed to raw-signal coordinates, for validation and plotting.
    """

    def __init__(self, fast5_path: str):
        self.fast5_path = fast5_path
        self.labels: dict = {}
        with Fast5(fast5_path) as f5:
            self.read_id = f5.read_id
            try:
                self.raw_signal = f5.raw_signal_pA()
            except Exception:
                self.raw_signal = None

    def add_signal_align_predictions(self, number: Optional[int] = None
                                     ) -> np.ndarray:
        ev = read_signalalign_events(self.fast5_path, number=number)
        self.labels["signalalign_full"] = ev
        return ev

    def add_mea_labels(self, number: Optional[int] = None,
                       complement: bool = False) -> np.ndarray:
        lab = read_mea_labels(self.fast5_path, complement=complement,
                              number=number)
        key = "mea_complement" if complement else "mea"
        self.labels[key] = lab
        return lab

    def add_basecall_alignment_prediction(self, read, guide) -> np.ndarray:
        """Per-event guide-alignment labels (raw_start, ref position) from
        the basecall event map + guide CIGAR: not ported yet, since it
        needs ``pipeline.validate`` (ROADMAP §1 item 6)."""
        raise NotImplementedError(
            "CreateLabels.add_basecall_alignment_prediction needs "
            "pipeline.validate, which is not ported yet (ROADMAP §1 item 6)")
