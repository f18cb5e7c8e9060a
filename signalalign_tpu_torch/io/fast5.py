"""Fast5 (HDF5) access: raw signal, channel scaling, basecall tables, and
the writers of generated event tables and analyses. The port's copy of
``signalalign_tpu.io.fast5`` (same paths, same formulas).

reference: src/signalalign/fast5.py (h5py path management) and the C HDF5
getters in impl/eventAligner.c:100-790.

h5py is imported when a file is opened, not with this module: the port
imports and aligns reads held in memory on hosts without it, and
``Fast5(path)`` raises ImportError naming h5py there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

ANALYSES = "Analyses"
RAW_READS = "Raw/Reads"
CHANNEL_ID = "UniqueGlobalKey/channel_id"
CONTEXT_TAGS = "UniqueGlobalKey/context_tags"

BASECALL_EVENT_COLUMNS = [
    ("start", "<f8"), ("length", "<f8"), ("mean", "<f8"), ("stdv", "<f8"),
    ("model_state", "S6"), ("move", "<i4"), ("raw_start", "<i8"),
    ("raw_length", "<i8"), ("p_model_state", "<f8"),
]


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


def import_h5py():
    """The h5py module, or ImportError saying that fast5 input needs it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("reading fast5 files needs h5py, which is not "
                          "installed") from exc
    return h5py


def adc_to_pA(adc: np.ndarray, cp: dict) -> np.ndarray:
    """ADC samples in picoamps under the channel parameters ``cp``
    (``Fast5.channel_params``): (adc + offset) * range / digitisation."""
    adc = np.asarray(adc, dtype=np.float32)
    return (adc + cp["offset"]) * (cp["range"] / cp["digitisation"])


class Fast5:
    """Wrapper over one fast5 file, opened in h5py's ``mode`` ("r", or
    "r+" to write)."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.fh = import_h5py().File(path, mode)

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------------- metadata

    @property
    def read_group(self) -> Optional[str]:
        try:
            reads = list(self.fh[RAW_READS])
            if reads:
                return f"{RAW_READS}/{reads[0]}"
        except KeyError:
            pass
        # pre-Raw fast5s (R7.3 era) keep read metadata under the
        # EventDetection analysis (nanoporeRead.py READS_KEY fallback)
        if ANALYSES in self.fh:
            for name in sorted(self.fh[ANALYSES]):
                path = f"{ANALYSES}/{name}/Reads"
                if name.startswith("EventDetection") and path in self.fh:
                    reads = list(self.fh[path])
                    if reads:
                        return f"{path}/{reads[0]}"
        return None

    @property
    def read_id(self) -> Optional[str]:
        grp = self.read_group
        if grp is None:
            return None
        return _decode(self.fh[grp].attrs.get("read_id"))

    def is_rna(self) -> bool:
        """reference: NanoporeRead.is_read_rna (nanoporeRead.py:545-573)."""
        exp_type = exp_kit = None
        try:
            exp_type = _decode(self.fh[CONTEXT_TAGS].attrs["experiment_type"]).replace("internal", "")
        except KeyError:
            pass
        try:
            exp_kit = _decode(self.fh[CONTEXT_TAGS].attrs["experiment_kit"]).replace("internal", "")
        except KeyError:
            pass
        return bool((exp_type and "rna" in exp_type) or (exp_kit and "rna" in exp_kit))

    # ------------------------------------------------------------ raw signal

    def channel_params(self) -> dict:
        a = self.fh[CHANNEL_ID].attrs
        return {
            "digitisation": float(a["digitisation"]),
            "offset": float(a["offset"]),
            "range": float(a["range"]),
            "sampling_rate": float(a["sampling_rate"]),
        }

    def raw_signal_pA(self) -> np.ndarray:
        """Raw current in picoamps: (adc + offset) * range / digitisation.

        reference: fast5_get_raw_samples (eventAligner.c).
        """
        grp = self.read_group
        if grp is None:
            raise KeyError("no raw reads in " + self.path)
        return adc_to_pA(self.fh[f"{grp}/Signal"][()], self.channel_params())

    def start_time(self) -> float:
        grp = self.read_group
        return float(self.fh[grp].attrs.get("start_time", 0.0))

    # ----------------------------------------------------------- basecalls

    def latest_analysis(self, base: str = "Basecall_1D") -> Optional[str]:
        """Highest-numbered /Analyses/<base>_NNN containing template events.

        reference: NanoporeRead.get_latest_basecall_edition.
        """
        if ANALYSES not in self.fh:
            return None
        best = None
        for name in self.fh[ANALYSES]:
            if name.startswith(base + "_"):
                path = f"{ANALYSES}/{name}"
                if f"{path}/BaseCalled_template/Events" in self.fh:
                    if best is None or name > best:
                        best = name
        return f"{ANALYSES}/{best}" if best else None

    def template_events(self, analysis: Optional[str] = None) -> Optional[np.ndarray]:
        analysis = analysis or self.latest_analysis()
        if analysis is None:
            return None
        addr = f"{analysis}/BaseCalled_template/Events"
        if addr not in self.fh:
            return None
        return np.asarray(self.fh[addr][()])

    def template_fastq(self, analysis: Optional[str] = None) -> Optional[str]:
        analysis = analysis or self.latest_analysis()
        if analysis is None:
            return None
        addr = f"{analysis}/BaseCalled_template/Fastq"
        if addr not in self.fh:
            return None
        return _decode(self.fh[addr][()])

    def template_model_attrs(self, analysis: Optional[str] = None) -> Optional[dict]:
        """Per-read scaling attrs if a basecaller Model group exists."""
        analysis = analysis or self.latest_analysis()
        if analysis is None:
            return None
        addr = f"{analysis}/BaseCalled_template/Model"
        if addr not in self.fh:
            return None
        a = self.fh[addr].attrs
        return {k: float(a[k]) for k in
                ("scale", "shift", "drift", "var", "scale_sd", "var_sd")
                if k in a}

    # -------------------------------------------------------------- writing

    def next_analysis_path(self, base: str) -> str:
        n = 0
        while f"{ANALYSES}/{base}_{n:03d}" in self.fh:
            n += 1
        return f"{ANALYSES}/{base}_{n:03d}"

    def write_event_table(self, events: np.ndarray, fastq: str,
                          base: str = "SignalAlign_Basecall_1D") -> str:
        """Embed a basecalled event table + fastq (load_from_raw output).

        reference: fast5_set_basecall_event_table (eventAligner.c).
        """
        path = self.next_analysis_path(base)
        self.fh.create_dataset(f"{path}/BaseCalled_template/Events", data=events)
        self.fh.create_dataset(f"{path}/BaseCalled_template/Fastq",
                               data=np.bytes_(fastq))
        self.fh[path].attrs["signalalign_tpu"] = np.bytes_("0.1")
        return path


def remove_analyses(path: str, match: Optional[str] = None) -> int:
    """Delete /Analyses groups whose name contains ``match`` (all if None).

    reference: remove_sa_analyses.py:42-79 (SignalAlign / Basecall /
    everything variants). Returns the number of groups removed.
    """
    n = 0
    with Fast5(path, "r+") as f5:
        if ANALYSES not in f5.fh:
            return 0
        for name in list(f5.fh[ANALYSES]):
            if match is None or match in name:
                del f5.fh[ANALYSES][name]
                n += 1
        if match is None:
            del f5.fh[ANALYSES]
    return n
