"""Raw-signal event detection (scrappie-style t-stat segmentation).

reference: impl/event_detection.c (compute_sum_sumsq:35, compute_tstat:60,
short_long_peak_detector:122, create_events:234, detect_events:268) and
impl/scrappie_common.c (trim_and_segment_raw / trim_raw_by_mad:5-73).

The port's copy of ``signalalign_tpu.ops.event_detect``. The windowed
t-statistics are vectorized NumPy; the two-detector peak scan is
sequential (O(n) scalar work) and runs in the native library
(csrc/signalalign_native.cpp ``sa_peak_detector``), with no Python
fallback.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from signalalign_tpu_torch.utils import native

# reference: event_detection.h:15-29
DNA_PARAMS = dict(window_length1=3, window_length2=6, threshold1=1.4,
                  threshold2=9.0, peak_height=0.2)
RNA_PARAMS = dict(window_length1=7, window_length2=14, threshold1=2.5,
                  threshold2=9.0, peak_height=1.0)


def compute_tstat(signal: np.ndarray, w: int) -> np.ndarray:
    """Windowed two-sample t-statistic (compute_tstat, event_detection.c:60)."""
    n = len(signal)
    tstat = np.zeros(n, dtype=np.float32)
    if n < 2 * w or w < 2:
        return tstat
    s = np.zeros(n + 1)
    sq = np.zeros(n + 1)
    np.cumsum(signal, out=s[1:])
    np.cumsum(np.square(signal, dtype=np.float64), out=sq[1:])

    i = np.arange(w, n - w + 1)
    sum1 = s[i] - np.where(i > w, s[i - w], 0.0)
    sumsq1 = sq[i] - np.where(i > w, sq[i - w], 0.0)
    sum2 = (s[i + w] - s[i]).astype(np.float32)
    sumsq2 = (sq[i + w] - sq[i]).astype(np.float32)
    wf = float(w)
    mean1 = sum1 / wf
    mean2 = sum2 / wf
    combined_var = sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2
    combined_var = np.maximum(combined_var, np.finfo(np.float32).tiny)
    tstat[w:n - w + 1] = np.abs(mean2 - mean1) / np.sqrt(combined_var / wf)
    return tstat


def _peak_detector(tstat1, tstat2, wl1, wl2, th1, th2, peak_height):
    """Two-detector peak scan (short_long_peak_detector,
    event_detection.c:122-196) in the native library; its build raises
    where it fails (the JAX package falls back to a Python scan)."""
    return native.peak_detector(tstat1.astype(np.float32),
                                tstat2.astype(np.float32),
                                wl1, wl2, th1, th2, peak_height)


def detect_events(signal: np.ndarray, rna: bool = False,
                  sample_rate: float = 1.0,
                  start_sample: int = 0) -> np.ndarray:
    """Segment raw current into events.

    Returns a structured-like (n, 4) float array: mean, stdv, length
    (samples), start (sample index) — the event table consumed downstream
    (create_events/detect_events, event_detection.c:234-319).
    """
    p = RNA_PARAMS if rna else DNA_PARAMS
    signal = np.asarray(signal, dtype=np.float32)
    t1 = compute_tstat(signal, p["window_length1"])
    t2 = compute_tstat(signal, p["window_length2"])
    peaks = _peak_detector(t1, t2, p["window_length1"], p["window_length2"],
                           p["threshold1"], p["threshold2"], p["peak_height"])
    n = len(signal)
    bounds = np.concatenate([[0], peaks, [n]])
    s = np.zeros(n + 1)
    sq = np.zeros(n + 1)
    np.cumsum(signal, out=s[1:])
    np.cumsum(np.square(signal, dtype=np.float64), out=sq[1:])
    starts = bounds[:-1]
    ends = bounds[1:]
    lengths = (ends - starts).astype(np.float64)
    means = (s[ends] - s[starts]) / lengths
    var = (sq[ends] - sq[starts]) / lengths - means * means
    stdv = np.sqrt(np.maximum(var, 0.0))
    return np.stack([means, stdv, lengths, starts + start_sample], axis=1)


def trim_and_segment_raw(signal: np.ndarray, trim_start: int = 200,
                         trim_end: int = 10, varseg_chunk: int = 100,
                         varseg_thresh: float = 0.0) -> Tuple[np.ndarray, int]:
    """MAD-based raw trimming; returns (trimmed_signal, offset).

    reference: trim_raw_by_mad / trim_and_segment_raw
    (scrappie_common.c:5-73): per-chunk median absolute deviation, trim
    leading/trailing chunks below threshold, then fixed start/end trims.
    """
    n = len(signal)
    nchunks = n // varseg_chunk
    start = 0
    end = nchunks * varseg_chunk  # truncation "to be consistent with Sloika"
    if nchunks > 0:
        chunks = signal[:end].reshape(nchunks, varseg_chunk)
        med = np.median(chunks, axis=1, keepdims=True)
        mad = np.median(np.abs(chunks - med), axis=1)
        thresh = np.quantile(mad, varseg_thresh)
        for i in range(nchunks):
            if mad[i] > thresh:
                break
            start += varseg_chunk
        for i in range(nchunks, 0, -1):
            if mad[i - 1] > thresh:
                break
            end -= varseg_chunk
    start += trim_start
    end -= trim_end
    if start >= end:
        start, end = 0, n
    return signal[start:end], start
