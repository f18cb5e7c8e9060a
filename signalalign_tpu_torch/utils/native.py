"""ctypes bindings for the port's host-side native library: the
counterpart of ``signalalign_tpu.utils.native``.

``csrc/signalalign_native.cpp`` (a byte-for-byte copy of the JAX
package's ``csrc/signalalign_native.cpp``: the HDP Gibbs sampler and
spline slopes, the peak detector, the adaptive banded aligner and the
minimizer index) builds with ``g++`` at first use into
``build/torch_native/<source hash>/`` at the repository root, so an edit
to the source triggers a rebuild and concurrent processes never load a
half-written file. A missing ``g++``, a failed build or a failed load
raises with the compiler's or the loader's message: the port has no
Python fallback for what this library computes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
SRC = os.path.join(_PKG, "csrc", "signalalign_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
LIB_NAME = "libsignalalign_native.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


class NativeLibraryError(RuntimeError):
    """The native library could not be built or loaded: a fault of the
    host, not of a read, which callers that skip bad reads pass on."""


def library_path() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], LIB_NAME)


def _build(path: str) -> None:
    """g++ into a temporary name beside ``path``, then an atomic rename;
    raises NativeLibraryError with g++'s output on failure."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeLibraryError(
            f"building {SRC} with g++ failed: {exc}") from exc
    if out.returncode != 0:
        raise NativeLibraryError(f"building {SRC} with g++ failed "
                                 f"(exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be
    built or loaded. Binds the HDP trainer's entry points (``hdp.train``),
    the peak detector (``ops.event_detect``), the adaptive banded aligner
    (``pipeline.event_align``) and the guide aligner's Smith-Waterman and
    minimizer index (``io.minialign``), with the JAX package's argtypes.
    ``sa_minidx_build`` returns a heap pointer: its restype is c_void_p,
    since ctypes' default c_int truncates a 64-bit pointer."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            raise NativeLibraryError(f"loading {path} failed: {exc}") from exc
        lib.sa_hdp_gibbs.restype = ctypes.c_long
        lib.sa_spline_slopes.restype = None
        lib.sa_peak_detector.restype = ctypes.c_long
        lib.sa_peak_detector.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_long)]
        lib.sa_adaptive_banded_align.restype = ctypes.c_long
        lib.sa_adaptive_banded_align.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_double)]
        lib.sa_minidx_build.restype = ctypes.c_void_p
        lib.sa_minidx_build.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.sa_minidx_free.restype = None
        lib.sa_minidx_free.argtypes = [ctypes.c_void_p]
        lib.sa_minidx_map.restype = ctypes.c_long
        lib.sa_minidx_map.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_long, *[ctypes.POINTER(ctypes.c_long)] * 4,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double)]
        sw_out = [*[ctypes.POINTER(ctypes.c_long)] * 4,
                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
                  ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                  ctypes.POINTER(ctypes.c_double)]
        scores = [ctypes.c_double] * 4
        # returns 0, or -1 when the traceback outgrows max_ops (the JAX
        # package leaves ctypes' c_int default here, which reads the same)
        lib.sa_sw_align.restype = ctypes.c_long
        lib.sa_sw_align.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            *scores, *sw_out]
        lib.sa_sw_align_banded.restype = ctypes.c_long
        lib.sa_sw_align_banded.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, *scores, *sw_out]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def peak_detector(t1: np.ndarray, t2: np.ndarray, wl1: int, wl2: int,
                  th1: float, th2: float, peak_height: float) -> np.ndarray:
    """Peak positions of the two-detector scan (short_long_peak_detector,
    event_detection.c:122-196) over two t-statistic tracks."""
    lib = load()
    n = len(t1)
    t1 = np.ascontiguousarray(t1, dtype=np.float32)
    t2 = np.ascontiguousarray(t2, dtype=np.float32)
    out = np.zeros(n, dtype=np.int64)
    cnt = lib.sa_peak_detector(_ptr(t1, ctypes.c_float),
                               _ptr(t2, ctypes.c_float), n, wl1, wl2, th1,
                               th2, peak_height, _ptr(out, ctypes.c_long))
    return out[:cnt]


def adaptive_banded_align(ev_mean: np.ndarray, m_hat: np.ndarray,
                          inv: np.ndarray, cst: np.ndarray):
    """The adaptive banded Viterbi of events against k-mers
    (adaptive_banded_simple_event_align2, eventAligner.c:902-1233).
    Returns (kmer_idx, event_idx, qc) with qc = (avg_log_emission,
    spanned, max_gap, events_per_kmer)."""
    lib = load()
    ev_mean = np.ascontiguousarray(ev_mean, dtype=np.float64)
    m_hat = np.ascontiguousarray(m_hat, dtype=np.float64)
    inv = np.ascontiguousarray(inv, dtype=np.float64)
    cst = np.ascontiguousarray(cst, dtype=np.float64)
    n_events = len(ev_mean)
    n_kmers = len(m_hat)
    cap = n_events + n_kmers + 2
    out_k = np.zeros(cap, dtype=np.int64)
    out_e = np.zeros(cap, dtype=np.int64)
    qc = np.zeros(4, dtype=np.float64)
    cnt = lib.sa_adaptive_banded_align(
        _ptr(ev_mean, ctypes.c_double), n_events,
        _ptr(m_hat, ctypes.c_double), _ptr(inv, ctypes.c_double),
        _ptr(cst, ctypes.c_double), n_kmers, _ptr(out_k, ctypes.c_long),
        _ptr(out_e, ctypes.c_long), _ptr(qc, ctypes.c_double))
    return out_k[:cnt], out_e[:cnt], qc
