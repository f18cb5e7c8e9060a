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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
SRC = os.path.join(_PKG, "csrc", "signalalign_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
LIB_NAME = "libsignalalign_native.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], LIB_NAME)


def _build(path: str) -> None:
    """g++ into a temporary name beside ``path``, then an atomic rename;
    raises RuntimeError with g++'s output on failure."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"building {SRC} with g++ failed: {exc}") from exc
    if out.returncode != 0:
        raise RuntimeError(f"building {SRC} with g++ failed "
                           f"(exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be
    built or loaded. Only the HDP trainer's entry points are bound here
    (``hdp.train``); the event detection and guide alignment slices bind
    theirs with their callers."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.sa_hdp_gibbs.restype = ctypes.c_long
        lib.sa_spline_slopes.restype = None
        _lib = lib
        return _lib
