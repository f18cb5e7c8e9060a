"""Build and load the port's CUDA kernels (``signalalign_tpu_torch/csrc``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. The library lands in
``build/torch_kernels/<source hash>/`` at the repository root, so an edit
to a source triggers a rebuild and concurrent processes never load a
half-written file. A missing ``nvcc`` or a failed build raises; nothing
is fetched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_kernels")
LIB_NAME = "libsa_torch_kernels.so"
# --fmad=false: no multiply-add contraction, so every operation rounds as
# in the plain PyTorch twin (one kernel per op); measured on an H100, the
# contracted build drifted 1e-3 in posteriors over 4k diagonals
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/banded_fb.cu: (argtypes, restype)
_SIGNATURES = {
    "sa_fwd_sweep": ([_P] * 10 + [_I] * 6 + [_P], _I),
    "sa_bwd_sweep_compact": ([_P] * 14 + [_I] * 7 + [ctypes.c_float, _P], _I),
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], LIB_NAME)


@dataclasses.dataclass
class Build:
    path: str
    seconds: float      # nvcc wall time; 0.0 when the library existed
    log: str            # nvcc's output (ptxas register/spill report)


def build() -> Build:
    """Compile the sources unless the library for their hash exists."""
    so = library_path()
    if os.path.exists(so):
        return Build(so, 0.0, "")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return Build(so, seconds, log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build().path)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
