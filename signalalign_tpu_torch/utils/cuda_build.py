"""Build and load the port's CUDA kernels (``signalalign_tpu_torch/csrc``).

Each source compiles with its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds. The library lands in
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
# contracted build drifted 1e-3 in posteriors over 4k diagonals.
# --split-compile=0: nvcc optimises a source's kernels on as many threads
# as the host has (banded_fb.cu's many instances build in parallel)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "--split-compile=0", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/banded_fb.cu and csrc/banded_fb_prob.cu:
# (argtypes, restype)
_SIGNATURES = {
    "sa_fwd_sweep": ([_P] * 15 + [_I] * 9 + [_F] * 3 + [_P], _I),
    "sa_bwd_sweep_compact": ([_P] * 23 + [_I] * 10 + [_F] * 4 + [_P], _I),
    "sa_expect_sums": ([_P] * 18 + [_I] * 8 + [_F] * 3 + [_P], _I),
    "sa_expect_split": ([_I] * 2, _I),
    "sa_expect_sums_scratch_bytes": ([_I] * 3, ctypes.c_longlong),
    "sa_cells_per_thread": ([_I] * 4, _I),
    "sa_sweep_scratch_bytes": ([_I] * 4, ctypes.c_longlong),
    "sa_cluster_ctas": ([_I] * 4, _I),
    "sa_cluster_threads": ([_I] * 4, _I),
    "sa_fwd_sweep_prob": ([_P] * 11 + [_I] * 5 + [_P], _I),
    "sa_bwd_sweep_compact_prob": ([_P] * 15 + [_I] * 6 + [_F] + [_P], _I),
    # csrc/barrier_probe.cu (a timing probe, not a port of a TPU kernel)
    "sa_barrier_probe": ([_I] * 4 + [_P] * 2, _I),
    "sa_barrier_probe_cluster": ([_I] * 4 + [_P] * 2, _I),
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
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, run in parallel, then one link."""
    so = library_path()
    if os.path.exists(so):
        return Build(so, 0.0, "")
    out_dir = os.path.dirname(so)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{os.getpid()}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for src, _, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        log += out
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = f"{so}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                           *[obj for _, obj, _ in jobs]],
                          capture_output=True, text=True, timeout=300)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, so)
    for _, obj, _ in jobs:
        os.remove(obj)
    return Build(so, time.perf_counter() - t0, log)


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
