"""signalalign_tpu_torch — the PyTorch + CUDA port of signalalign_tpu.

Gaussian mean-only alignment with 1 <= P <= 8 paths per cell (TSV
output, and site-mode variant/methylation calling) runs on an NVIDIA
Hopper GPU through two hand-written CUDA kernels (``csrc/banded_fb.cu``);
on CPU tensors every kernel wrapper uses its plain PyTorch twin. The JAX
package ``signalalign_tpu`` stays the reference: this package reuses its
numpy-only host modules (``io``, ``models.pore_model``,
``ops.band_geometry``, ``ops.scaling``, ``ops.fb_oracle``,
``pipeline.variant_caller``, ``utils``) and never imports ``jax``.
"""

import os as _os
import sys as _sys
import types as _types

__version__ = "0.1.0"

# signalalign_tpu/__init__.py imports jax (to set up its compilation
# cache) unless this variable is set; the port's host-module imports
# must not pull jax in.
_os.environ.setdefault("SIGNALALIGN_TPU_NO_COMPILE_CACHE", "1")


class _MissingModule(_types.ModuleType):
    """Stands in for an optional package that is not installed: importing
    succeeds, and any use raises ImportError naming what needs it."""

    def __init__(self, name: str, needed_for: str):
        super().__init__(name)
        self._needed_for = needed_for

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise ImportError(f"{self.__name__} is required for {self._needed_for}")


# The shared host module signalalign_tpu.io.read imports io.fast5, which
# imports h5py at the top although only reading fast5 files uses it. The
# alignment path works on in-memory reads, so it runs where h5py is not
# installed.
try:
    import h5py  # noqa: F401
except ImportError:
    _sys.modules["h5py"] = _MissingModule("h5py", "reading fast5 files")
