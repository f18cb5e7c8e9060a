"""signalalign_tpu_torch — the PyTorch + CUDA port of signalalign_tpu.

Alignment with any number of paths per cell, Gaussian mean-only or HDP
spline emissions (TSV output, and site-mode variant/methylation calling),
runs on an NVIDIA Hopper GPU through two hand-written CUDA kernels
(``csrc/banded_fb.cu``); on CPU tensors every kernel wrapper uses its
plain PyTorch twin. The entry points run on the card unless given
``device=torch.device("cpu")``. The JAX package ``signalalign_tpu`` stays
the reference: this package imports nothing of it (it keeps its own copies of
the host modules it needs, under the same module paths) and never imports
``jax``.
"""

__version__ = "0.1.0"
