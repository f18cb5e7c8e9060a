"""Seeded synthetic inputs for the port's tests and ``chip_smoke.py``.

Reads and guides come from the JAX package's numpy-only
``signalalign_tpu.utils.synthetic.build_synthetic_batch``. Pass it a
fresh ``fasta_path``: it reuses any file already at that path.
"""

from __future__ import annotations

import numpy as np

from signalalign_tpu.models.pore_model import PoreModel
from signalalign_tpu.utils.synthetic import build_synthetic_batch  # noqa: F401


def synthetic_pore_model(seed: int, alphabet: str = "ACGT",
                         k: int = 5) -> PoreModel:
    """A PoreModel with random level and noise tables drawn from ``seed``
    (levels 60-120 pA, level sd 1-2 pA)."""
    rng = np.random.default_rng(seed)
    model = PoreModel(alphabet, k)
    model.level_mean = rng.uniform(60, 120, model.num_kmers)
    model.level_sd = rng.uniform(1.0, 2.0, model.num_kmers)
    model.noise_mean = rng.uniform(0.8, 1.5, model.num_kmers)
    model.noise_sd = rng.uniform(0.1, 0.3, model.num_kmers)
    model.noise_lambda = model.noise_mean ** 3 / model.noise_sd ** 2
    return model
