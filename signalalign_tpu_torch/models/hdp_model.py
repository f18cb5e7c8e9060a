"""Hierarchical-Dirichlet-process emission model (.nhdp files): the port's
copy of ``signalalign_tpu.models.hdp_model`` (same fields, same formulas).

The inference-side contract of the reference HDP (impl/hdp.c:2588-2612
dir_proc_density + impl/nanopore_hdp.c:420 get_nanopore_kmer_density) is:
per k-mer, a posterior-predictive density sampled on a fixed uniform grid
with precomputed cubic-spline knot slopes; unobserved k-mers fall back to
their closest observed ancestor in the DP tree. The ancestor walk is
resolved once at load time into dense (num_kmers, grid) tables, so every
emission is a uniform-grid Hermite spline interpolation.

File format: serialize_nhdp (nanopore_hdp.c:1077-1088) = alphabet size /
alphabet / kmer length header + serialize_hdp (hdp.c:2919-3040).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from signalalign_tpu_torch.utils.alphabet import Alphabet


@dataclasses.dataclass
class NanoporeHDP:
    alphabet: Alphabet
    grid: np.ndarray               # (grid_length,)
    densities: np.ndarray          # (num_kmers, grid_length) resolved tables
    slopes: np.ndarray             # (num_kmers, grid_length)
    observed: np.ndarray           # (num_kmers,) bool: leaf itself observed
    num_dps: int
    # raw per-dp storage
    dp_densities: Optional[List[Optional[np.ndarray]]] = None
    dp_slopes: Optional[List[Optional[np.ndarray]]] = None
    dp_parent: Optional[np.ndarray] = None
    # float32 tables of density_arrays(), made at its first call
    _f32: Optional[tuple] = dataclasses.field(default=None, init=False,
                                              repr=False, compare=False)

    @property
    def grid_start(self) -> float:
        return float(self.grid[0])

    @property
    def grid_step(self) -> float:
        return float(self.grid[1] - self.grid[0])

    def density_arrays(self):
        """(densities, slopes, grid_start, grid_step) for the device: float32
        tables converted once and returned as the same arrays on every
        call (at 46,656 k-mers x 1,200 grid points each is 224 MB), so
        every problem of a run shares them. Callers must not write to
        them."""
        if self._f32 is None:
            self._f32 = (np.ascontiguousarray(self.densities, dtype=np.float32),
                         np.ascontiguousarray(self.slopes, dtype=np.float32))
        return (*self._f32, self.grid_start, self.grid_step)


def load_nhdp(path: str) -> NanoporeHDP:
    """Parse a .nhdp serialization.

    Layout (serialize_nhdp + serialize_hdp):
      alphabet_size \n alphabet \n kmer_length \n
      splines_finalized \n has_data \n sample_gamma \n num_dps \n
      [data line] [dp_ids line]                (if has_data)
      mu nu alpha beta \n
      grid_start grid_stop grid_length \n
      gamma_params line
      [gamma_alpha, gamma_beta, w, s lines]    (if sample_gamma)
      num_dps x "parent_id num_factor_children" lines
      num_dps x posterior-predictive lines     (blank if dp unobserved)
      num_dps x spline-slope lines             (blank if dp unobserved)
      factor tree lines (ignored for inference)
    """
    with open(path) as fh:
        alphabet_size = int(fh.readline())
        alphabet = fh.readline().strip()
        kmer_length = int(fh.readline())
        if len(alphabet) != alphabet_size:
            raise ValueError(f"{path}: alphabet size mismatch")
        splines_finalized = bool(int(fh.readline()))
        has_data = bool(int(fh.readline()))
        sample_gamma = bool(int(fh.readline()))
        num_dps = int(fh.readline())
        if has_data:
            fh.readline()  # data
            fh.readline()  # dp ids
        fh.readline()      # mu nu alpha beta
        g0, g1, glen = fh.readline().split()
        grid = np.linspace(float(g0), float(g1), int(glen))
        fh.readline()      # gamma params
        if sample_gamma:
            for _ in range(4):
                fh.readline()

        parent = np.full(num_dps, -1, dtype=np.int64)
        nfc = np.zeros(num_dps, dtype=np.int64)
        for i in range(num_dps):
            a, b = fh.readline().split()
            parent[i] = -1 if a == "-" else int(a)
            nfc[i] = int(b)

        if not (has_data and splines_finalized):
            raise ValueError(f"{path}: HDP has no finalized distributions")

        dp_dens: List[Optional[np.ndarray]] = []
        for _ in range(num_dps):
            line = fh.readline().split()
            dp_dens.append(np.array(line, dtype=np.float64) if line else None)
        dp_slopes: List[Optional[np.ndarray]] = []
        for _ in range(num_dps):
            line = fh.readline().split()
            dp_slopes.append(np.array(line, dtype=np.float64) if line else None)

    alpha = Alphabet(alphabet, kmer_length)
    num_kmers = alpha.num_kmers
    if num_dps < num_kmers:
        raise ValueError(f"{path}: fewer DPs ({num_dps}) than k-mers")

    # resolve the observed-ancestor fallback per leaf k-mer (dp id == kmer
    # rank; dir_proc_density walks to the first ancestor with a posterior
    # predictive)
    glen_i = len(grid)
    densities = np.zeros((num_kmers, glen_i))
    slopes = np.zeros((num_kmers, glen_i))
    observed = np.zeros(num_kmers, dtype=bool)
    for kid in range(num_kmers):
        dp = kid
        observed[kid] = dp_dens[dp] is not None
        hops = 0
        while dp_dens[dp] is None:
            dp = int(parent[dp])
            hops += 1
            if dp < 0 or hops > 64:
                raise ValueError(f"{path}: no observed ancestor for kmer {kid}")
        densities[kid] = dp_dens[dp]
        slopes[kid] = dp_slopes[dp]

    return NanoporeHDP(alphabet=alpha, grid=grid, densities=densities,
                       slopes=slopes, observed=observed, num_dps=num_dps,
                       dp_densities=dp_dens, dp_slopes=dp_slopes,
                       dp_parent=parent)


def hdp_log_density_batch(hdp: NanoporeHDP, kmer_ids: np.ndarray,
                          descaled_means: np.ndarray,
                          var: float) -> np.ndarray:
    """Vectorized log((1/var) * density) for (kmer, mean) pairs.

    reference: emissions_signal_getHdpKmerDensity (stateMachine.c:527-553).
    """
    y = hdp.densities[kmer_ids]
    s = hdp.slopes[kmer_ids]
    g = hdp.grid
    n = len(g)
    dx = g[1] - g[0]
    x = np.asarray(descaled_means, dtype=np.float64)

    il = np.clip(((x - g[0]) // dx).astype(np.int64), 0, n - 2)
    ir = il + 1
    rows = np.arange(len(x))
    yl = y[rows, il]
    yr = y[rows, ir]
    sl = s[rows, il]
    sr = s[rows, ir]
    dy = yr - yl
    a = sl * dx - dy
    b = dy - sr * dx
    tl = (x - g[il]) / dx
    tr = 1.0 - tl
    mid = tr * yl + tl * yr + tl * tr * (a * tr + b * tl)
    below = y[:, 0] - s[:, 0] * (g[0] - x)
    above = y[:, n - 1] + s[:, n - 1] * (x - g[n - 1])
    v = np.where(x <= g[0], below, np.where(x >= g[n - 1], above, mid))
    v = np.maximum(v, 0.0) / var
    with np.errstate(divide="ignore"):
        return np.where(v > 0, np.log(v), -np.inf)
