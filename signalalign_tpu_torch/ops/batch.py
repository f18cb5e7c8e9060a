"""Batched plain-PyTorch banded forward-backward over one bucket: the
counterpart of ``signalalign_tpu.ops.batch.run_banded_fb_batch`` (the
JAX XLA path), which the port's tests hold both packages to."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from signalalign_tpu_torch.convert import hdp_tables, problem_tensors
from signalalign_tpu_torch.ops import banded_fb as bfb


def run_banded_fb_batch(problems: Sequence[bfb.BandedProblem], W: int, P: int,
                        with_expectations: bool = False, *,
                        device: torch.device) -> List[Dict]:
    """Run a same-bucket batch of P-path problems; returns per-problem
    result dicts with the full posterior "post" ((Dpad+1, P, W) numpy),
    "total_f" and "total_b". A MODE_HDP bucket uploads the first
    problem's HDP tables, as the JAX function replicates them.

    ``with_expectations`` adds "texp" (3, 3) and "kexp" float64 from ``bfb.expectations`` over three-state stacks, as
    the JAX function does: kexp (3, num_kmers) in a Gaussian bucket and
    zeros (3, 1) in MODE_HDP, where the JAX XLA path alone computes
    Gaussian moments (the TPU kernel, the reference's HDP expectations
    and the port's EM path carry transitions only)."""
    if not problems:
        return []
    p0 = problems[0]
    hdp = (hdp_tables(p0.hdp_dens, p0.hdp_slopes, *p0.hdp_grid, device)
           if p0.mode == bfb.MODE_HDP else None)
    pt = problem_tensors(problems, W, device, hdp, kmer_ids=with_expectations)
    if pt.P != P:
        raise ValueError(f"bucket P={P} but its problems have P={pt.P}")
    fstack, f_incr, lse_f = bfb.sweep_forward(pt, with_expectations)
    bstack, b_incr, lse_b = bfb.sweep_backward(pt, with_expectations)
    fo, total_f = bfb.forward_offsets(f_incr, lse_f, pt.meta[:, bfb.M_NDIAG])
    bo, total_b = bfb.backward_offsets(b_incr, lse_b)
    cvec = (fo + bo - total_f[:, None]).float()
    fm, bm = ((fstack[:, :, bfb.MATCH], bstack[:, :, bfb.MATCH])
              if with_expectations else (fstack, bstack))
    post = bfb.posterior(fm, bm, cvec, pt).cpu().numpy()
    D1 = post.shape[1]
    results = []
    for i, p in enumerate(problems):
        full = np.zeros((p.x0.shape[0], P, W), np.float32)
        full[:D1] = post[i]
        results.append({"post": full, "total_f": float(total_f[i]),
                        "total_b": float(total_b[i])})
    if with_expectations:
        cvec_d1, cvec_d2 = bfb.expect_cvecs(fo - total_f[:, None], bo)
        texp, kexp = bfb.expectations(
            pt, fstack, bstack, cvec_d1, cvec_d2,
            p0.num_kmers if hdp is None else 0)
        texp, kexp = texp.cpu().numpy(), kexp.cpu().numpy()
        for i, r in enumerate(results):
            r["texp"] = texp[i]
            r["kexp"] = kexp[i]
    return results
