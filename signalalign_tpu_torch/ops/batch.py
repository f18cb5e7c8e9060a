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
    problem's HDP tables, as the JAX function replicates them."""
    if with_expectations:
        raise NotImplementedError(
            "EM expectations come with ROADMAP slice 3 (EM training)")
    if not problems:
        return []
    p0 = problems[0]
    hdp = (hdp_tables(p0.hdp_dens, p0.hdp_slopes, *p0.hdp_grid, device)
           if p0.mode == bfb.MODE_HDP else None)
    pt = problem_tensors(problems, W, device, hdp)
    if pt.P != P:
        raise ValueError(f"bucket P={P} but its problems have P={pt.P}")
    fstack, f_incr, lse_f = bfb.sweep_forward(pt)
    bstack, b_incr, lse_b = bfb.sweep_backward(pt)
    fo, total_f = bfb.forward_offsets(f_incr, lse_f, pt.meta[:, bfb.M_NDIAG])
    bo, total_b = bfb.backward_offsets(b_incr, lse_b)
    cvec = (fo + bo - total_f[:, None]).float()
    post = bfb.posterior(fstack, bstack, cvec, pt).cpu().numpy()
    D1 = post.shape[1]
    results = []
    for i, p in enumerate(problems):
        full = np.zeros((p.x0.shape[0], P, W), np.float32)
        full[:D1] = post[i]
        results.append({"post": full, "total_f": float(total_f[i]),
                        "total_b": float(total_b[i])})
    return results
