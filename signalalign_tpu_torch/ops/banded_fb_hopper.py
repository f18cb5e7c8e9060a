"""The port's two Hopper kernels, their plain twins, and the aligner that
drives them over one bucket of problems with any number P of paths per
cell, Gaussian (MODE_MEAN_ONLY) or HDP (MODE_HDP) emissions, and the EM
expectation pass.

``forward_sweep`` launches ``sa_fwd_sweep`` and ``backward_sweep_compact``
launches ``sa_bwd_sweep_compact`` (``csrc/banded_fb.cu``) on CUDA tensors;
on CPU tensors each uses its plain twin (``forward_sweep_ref``,
``backward_sweep_compact_ref``), which has the same signature and output
contract. An HDP bucket's tensors carry its k-mer ids, level means and
the run's shared density tables (``ProblemTensors.kid``/``mu``/``hdp``),
which the kernels' HDP instances read. A CUDA tensor never falls back: a
missing ``nvcc``, a failed build, a shape the kernels do not take, a
missing table or a refused launch raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches`` and those of its expectation instances
(``expect=True``) in ``<wrapper>.expect_launches``, of which those of the
P > 2 instances (every expectation bucket of P > 1, and of P = 1 past
2,048 cells) also in ``<wrapper>.expect_paths_launches`` and those of the
per-pair instance at P = 2 in ``<wrapper>.expect_pair2_launches``; of its
launches, those of the wide instances (P * W > 8192 cells a diagonal) also
in ``<wrapper>.wide_launches``, and of these those of the cluster instance
(up to CAP, ``cluster_ctas``) in ``<wrapper>.cluster_launches`` and those
of the scratch instance (past CAP) in ``<wrapper>.wide_scratch_launches``.

On a bucket of ``expect_split`` (the P > 2 register instances: past the
per-pair instances, up to 8,192 cells a diagonal) the expectation
backward stores its three-state stack (``backward_sweep_stack``) and
``expect_sums`` launches ``sa_expect_sums``, which sums texp and kx from
both stacks (its twin ``expect_sums_ref``; launches in
``expect_sums.launches``); ``backward_sweep_compact(..., expect=True)``
runs the two in turn, so its contract does not change.

``forward_sweep_prob`` and ``backward_sweep_compact_prob`` launch the
probability-space kernels ``sa_fwd_sweep_prob`` and
``sa_bwd_sweep_compact_prob`` (``csrc/banded_fb_prob.cu``; P = 1
Gaussian buckets of W <= 512 made with ``problem_tensors(...,
prob=True)``), with the same CPU twins rule and their own counters.

``HopperAligner`` is the counterpart of the JAX package's
``PallasAligner.execute`` (``ops/banded_fb_pallas.py``), of
``PallasBatchAligner.execute_async`` (``ops/banded_fb_pallas_batch.py``;
the P = 1 ``fuse_compact`` branch, the P > 1 ``fuse_post`` +
``_compact_map_kernel`` branch and the ``estream`` HDP branch with its
``emission_stream.hdp_emission_stacks``) and of its
``execute_site_marginals`` and ``execute_expect``:
forward sweep, float64 normaliser scan, backward sweep with in-sweep
posterior + survivor compaction, then either the survivors decoded to
aligned pairs or their posteriors summed per site on the device; in the
expectation pass the backward (or, after it, ``sa_expect_sums``) also
sums the transition posteriors and the per-(path, position) emission
moments, which ``kexp_by_kmer`` keys by k-mer.
With ``log_space=False`` it is the counterpart of
``PallasBatchAligner(log_space=False)``: the probability-space sweeps,
and every result carries ``numerics_suspect``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from signalalign_tpu_torch.convert import problem_tensors
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.utils import cuda_build


def _check_cuda(pt: bfb.ProblemTensors) -> None:
    if pt.device.type != "cuda":
        raise ValueError(f"tensors on {pt.device}: the kernels run on CUDA")
    i32, f32 = torch.int32, torch.float32
    tensors = [("x0", pt.x0, i32), ("width", pt.width, i32),
               ("ref", pt.ref, f32), ("leg", pt.leg, i32),
               ("leg_src", pt.leg_src, i32),
               ("ev", pt.ev, f32), ("meta", pt.meta, i32),
               ("par", pt.par, f32)]
    hdp = pt.hdp is not None
    if hdp:
        tensors += [("kid", pt.kid, i32), ("mu", pt.mu, f32),
                    ("hdp.dens", pt.hdp.dens, f32),
                    ("hdp.slopes", pt.hdp.slopes, f32)]
    elif pt.mu is not None:
        raise ValueError("level-mean tensor without HDP tables")
    elif pt.kid is not None:
        # a Gaussian EM bucket's k-mer ids (read by kexp_by_kmer only)
        tensors.append(("kid", pt.kid, i32))
    for name, t, dtype in tensors:
        if (t is None or t.dtype != dtype or not t.is_contiguous()
                or t.device != pt.device):
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{pt.device}")
    B, D1 = pt.x0.shape
    LX = pt.ref.shape[-1]
    legs = (B, LX, pt.P * bfb.leg_words(pt.P))
    if (pt.width.shape != (B, D1) or pt.ref.shape[:3] != (B, bfb.NREF, pt.P)
            or pt.leg.shape != legs or pt.leg_src.shape != legs
            or pt.ev.shape[:2] != (B, bfb.NEV)
            or pt.meta.shape != (B, bfb.NMETA)
            or pt.par.shape != (B, bfb.NPACK)):
        raise ValueError("ProblemTensors shapes disagree")
    if hdp and (pt.kid.shape != (B, pt.P, LX) or pt.mu.shape != (B, pt.P, LX)
                or pt.hdp.slopes.shape != pt.hdp.dens.shape
                or pt.hdp.NG < 2):
        raise ValueError("HDP tensor shapes disagree")


def _check_out(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    if (t.shape != shape or t.dtype != dtype or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name}: need a contiguous {tuple(shape)} {dtype} "
                         f"tensor on {dev}")


def _launch(name: str, pt: bfb.ProblemTensors, leg: torch.Tensor, tensors,
            ints, floats=()) -> None:
    """Call C entry point ``name`` with the pointers of ``pt``'s tensors
    (``leg`` for its legality masks) and HDP tables (null for a Gaussian
    bucket), then of ``tensors``, then ``ints``, the HDP table sizes,
    ``floats``, the HDP grid and the current stream of ``pt``'s device;
    raises if the launch was refused."""
    fn = getattr(cuda_build.load(), name)
    h = pt.hdp
    hdp_ptrs = ([t.data_ptr() for t in (pt.kid, pt.mu, h.dens, h.slopes)]
                if h is not None else [None] * 4)
    ptrs = [t.data_ptr() for t in (pt.x0, pt.width, pt.ref, leg, pt.ev,
                                   pt.meta, pt.par)]
    ptrs += hdp_ptrs + [None if t is None else t.data_ptr() for t in tensors]
    sizes = (h.K, h.NG) if h is not None else (0, 0)
    grid = (h.g0, h.dx, h.gN) if h is not None else (0.0, 0.0, 0.0)
    with torch.cuda.device(pt.device):
        rc = fn(*ptrs, *ints, *sizes, *floats, *grid,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (P={pt.P}, W={pt.W}): "
                           f"CUDA error {rc}")


# --------------------------------------------------------------- forward

def forward_sweep_ref(pt: bfb.ProblemTensors, expect: bool = False):
    """Plain twin of ``forward_sweep``: (fstack (B, D1, P, W) f32, or
    (B, D1, 3, P, W) with ``expect``, f_incr (B, D1) f32, lse_f (B,)
    f32)."""
    return bfb.sweep_forward(pt, store_full=expect)


def cells_per_thread(W: int, P: int, expect: bool = False,
                     backward: bool = False) -> int:
    """The kernel instance the forward (or ``backward``) sweep launches
    for a bucket of P paths at width W: K cells per thread of a per-pair
    instance (P <= 2 and P * W <= 2048, the dispatch table of
    ``csrc/banded_fb.cu``), -K of a P > 2 one (K > 8: a wide instance,
    P * W > 8192, K = ceil(P * W / 1024); ``cluster_ctas`` says which), 0
    for a shape they do not take. Loads (and on first use builds) the
    kernels."""
    return cuda_build.load().sa_cells_per_thread(W, P, int(expect),
                                                 int(backward))


def cluster_ctas(W: int, P: int, expect: bool = False,
                 backward: bool = False) -> int:
    """Blocks a problem of the cluster instance the sweep launches for a
    bucket of P paths at width W (a wide bucket, P * W > 8192, up to
    CAP: its ring slices in the blocks' shared memory), 0 where another
    instance runs (past CAP: the scratch instance)."""
    return cuda_build.load().sa_cluster_ctas(W, P, int(expect),
                                             int(backward))


def cluster_threads(W: int, P: int, expect: bool = False,
                    backward: bool = False) -> int:
    """Threads a block of that cluster instance, 0 where it does not
    run."""
    return cuda_build.load().sa_cluster_threads(W, P, int(expect),
                                                int(backward))


def _scratch(pt: bfb.ProblemTensors, expect: bool, backward: bool):
    """The device scratch of the sweep's launch on ``pt`` (the scratch
    instance's ring and cells, L2-resident; past CAP), or None."""
    per = cuda_build.load().sa_sweep_scratch_bytes(pt.W, pt.P, int(expect),
                                                   int(backward))
    if not per:
        return None
    return torch.empty(pt.x0.shape[0] * per // 4, dtype=torch.float32,
                       device=pt.device)


def forward_sweep(pt: bfb.ProblemTensors, expect: bool = False):
    """Forward sweep of every problem of ``pt`` (one CUDA block each).

    Returns (fstack, f_incr, lse_f) as ``forward_sweep_ref``; on CUDA the
    fstack rows past a problem's n_diag are left unwritten. ``expect``
    keeps all three states of each diagonal for the expectation pass.
    """
    if pt.device.type == "cpu":
        return forward_sweep_ref(pt, expect)
    _check_cuda(pt)
    B, D1 = pt.x0.shape
    dev = pt.device
    fstack = torch.empty((B, D1, 3, pt.P, pt.W) if expect
                         else (B, D1, pt.P, pt.W),
                         dtype=torch.float32, device=dev)
    f_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_f = torch.empty(B, dtype=torch.float32, device=dev)
    scratch = _scratch(pt, expect, False)
    _launch("sa_fwd_sweep", pt, pt.leg, (fstack, f_incr, lse_f, scratch),
            (B, D1, pt.W, pt.P, pt.ref.shape[-1], pt.ev.shape[-1],
             int(expect)))
    _count(forward_sweep, pt, expect, False)
    return fstack, f_incr, lse_f


def _count(fn, pt: bfb.ProblemTensors, expect: bool,
           backward: bool) -> None:
    """Count a launch of ``fn``'s kernel on ``pt``: in ``fn.launches``, or
    ``fn.expect_launches`` for the expectation pass (and those of the
    P > 2 instances, the wide ones among them, also in
    ``fn.expect_paths_launches``, those of the per-pair instance at P = 2
    in ``fn.expect_pair2_launches``); a wide instance's also in
    ``fn.wide_launches``, and in ``fn.cluster_launches`` or
    ``fn.wide_scratch_launches`` by instance."""
    k = cells_per_thread(pt.W, pt.P, expect, backward)
    if expect:
        fn.expect_launches += 1
        if k < 0:
            fn.expect_paths_launches += 1
        elif pt.P == 2:
            fn.expect_pair2_launches += 1
    else:
        fn.launches += 1
    if k < -8:
        fn.wide_launches += 1
        if cluster_ctas(pt.W, pt.P, expect, backward):
            fn.cluster_launches += 1
        else:
            fn.wide_scratch_launches += 1


forward_sweep.launches = 0
forward_sweep.expect_launches = 0
forward_sweep.expect_paths_launches = 0
forward_sweep.expect_pair2_launches = 0
forward_sweep.wide_launches = 0
forward_sweep.cluster_launches = 0
forward_sweep.wide_scratch_launches = 0


# ------------------------------------------------------------- backward

def _compact_ref(pt: bfb.ProblemTensors, fm, bm, bo, cvecf, threshold: float,
                 R: int):
    """The posterior exp(max(fm + bm + cvecf + Bo, NEG)) of normalised
    (B, D1, P, W) forward and backward match rows, thresholded at the
    cells that may report and compacted in (band offset, path) order into
    R slots per diagonal: (slot_cell, slot_val, cnt)."""
    c = (cvecf + bo).float()
    p = torch.exp(torch.clamp(fm + bm + c[:, :, None, None], min=bfb.NEG))
    surv = bfb.cell_mask(pt) & (p >= threshold)
    B, D1 = pt.x0.shape
    # (B, D1, P, W) -> (B, D1, W*P): flat index o*P + p is the cell id
    surv = surv.transpose(2, 3).reshape(B, D1, -1)
    p = p.transpose(2, 3).reshape(B, D1, -1)
    rank = torch.cumsum(surv, dim=2) - 1
    cnt = surv.sum(dim=2, dtype=torch.int32)
    keep = surv & (rank < R)
    slot_cell = torch.full((B, D1, R), -1, dtype=torch.int32, device=pt.device)
    slot_val = torch.zeros(B, D1, R, dtype=torch.float32, device=pt.device)
    bi, di, ci = keep.nonzero(as_tuple=True)
    ri = rank[keep]
    slot_cell[bi, di, ri] = ci.int()
    slot_val[bi, di, ri] = p[keep]
    return slot_cell, slot_val, cnt


def backward_sweep_compact_ref(pt: bfb.ProblemTensors, fstack, cvecf,
                               threshold: float, R: int,
                               expect: bool = False):
    """Plain twin of ``backward_sweep_compact``: the full backward sweep,
    then the posterior, threshold and rank compaction over the stack.

    Returns (b_incr (B, D1) f32, lse_b (B,) f32, slot_cell (B, D1, R)
    int32 cells o*P + p, slot_val (B, D1, R) f32 posteriors, cnt (B, D1)
    int32 survivors per diagonal); slots at ranks >= cnt hold -1 / 0.
    Survivors of a diagonal rank in (band offset, path) order. With
    ``expect`` (``fstack`` the three-state stack) it also returns texp
    (B, 7) and kx (B, 3, P, LX) float64 from ``expect_sums_ref`` over
    the three-state backward stack (kx zero in MODE_HDP).
    """
    if expect:
        out = backward_sweep_stack_ref(pt, fstack, cvecf, threshold, R)
        bo, _ = bfb.backward_offsets(out[0], out[1])
        return out[:5] + expect_sums_ref(pt, fstack, out[5], cvecf, bo)
    bstack, b_incr, lse_b = bfb.sweep_backward(pt)
    bo, _ = bfb.backward_offsets(b_incr, lse_b)
    return (b_incr, lse_b) + _compact_ref(pt, fstack, bstack, bo, cvecf,
                                          threshold, R)


def backward_sweep_stack_ref(pt: bfb.ProblemTensors, fstack, cvecf,
                             threshold: float, R: int):
    """Plain twin of ``backward_sweep_stack``: the full backward sweep
    with all three states kept, then the posterior, threshold and
    compaction; (b_incr, lse_b, slot_cell, slot_val, cnt) as
    ``backward_sweep_compact_ref`` and bstack (B, D1, 3, P, W)."""
    bstack, b_incr, lse_b = bfb.sweep_backward(pt, store_full=True)
    bo, _ = bfb.backward_offsets(b_incr, lse_b)
    return (b_incr, lse_b) + _compact_ref(
        pt, fstack[:, :, bfb.MATCH], bstack[:, :, bfb.MATCH], bo, cvecf,
        threshold, R) + (bstack,)


def expect_split(W: int, P: int) -> bool:
    """Whether the backward's expectation pass on a bucket of P paths at
    width W runs a P > 2 register instance (P * W up to 8,192 cells, past
    the per-pair instances), which stores its three-state stack and leaves
    texp and kx to ``expect_sums``; the per-pair, cluster and scratch
    instances sum them in the sweep. The kernels' own rule
    (``sa_expect_split``); loads (and on first use builds) them."""
    return bool(cuda_build.load().sa_expect_split(W, P))


def backward_sweep_compact(pt: bfb.ProblemTensors, fstack, cvecf,
                           threshold: float, R: int, expect: bool = False):
    """Backward sweep with the posterior, threshold and survivor
    compaction fused in; ``cvecf`` (B, D1) float64 is Fo(d) - total_f.

    Returns (b_incr, lse_b, slot_cell, slot_val, cnt) as
    ``backward_sweep_compact_ref``; ``cnt`` counts every survivor of a
    diagonal even past R. ``expect`` (``fstack`` the three-state stack of
    ``forward_sweep(pt, expect=True)``) adds texp (B, 7) float64, the
    transition posterior sums in ``bfb.TEXP_ROWS`` order, and kx (B, 3, P,
    LX) float64, the into-match posteriors' moments [Σp, Σp·dx, Σp·dx²]
    at each TO (path, position), summed over the legal source paths (zero
    in MODE_HDP): summed in the sweep, or on a bucket of ``expect_split``
    by ``backward_sweep_stack`` and then ``expect_sums`` on the same
    stream.
    """
    if pt.device.type == "cpu":
        return backward_sweep_compact_ref(pt, fstack, cvecf, threshold, R,
                                          expect)
    if expect and expect_split(pt.W, pt.P):
        out = backward_sweep_stack(pt, fstack, cvecf, threshold, R)
        bo, _ = bfb.backward_offsets(out[0], out[1])
        return out[:5] + expect_sums(pt, fstack, out[5], cvecf, bo)
    return _backward(pt, fstack, cvecf, threshold, R, expect, False)


def _backward(pt: bfb.ProblemTensors, fstack, cvecf, threshold: float,
              R: int, expect: bool, stack: bool):
    """Launch ``sa_bwd_sweep_compact`` on CUDA tensors: the survivor
    outputs, then with ``expect`` texp and kx summed in the sweep, or with
    ``stack`` (a bucket of ``expect_split``) the three-state bstack."""
    _check_cuda(pt)
    B, D1 = pt.x0.shape
    LX = pt.ref.shape[-1]
    dev = pt.device
    _check_out("fstack", fstack, (B, D1, 3, pt.P, pt.W) if expect
               else (B, D1, pt.P, pt.W), torch.float32, dev)
    _check_out("cvecf", cvecf, (B, D1), torch.float64, dev)
    b_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_b = torch.empty(B, dtype=torch.float32, device=dev)
    slot_cell = torch.empty(B, D1, R, dtype=torch.int32, device=dev)
    slot_val = torch.empty(B, D1, R, dtype=torch.float32, device=dev)
    cnt = torch.empty(B, D1, dtype=torch.int32, device=dev)
    texp = kx = bstack = None
    if stack:
        bstack = torch.empty(B, D1, 3, pt.P, pt.W, dtype=torch.float32,
                             device=dev)
    elif expect:
        texp = torch.empty(B, 7, dtype=torch.float64, device=dev)
        kx = torch.zeros(B, 3, pt.P, LX, dtype=torch.float64, device=dev)
    scratch = _scratch(pt, expect, True)
    _launch("sa_bwd_sweep_compact", pt, pt.leg_src,
            (fstack, cvecf, b_incr, lse_b, slot_cell, slot_val, cnt, texp,
             kx, bstack, scratch, pt.leg if expect else None),
            (B, D1, pt.W, pt.P, LX, pt.ev.shape[-1], R, int(expect)),
            (float(threshold),))
    _count(backward_sweep_compact, pt, expect, True)
    out = (b_incr, lse_b, slot_cell, slot_val, cnt)
    if stack:
        return out + (bstack,)
    return out + (texp, kx) if expect else out


backward_sweep_compact.launches = 0
backward_sweep_compact.expect_launches = 0
backward_sweep_compact.expect_paths_launches = 0
backward_sweep_compact.expect_pair2_launches = 0
backward_sweep_compact.wide_launches = 0
backward_sweep_compact.cluster_launches = 0
backward_sweep_compact.wide_scratch_launches = 0


def backward_sweep_stack(pt: bfb.ProblemTensors, fstack, cvecf,
                         threshold: float, R: int):
    """The expectation backward of a bucket of ``expect_split`` (a P > 2
    register instance, ``fstack`` the three-state stack): the backward
    with the posterior, threshold and compaction fused in, which also
    stores each diagonal's three normalised states and sums nothing.
    Returns (b_incr, lse_b, slot_cell, slot_val, cnt) as
    ``backward_sweep_compact`` and bstack (B, D1, 3, P, W) f32, laid out as
    fstack (on CUDA its rows past a problem's n_diag are left unwritten).
    Counted as ``backward_sweep_compact``'s expectation launches."""
    if pt.device.type == "cpu":
        return backward_sweep_stack_ref(pt, fstack, cvecf, threshold, R)
    if not expect_split(pt.W, pt.P):
        raise ValueError(f"a bucket of P={pt.P} at W={pt.W} sums its "
                         "expectations in the sweep: no stack to store")
    return _backward(pt, fstack, cvecf, threshold, R, True, True)


# ---------------------------------------------------- expectation sums

def expect_sums_ref(pt: bfb.ProblemTensors, fstack, bstack, cvecf, bo):
    """Plain twin of ``expect_sums``: ``bfb.expectation_sums`` over the
    two three-state stacks with the normalisers of ``bfb.expect_cvecs``
    (kx zero in MODE_HDP)."""
    return bfb.expectation_sums(pt, fstack, bstack,
                                *bfb.expect_cvecs(cvecf, bo),
                                moments=pt.hdp is None)


def expect_sums(pt: bfb.ProblemTensors, fstack, bstack, cvecf, bo):
    """The EM sums of a bucket of ``expect_split`` from the forward's and
    the backward's three-state stacks (B, D1, 3, P, W), ``cvecf`` = Fo(d)
    - total_f and the backward offsets ``bo`` = Bo(d) (B, D1) float64:
    texp (B, 7) float64 in ``bfb.TEXP_ROWS`` order and kx (B, 3, P, LX)
    float64 [Σp, Σp·dx, Σp·dx²] (zero in MODE_HDP), as ``expect_sums_ref``.
    On CUDA it launches ``sa_expect_sums`` (csrc/banded_fb.cu): every
    (problem, diagonal, cell) at once, the sums in an order fixed by the
    code, so two launches give the same bits."""
    if pt.device.type == "cpu":
        return expect_sums_ref(pt, fstack, bstack, cvecf, bo)
    _check_cuda(pt)
    B, D1 = pt.x0.shape
    LX = pt.ref.shape[-1]
    dev = pt.device
    if not expect_split(pt.W, pt.P):
        raise ValueError(f"a bucket of P={pt.P} at W={pt.W} sums its "
                         "expectations in the sweep")
    for name, t in (("fstack", fstack), ("bstack", bstack)):
        _check_out(name, t, (B, D1, 3, pt.P, pt.W), torch.float32, dev)
    for name, t in (("cvecf", cvecf), ("bo", bo)):
        _check_out(name, t, (B, D1), torch.float64, dev)
    texp = torch.empty(B, 7, dtype=torch.float64, device=dev)
    kx = (torch.empty if pt.hdp is None else torch.zeros)(
        B, 3, pt.P, LX, dtype=torch.float64, device=dev)
    per = cuda_build.load().sa_expect_sums_scratch_bytes(D1, pt.P, LX)
    scratch = torch.empty(B * per // 8, dtype=torch.float64, device=dev)
    _launch("sa_expect_sums", pt, pt.leg,
            (fstack, bstack, cvecf, bo, texp,
             kx if pt.hdp is None else None, scratch),
            (B, D1, pt.W, pt.P, LX, pt.ev.shape[-1]))
    expect_sums.launches += 1
    return texp, kx


expect_sums.launches = 0


# ------------------------------------------- probability-space sweeps

def _check_prob(pt: bfb.ProblemTensors) -> None:
    if pt.prob is None:
        raise ValueError("no probability-space tensors: problem_tensors(..., "
                         "prob=True)")
    bfb.check_prob(pt.W, pt.P, pt.hdp is not None)
    B, LX, LE = pt.x0.shape[0], pt.ref.shape[-1], pt.ev.shape[-1]
    pr = pt.prob
    for name, t, shape, dtype in (
            ("prob.cexp", pr.cexp, (B, 2, LX), torch.float32),
            ("prob.ev_best", pr.ev_best, (B, LE), torch.float32),
            ("prob.par", pr.par, (B, bfb.NPACK), torch.float32),
            ("prob.ev_norm", pr.ev_norm, (B,), torch.float64)):
        _check_out(name, t, shape, dtype, pt.device)


def _launch_prob(name: str, pt: bfb.ProblemTensors, tensors, ints,
                 floats=()) -> None:
    """Call C entry point ``name`` of csrc/banded_fb_prob.cu with the
    pointers of ``pt``'s tensors and its probability-space tensors, then
    of ``tensors``, then ``ints``, ``floats`` and the current stream;
    raises if the launch was refused."""
    fn = getattr(cuda_build.load(), name)
    pr = pt.prob
    ptrs = [t.data_ptr() for t in (pt.x0, pt.width, pt.ref, pt.ev, pt.meta,
                                   pr.cexp, pr.ev_best, pr.par, *tensors)]
    with torch.cuda.device(pt.device):
        rc = fn(*ptrs, *ints, *floats,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (W={pt.W}): CUDA error {rc}")


def forward_sweep_prob_ref(pt: bfb.ProblemTensors):
    """Plain twin of ``forward_sweep_prob``: ``bfb.sweep_forward_prob``,
    (fstack (B, D1, 1, W) f32, f_incr (B, D1) f32, lse_f (B,) f32)."""
    _check_prob(pt)
    return bfb.sweep_forward_prob(pt)


def forward_sweep_prob(pt: bfb.ProblemTensors):
    """Probability-space forward sweep of every problem of ``pt`` (one
    CUDA block each; ``sa_fwd_sweep_prob``). Returns (fstack, f_incr,
    lse_f) as ``forward_sweep_prob_ref``; on CUDA the fstack rows past a
    problem's n_diag are left unwritten. Totals lack ``pt.prob.ev_norm``.
    """
    if pt.device.type == "cpu":
        return forward_sweep_prob_ref(pt)
    _check_cuda(pt)
    _check_prob(pt)
    B, D1 = pt.x0.shape
    dev = pt.device
    fstack = torch.empty(B, D1, 1, pt.W, dtype=torch.float32, device=dev)
    f_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_f = torch.empty(B, dtype=torch.float32, device=dev)
    _launch_prob("sa_fwd_sweep_prob", pt, (fstack, f_incr, lse_f),
                 (B, D1, pt.W, pt.ref.shape[-1], pt.ev.shape[-1]))
    forward_sweep_prob.launches += 1
    return fstack, f_incr, lse_f


forward_sweep_prob.launches = 0


def backward_sweep_compact_prob_ref(pt: bfb.ProblemTensors, fstack, cvecf,
                                    threshold: float, R: int):
    """Plain twin of ``backward_sweep_compact_prob``: the full
    probability-space backward sweep (``bfb.sweep_backward_prob``), then
    the posterior, threshold and compaction of
    ``backward_sweep_compact_ref``."""
    _check_prob(pt)
    bstack, b_incr, lse_b = bfb.sweep_backward_prob(pt)
    bo, _ = bfb.backward_offsets(b_incr, lse_b)
    return (b_incr, lse_b) + _compact_ref(pt, fstack, bstack, bo, cvecf,
                                          threshold, R)


def backward_sweep_compact_prob(pt: bfb.ProblemTensors, fstack, cvecf,
                                threshold: float, R: int):
    """Probability-space backward sweep with the posterior
    exp(max(fm + bm + cvecf(d) + Bo(d), NEG)), the threshold and the
    survivor compaction fused in (``sa_bwd_sweep_compact_prob``);
    ``fstack`` from ``forward_sweep_prob``, ``cvecf`` (B, D1) float64 =
    Fo(d) - total_f with the event-normalised total. Returns (b_incr,
    lse_b, slot_cell, slot_val, cnt) as ``backward_sweep_compact``: ``cnt``
    counts every survivor of a diagonal, past R too (a tripped problem's
    +inf or NaN cvecf makes every in-band cell survive or none); no slot
    past R is written."""
    if pt.device.type == "cpu":
        return backward_sweep_compact_prob_ref(pt, fstack, cvecf, threshold,
                                               R)
    _check_cuda(pt)
    _check_prob(pt)
    B, D1 = pt.x0.shape
    dev = pt.device
    _check_out("fstack", fstack, (B, D1, 1, pt.W), torch.float32, dev)
    _check_out("cvecf", cvecf, (B, D1), torch.float64, dev)
    b_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_b = torch.empty(B, dtype=torch.float32, device=dev)
    slot_cell = torch.empty(B, D1, R, dtype=torch.int32, device=dev)
    slot_val = torch.empty(B, D1, R, dtype=torch.float32, device=dev)
    cnt = torch.empty(B, D1, dtype=torch.int32, device=dev)
    _launch_prob("sa_bwd_sweep_compact_prob", pt,
                 (fstack, cvecf, b_incr, lse_b, slot_cell, slot_val, cnt),
                 (B, D1, pt.W, pt.ref.shape[-1], pt.ev.shape[-1], R),
                 (float(threshold),))
    backward_sweep_compact_prob.launches += 1
    return b_incr, lse_b, slot_cell, slot_val, cnt


backward_sweep_compact_prob.launches = 0


def reset_launch_counts() -> None:
    for fn in (forward_sweep, backward_sweep_compact):
        fn.launches = 0
        fn.expect_launches = 0
        fn.expect_paths_launches = 0
        fn.expect_pair2_launches = 0
        fn.wide_launches = 0
        fn.cluster_launches = 0
        fn.wide_scratch_launches = 0
    expect_sums.launches = 0
    forward_sweep_prob.launches = 0
    backward_sweep_compact_prob.launches = 0


# --------------------------------------------------------------- aligner

def survivor_slots(threshold: float) -> int:
    """Slots per diagonal that cannot overflow: an alignment path crosses
    each anti-diagonal once, in one state and on one path, so the match
    posteriors of one diagonal sum to at most 1 over all offsets and
    paths, and at most floor(1/threshold) reach it."""
    return int(1.0 / threshold) + 1


def decode_pairs(problem: bfb.BandedProblem, d: np.ndarray, cell: np.ndarray,
                 val: np.ndarray, P: int) -> List[tuple]:
    """(prob_int, x, y, kmer) pairs, 0-based, from survivors in (diagonal,
    band offset, path) order, which is the JAX order: (x+y, x), then path
    ascending. Cells on a path slot the position does not have are
    dropped, as ``extract_aligned_pairs`` drops them."""
    x = problem.x0[d].astype(np.int64) + cell // P
    y = d - x
    prob = (np.minimum(val, 1.0).astype(np.float64) * 10000000).astype(np.int64)
    if problem.path_kmers is None:
        seq, k = problem.seq, problem.kmer_len
        return [(int(p), int(xi) - 1, int(yi) - 1, seq[xi - 1:xi - 1 + k])
                for p, xi, yi in zip(prob, x, y)]
    out = []
    for p, xi, yi, pi in zip(prob, x, y, cell % P):
        kmer = problem.path_kmer_at(int(xi), int(pi))
        if kmer is not None:
            out.append((int(p), int(xi) - 1, int(yi) - 1, kmer))
    return out


def _check_fits(problems: Sequence[bfb.BandedProblem], W: int,
                device: torch.device, expect: bool) -> None:
    """Raises MemoryError, with its byte count, for a bucket whose longest
    problem's stacks (three rows per diagonal with ``expect``, one
    otherwise; the forward's, and on a bucket of ``expect_split`` the
    backward's too) alone exceed the CUDA device's memory: the one shape
    the sweeps refuse."""
    if device.type != "cuda" or not problems:
        return
    P = max(p.ref_params.shape[1] for p in problems)
    D1 = max(p.n_diag for p in problems) + 1
    stacks = 2 if expect and expect_split(W, P) else 1
    need = D1 * (3 if expect else 1) * P * W * 4 * stacks
    total = torch.cuda.get_device_properties(device).total_memory
    if need > total:
        raise MemoryError(
            f"a problem of P={P} paths at W={W} over {D1} diagonals needs "
            f"{need} bytes of stacks, more than the device's {total}")


class HopperAligner:
    """One bucket of problems with P >= 1 paths per cell on one device.
    A MODE_HDP bucket takes ``hdp_tables``: the run's HDP tables, already
    on ``device`` (``convert.hdp_tables``). ``expect`` makes the bucket
    run the EM expectation pass (``run``, ``execute`` and
    ``expect`` then add the expectations); its tensors carry the k-mer ids
    that key the emission moments.

    ``log_space=False`` runs the probability-space sweeps (the JAX
    ``PallasBatchAligner(log_space=False)``), which take P = 1 Gaussian
    buckets of W <= 512 without expectations only. Their f32 window
    covers ~157 nats below each diagonal's ridge: a problem whose forward
    and backward totals are not within 1 nat, or whose survivors overflow
    a diagonal's slots, is flagged ``numerics_suspect``, reports no
    pairs, and must be re-run on the exact (log-space) sweeps."""

    def __init__(self, problems: Sequence[bfb.BandedProblem], W: int,
                 device: torch.device,
                 hdp_tables: Optional[bfb.HdpTables] = None,
                 expect: bool = False, log_space: bool = True):
        self.problems = list(problems)
        _check_fits(self.problems, W, device, expect)
        if not log_space and expect:
            bfb.check_prob(W, 1, hdp_tables is not None, expect)
        self.pt = problem_tensors(self.problems, W, device, hdp_tables,
                                  kmer_ids=expect, prob=not log_space)
        self.with_expectations = expect
        self.log_space = log_space

    def _survivors(self, threshold: float):
        """Both sweeps on the device; returns device tensors (problem b,
        diagonal d, cell, val) of every survivor in (problem, diagonal,
        offset, path) order, survivors per problem n, float64 total_f /
        total_b, the per-problem bool ``numerics_suspect`` (the JAX form:
        not |total_f - total_b| < 1, or, in probability space, a
        survivor-slot overflow; a suspect probability-space problem keeps
        no survivors), and in an expectation pass texp (B, 7) and kx (B,
        3, P, LX)."""
        pt = self.pt
        R = survivor_slots(threshold)
        expect = self.with_expectations
        nds = pt.meta[:, bfb.M_NDIAG]
        if self.log_space:
            fstack, f_incr, lse_f = forward_sweep(pt, expect)
        else:
            fstack, f_incr, lse_f = forward_sweep_prob(pt)
        # the probability-space totals are event-normalised: cvecf uses
        # them as they are, and only the reported totals get ev_norm
        fo, total_f = bfb.forward_offsets(f_incr, lse_f, nds)
        cvecf = (fo - total_f[:, None]).contiguous()
        if self.log_space:
            outs = backward_sweep_compact(pt, fstack, cvecf, threshold, R,
                                          expect)
        else:
            outs = backward_sweep_compact_prob(pt, fstack, cvecf, threshold,
                                               R)
        b_incr, lse_b, slot_cell, slot_val, cnt = outs[:5]
        del fstack
        _, total_b = bfb.backward_offsets(b_incr, lse_b)
        suspect = ~((total_f - total_b).abs() < 1.0)
        if self.log_space:
            cmax = int(cnt.max())
            if cmax > R:
                raise RuntimeError(f"{cmax} survivors on one diagonal exceed "
                                   f"the {R} slots")
        else:
            suspect |= cnt.amax(dim=1) > R
            cnt = torch.where(suspect[:, None], 0, cnt)
            total_f = total_f + pt.prob.ev_norm
            total_b = total_b + pt.prob.ev_norm
        # flatten: the first cnt slots of every (problem, diagonal), in order
        keep = torch.arange(R, device=cnt.device) < cnt[:, :, None]
        b, d, _ = keep.nonzero(as_tuple=True)
        return (b, d, slot_cell[keep], slot_val[keep], cnt.sum(dim=1),
                total_f, total_b, suspect) + tuple(outs[5:])

    def run(self, threshold: float = 0.01) -> Dict[str, np.ndarray]:
        """Both sweeps and the survivor flattening; returns host arrays:
        diagonal "d", cell "cell" (o*P + p) and posterior "val" of every
        survivor in (problem, diagonal, offset, path) order, survivors per
        problem "n", float64 "total_f" / "total_b" and the per-problem
        bool "suspect" (``_survivors``). The expectation
        pass adds "texp" (B, 3, 3) [from, to] and, in a Gaussian bucket,
        "kexp" (B, 3, num_kmers) [Σp, Σp·dx, Σp·dx²] by k-mer, float64."""
        outs = self._survivors(threshold)
        _, d, cell, val, n, total_f, total_b, suspect = outs[:8]
        arrays = [("d", d.int()), ("cell", cell), ("val", val), ("n", n),
                  ("total_f", total_f), ("total_b", total_b),
                  ("suspect", suspect)]
        if self.with_expectations:
            texp7, kx = outs[8:]
            arrays.append(("texp", bfb.texp_matrix(texp7)))
            if self.pt.hdp is None:
                arrays.append(("kexp", bfb.kexp_by_kmer(
                    kx, self.pt.kid, self.problems[0].num_kmers)))
        return {k: v.cpu().numpy() for k, v in arrays}

    def decode(self, arrays: Dict[str, np.ndarray]) -> List[Dict]:
        """Per-problem {"pairs", "total_f", "total_b", "numerics_suspect"}
        from ``run``'s arrays, and from an expectation pass's "texp" (3, 3)
        and "kexp":
        (3, num_kmers), or zeros (3, 1) in MODE_HDP (the TPU kernel's
        contract: HDP emissions train from assignments, not moments)."""
        results = []
        start = 0
        for i, p in enumerate(self.problems):
            sl = slice(start, start + int(arrays["n"][i]))
            start = sl.stop
            results.append({
                "pairs": decode_pairs(p, arrays["d"][sl].astype(np.int64),
                                      arrays["cell"][sl].astype(np.int64),
                                      arrays["val"][sl], self.pt.P),
                "total_f": float(arrays["total_f"][i]),
                "total_b": float(arrays["total_b"][i]),
                "numerics_suspect": bool(arrays["suspect"][i])})
            if "texp" in arrays:
                results[-1]["texp"] = arrays["texp"][i]
                results[-1]["kexp"] = (arrays["kexp"][i] if "kexp" in arrays
                                       else np.zeros((3, 1)))
        return results

    def execute(self, threshold: float = 0.01) -> List[Dict]:
        """Per-problem {"pairs", "total_f", "total_b", "numerics_suspect"}
        (and the expectations, see ``decode``)."""
        return self.decode(self.run(threshold))

    def expect(self, threshold: float = 0.01) -> List[Dict]:
        """The EM expectation pass of an aligner made with ``expect=True``,
        the counterpart of ``PallasBatchAligner.execute_expect``: per
        problem {"pairs", "total_f", "total_b", "texp", "kexp"}."""
        if not self.with_expectations:
            raise ValueError("HopperAligner made without expect=True")
        return self.execute(threshold)

    def site_sums(self, sites: Sequence[Sequence[int]],
                  threshold: float = 0.01) -> List[Dict]:
        """Per-site posterior sums on the device: the counterpart of
        ``PallasBatchAligner.execute_site_marginals``.

        ``sites[i]``: the 1-based cells x of problem i whose k-mer reports
        at a site. Every survivor at a site cell adds its posterior to a
        (B, n_sites, P) float32 table (``index_add_``); only that table
        and the totals are fetched. This equals folding the reported pairs
        (``variant_caller.marginals_from_pairs``): the same threshold, no
        quantisation. Returns per problem {"site_probs" (P, n_sites)
        float64, "total_f", "total_b", "numerics_suspect"}.
        """
        pt = self.pt
        B, P = len(self.problems), pt.P
        NS = max([len(s) for s in sites] + [1])
        slot = np.full((B, pt.ref.shape[-1]), -1, np.int64)
        for i, xs in enumerate(sites):
            slot[i, np.asarray(xs, dtype=np.int64)] = np.arange(len(xs))
        slot = torch.from_numpy(slot).to(pt.device)
        b, d, cell, val, _, total_f, total_b, suspect = \
            self._survivors(threshold)[:8]
        cell = cell.long()
        x = pt.x0[b, d].long() + cell // P
        s = slot[b, x]
        hit = s >= 0
        table = torch.zeros(B * NS * P, dtype=torch.float32, device=pt.device)
        table.index_add_(0, ((b * NS + s) * P + cell % P)[hit], val[hit])
        table = table.view(B, NS, P).cpu().numpy().astype(np.float64)
        total_f = total_f.cpu().numpy()
        total_b = total_b.cpu().numpy()
        suspect = suspect.cpu().numpy()
        return [{"site_probs": table[i, :len(xs)].T,
                 "total_f": float(total_f[i]), "total_b": float(total_b[i]),
                 "numerics_suspect": bool(suspect[i])}
                for i, xs in enumerate(sites)]
