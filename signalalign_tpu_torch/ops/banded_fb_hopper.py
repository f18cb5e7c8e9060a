"""The canonical slice's two Hopper kernels, their plain twins, and the
aligner that drives them over one bucket.

``forward_sweep`` launches ``sa_fwd_sweep`` and ``backward_sweep_compact``
launches ``sa_bwd_sweep_compact`` (``csrc/banded_fb.cu``) on CUDA tensors;
on CPU tensors each uses its plain twin (``forward_sweep_ref``,
``backward_sweep_compact_ref``), which has the same signature and output
contract. A CUDA tensor never falls back: a missing ``nvcc``, a failed
build or a refused launch raises. Each wrapper counts its kernel launches
in ``<wrapper>.launches``.

``HopperAligner`` is the counterpart of the JAX package's
``PallasAligner.execute`` (``ops/banded_fb_pallas.py``) and of the
``fuse_compact`` branch of ``PallasBatchAligner.execute_async``
(``ops/banded_fb_pallas_batch.py``): forward sweep, float64 normaliser
scan, backward sweep with in-sweep posterior + compaction, survivor
flattening, decode to aligned pairs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from signalalign_tpu_torch.convert import problem_tensors
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.utils import cuda_build

MAX_W = 4096   # the backward kernel keeps <= 4 band offsets per thread


def _check_cuda(pt: bfb.ProblemTensors) -> None:
    if pt.device.type != "cuda":
        raise ValueError(f"tensors on {pt.device}: the kernels run on CUDA")
    if pt.W > MAX_W:
        raise ValueError(f"W={pt.W} exceeds the kernels' limit of {MAX_W}")
    for name, dtype in (("x0", torch.int32), ("width", torch.int32),
                        ("ref", torch.float32), ("ev", torch.float32),
                        ("meta", torch.int32), ("par", torch.float32)):
        t = getattr(pt, name)
        if t.dtype != dtype or not t.is_contiguous() or t.device != pt.device:
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{pt.device}, got {t.dtype} on {t.device}")
    B, D1 = pt.x0.shape
    if (pt.width.shape != (B, D1) or pt.ref.shape[:2] != (B, bfb.NREF)
            or pt.ev.shape[:2] != (B, bfb.NEV)
            or pt.meta.shape != (B, bfb.NMETA)
            or pt.par.shape != (B, bfb.NPACK)):
        raise ValueError("ProblemTensors shapes disagree")


def _launch(name: str, pt: bfb.ProblemTensors, tensors, *scalars) -> None:
    """Call C entry point ``name`` with the pointers of ``pt``'s tensors,
    then of ``tensors``, then ``scalars`` and the current stream of
    ``pt``'s device; raises if the launch was refused."""
    fn = getattr(cuda_build.load(), name)
    ptrs = [t.data_ptr() for t in (pt.x0, pt.width, pt.ref, pt.ev, pt.meta,
                                   pt.par, *tensors)]
    with torch.cuda.device(pt.device):
        rc = fn(*ptrs, *scalars, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# --------------------------------------------------------------- forward

def forward_sweep_ref(pt: bfb.ProblemTensors):
    """Plain twin of ``forward_sweep``: (fstack (B, D1, W) f32, f_incr
    (B, D1) f32, lse_f (B,) f32)."""
    return bfb.sweep_forward(pt)


def forward_sweep(pt: bfb.ProblemTensors):
    """Forward sweep of every problem of ``pt`` (one CUDA block each).

    Returns (fstack, f_incr, lse_f) as ``forward_sweep_ref``; on CUDA the
    fstack rows past a problem's n_diag are left unwritten.
    """
    if pt.device.type == "cpu":
        return forward_sweep_ref(pt)
    _check_cuda(pt)
    B, D1 = pt.x0.shape
    W = pt.W
    dev = pt.device
    fstack = torch.empty(B, D1, W, dtype=torch.float32, device=dev)
    f_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_f = torch.empty(B, dtype=torch.float32, device=dev)
    _launch("sa_fwd_sweep", pt, (fstack, f_incr, lse_f),
            B, D1, W, pt.ref.shape[2], pt.ev.shape[2])
    forward_sweep.launches += 1
    return fstack, f_incr, lse_f


forward_sweep.launches = 0


# ------------------------------------------------------------- backward

def backward_sweep_compact_ref(pt: bfb.ProblemTensors, fstack, cvecf,
                               threshold: float, R: int):
    """Plain twin of ``backward_sweep_compact``: the full backward sweep,
    then the posterior, threshold and rank compaction over the stack.

    Returns (b_incr (B, D1) f32, lse_b (B,) f32, slot_off (B, D1, R) int32
    band offsets, slot_val (B, D1, R) f32 posteriors, cnt (B, D1) int32
    survivors per diagonal); slots at ranks >= cnt hold -1 / 0.
    """
    bstack, b_incr, lse_b = bfb.sweep_backward(pt)
    bo, _ = bfb.backward_offsets(b_incr, lse_b)
    c = (cvecf + bo).float()
    p = torch.exp(torch.clamp(fstack + bstack + c[:, :, None], min=bfb.NEG))
    surv = bfb.cell_mask(pt) & (p >= threshold)
    rank = torch.cumsum(surv, dim=2) - 1
    cnt = surv.sum(dim=2, dtype=torch.int32)
    keep = surv & (rank < R)
    B, D1 = pt.x0.shape
    slot_off = torch.full((B, D1, R), -1, dtype=torch.int32, device=pt.device)
    slot_val = torch.zeros(B, D1, R, dtype=torch.float32, device=pt.device)
    bi, di, oi = keep.nonzero(as_tuple=True)
    ri = rank[keep]
    slot_off[bi, di, ri] = oi.int()
    slot_val[bi, di, ri] = p[keep]
    return b_incr, lse_b, slot_off, slot_val, cnt


def backward_sweep_compact(pt: bfb.ProblemTensors, fstack, cvecf,
                           threshold: float, R: int):
    """Backward sweep with the posterior, threshold and survivor
    compaction fused in; ``cvecf`` (B, D1) float64 is Fo(d) - total_f.

    Returns (b_incr, lse_b, slot_off, slot_val, cnt) as
    ``backward_sweep_compact_ref``; survivors of one diagonal are in
    band-offset order, and ``cnt`` counts them all even past R.
    """
    if pt.device.type == "cpu":
        return backward_sweep_compact_ref(pt, fstack, cvecf, threshold, R)
    _check_cuda(pt)
    B, D1 = pt.x0.shape
    W = pt.W
    dev = pt.device
    if (fstack.shape != (B, D1, W) or fstack.dtype != torch.float32
            or not fstack.is_contiguous() or fstack.device != dev):
        raise ValueError("fstack: need a contiguous (B, D1, W) float32 "
                         "tensor on the problems' device")
    if (cvecf.shape != (B, D1) or cvecf.dtype != torch.float64
            or not cvecf.is_contiguous() or cvecf.device != dev):
        raise ValueError("cvecf: need a contiguous (B, D1) float64 tensor "
                         "on the problems' device")
    b_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_b = torch.empty(B, dtype=torch.float32, device=dev)
    slot_off = torch.empty(B, D1, R, dtype=torch.int32, device=dev)
    slot_val = torch.empty(B, D1, R, dtype=torch.float32, device=dev)
    cnt = torch.empty(B, D1, dtype=torch.int32, device=dev)
    _launch("sa_bwd_sweep_compact", pt,
            (fstack, cvecf, b_incr, lse_b, slot_off, slot_val, cnt),
            B, D1, W, pt.ref.shape[2], pt.ev.shape[2], R, float(threshold))
    backward_sweep_compact.launches += 1
    return b_incr, lse_b, slot_off, slot_val, cnt


backward_sweep_compact.launches = 0


def reset_launch_counts() -> None:
    forward_sweep.launches = 0
    backward_sweep_compact.launches = 0


# --------------------------------------------------------------- aligner

def survivor_slots(threshold: float) -> int:
    """Slots per diagonal that cannot overflow: an alignment path crosses
    each anti-diagonal at most once, so the match posteriors of one
    diagonal sum to at most 1 and at most floor(1/threshold) reach it."""
    return int(1.0 / threshold) + 1


def decode_pairs(problem: bfb.BandedProblem, d: np.ndarray, off: np.ndarray,
                 val: np.ndarray) -> List[tuple]:
    """(prob_int, x, y, kmer) pairs, 0-based, from survivors in (diagonal,
    band offset) order (which is the (x+y, x) output order)."""
    x = problem.x0[d].astype(np.int64) + off
    y = d - x
    prob = (np.minimum(val, 1.0).astype(np.float64) * 10000000).astype(np.int64)
    if problem.path_kmers is None:
        seq, k = problem.seq, problem.kmer_len
        return [(int(p), int(xi) - 1, int(yi) - 1, seq[xi - 1:xi - 1 + k])
                for p, xi, yi in zip(prob, x, y)]
    return [(int(p), int(xi) - 1, int(yi) - 1, problem.path_kmer_at(int(xi), 0))
            for p, xi, yi in zip(prob, x, y)]


class HopperAligner:
    """One bucket of P=1 mean-only problems on one device."""

    def __init__(self, problems: Sequence[bfb.BandedProblem], W: int,
                 device: torch.device):
        self.problems = list(problems)
        self.pt = problem_tensors(self.problems, W, device)

    def run(self, threshold: float = 0.01) -> Dict[str, np.ndarray]:
        """Both sweeps and the survivor flattening; returns host arrays:
        diagonal "d", band offset "off" and posterior "val" of every
        survivor in (problem, diagonal, offset) order, survivors per
        problem "n", and float64 "total_f" / "total_b"."""
        pt = self.pt
        R = survivor_slots(threshold)
        fstack, f_incr, lse_f = forward_sweep(pt)
        fo, total_f = bfb.forward_offsets(f_incr, lse_f, pt.meta[:, bfb.M_NDIAG])
        cvecf = (fo - total_f[:, None]).contiguous()
        b_incr, lse_b, slot_off, slot_val, cnt = backward_sweep_compact(
            pt, fstack, cvecf, threshold, R)
        del fstack
        _, total_b = bfb.backward_offsets(b_incr, lse_b)

        # flatten: the first cnt slots of every (problem, diagonal), in order
        keep = torch.arange(R, device=cnt.device) < cnt[:, :, None]
        _, di, _ = keep.nonzero(as_tuple=True)
        out = {k: v.cpu().numpy() for k, v in (
            ("d", di.int()), ("off", slot_off[keep]), ("val", slot_val[keep]),
            ("n", cnt.sum(dim=1)), ("cmax", cnt.max(dim=1).values),
            ("total_f", total_f), ("total_b", total_b))}
        if (out["cmax"] > R).any():
            raise RuntimeError(f"{int(out['cmax'].max())} survivors on one "
                               f"diagonal exceed the {R} slots")
        return out

    def decode(self, arrays: Dict[str, np.ndarray]) -> List[Dict]:
        """Per-problem {"pairs", "total_f", "total_b"} from ``run``'s arrays."""
        results = []
        start = 0
        for i, p in enumerate(self.problems):
            sl = slice(start, start + int(arrays["n"][i]))
            start = sl.stop
            results.append({
                "pairs": decode_pairs(p, arrays["d"][sl].astype(np.int64),
                                      arrays["off"][sl].astype(np.int64),
                                      arrays["val"][sl]),
                "total_f": float(arrays["total_f"][i]),
                "total_b": float(arrays["total_b"][i])})
        return results

    def execute(self, threshold: float = 0.01) -> List[Dict]:
        """Per-problem {"pairs", "total_f", "total_b"}."""
        return self.decode(self.run(threshold))
