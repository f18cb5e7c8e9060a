"""The port's two Hopper kernels, their plain twins, and the aligner that
drives them over one bucket of problems with 1 <= P <= 8 paths per cell,
Gaussian (MODE_MEAN_ONLY) or HDP (MODE_HDP) emissions.

``forward_sweep`` launches ``sa_fwd_sweep`` and ``backward_sweep_compact``
launches ``sa_bwd_sweep_compact`` (``csrc/banded_fb.cu``) on CUDA tensors;
on CPU tensors each uses its plain twin (``forward_sweep_ref``,
``backward_sweep_compact_ref``), which has the same signature and output
contract. An HDP bucket's tensors carry its k-mer ids, level means and
the run's shared density tables (``ProblemTensors.kid``/``mu``/``hdp``),
which the kernels' HDP instances read. A CUDA tensor never falls back: a
missing ``nvcc``, a failed build, a shape the kernels do not take, a
missing table or a refused launch raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

``HopperAligner`` is the counterpart of the JAX package's
``PallasAligner.execute`` (``ops/banded_fb_pallas.py``), of
``PallasBatchAligner.execute_async`` (``ops/banded_fb_pallas_batch.py``;
the P = 1 ``fuse_compact`` branch, the P > 1 ``fuse_post`` +
``_compact_map_kernel`` branch and the ``estream`` HDP branch with its
``emission_stream.hdp_emission_stacks``) and of its
``execute_site_marginals``:
forward sweep, float64 normaliser scan, backward sweep with in-sweep
posterior + survivor compaction, then either the survivors decoded to
aligned pairs or their posteriors summed per site on the device.
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
               ("ref", pt.ref, f32), ("leg", pt.leg, torch.int64),
               ("ev", pt.ev, f32), ("meta", pt.meta, i32),
               ("par", pt.par, f32)]
    hdp = pt.hdp is not None
    if hdp:
        tensors += [("kid", pt.kid, i32), ("mu", pt.mu, f32),
                    ("hdp.dens", pt.hdp.dens, f32),
                    ("hdp.slopes", pt.hdp.slopes, f32)]
    elif pt.kid is not None or pt.mu is not None:
        raise ValueError("k-mer id / level-mean tensors without HDP tables")
    for name, t, dtype in tensors:
        if (t is None or t.dtype != dtype or not t.is_contiguous()
                or t.device != pt.device):
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{pt.device}")
    B, D1 = pt.x0.shape
    LX = pt.ref.shape[-1]
    if (pt.width.shape != (B, D1) or pt.ref.shape[:3] != (B, bfb.NREF, pt.P)
            or pt.leg.shape != (B, LX) or pt.ev.shape[:2] != (B, bfb.NEV)
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


def _launch(name: str, pt: bfb.ProblemTensors, tensors, ints,
            floats=()) -> None:
    """Call C entry point ``name`` with the pointers of ``pt``'s tensors
    and HDP tables (null for a Gaussian bucket), then of ``tensors``, then
    ``ints``, the HDP table sizes, ``floats``, the HDP grid and the
    current stream of ``pt``'s device; raises if the launch was refused."""
    fn = getattr(cuda_build.load(), name)
    h = pt.hdp
    hdp_ptrs = ([t.data_ptr() for t in (pt.kid, pt.mu, h.dens, h.slopes)]
                if h is not None else [None] * 4)
    ptrs = [t.data_ptr() for t in (pt.x0, pt.width, pt.ref, pt.leg, pt.ev,
                                   pt.meta, pt.par)]
    ptrs += hdp_ptrs + [t.data_ptr() for t in tensors]
    sizes = (h.K, h.NG) if h is not None else (0, 0)
    grid = (h.g0, h.dx, h.gN) if h is not None else (0.0, 0.0, 0.0)
    with torch.cuda.device(pt.device):
        rc = fn(*ptrs, *ints, *sizes, *floats, *grid,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (P={pt.P}, W={pt.W}): "
                           f"CUDA error {rc}")


# --------------------------------------------------------------- forward

def forward_sweep_ref(pt: bfb.ProblemTensors):
    """Plain twin of ``forward_sweep``: (fstack (B, D1, P, W) f32, f_incr
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
    dev = pt.device
    fstack = torch.empty(B, D1, pt.P, pt.W, dtype=torch.float32, device=dev)
    f_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_f = torch.empty(B, dtype=torch.float32, device=dev)
    _launch("sa_fwd_sweep", pt, (fstack, f_incr, lse_f),
            (B, D1, pt.W, pt.P, pt.ref.shape[-1], pt.ev.shape[-1]))
    forward_sweep.launches += 1
    return fstack, f_incr, lse_f


forward_sweep.launches = 0


# ------------------------------------------------------------- backward

def backward_sweep_compact_ref(pt: bfb.ProblemTensors, fstack, cvecf,
                               threshold: float, R: int):
    """Plain twin of ``backward_sweep_compact``: the full backward sweep,
    then the posterior, threshold and rank compaction over the stack.

    Returns (b_incr (B, D1) f32, lse_b (B,) f32, slot_cell (B, D1, R)
    int32 cells o*P + p, slot_val (B, D1, R) f32 posteriors, cnt (B, D1)
    int32 survivors per diagonal); slots at ranks >= cnt hold -1 / 0.
    Survivors of a diagonal rank in (band offset, path) order.
    """
    bstack, b_incr, lse_b = bfb.sweep_backward(pt)
    bo, _ = bfb.backward_offsets(b_incr, lse_b)
    c = (cvecf + bo).float()
    p = torch.exp(torch.clamp(fstack + bstack + c[:, :, None, None],
                              min=bfb.NEG))
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
    return b_incr, lse_b, slot_cell, slot_val, cnt


def backward_sweep_compact(pt: bfb.ProblemTensors, fstack, cvecf,
                           threshold: float, R: int):
    """Backward sweep with the posterior, threshold and survivor
    compaction fused in; ``cvecf`` (B, D1) float64 is Fo(d) - total_f.

    Returns (b_incr, lse_b, slot_cell, slot_val, cnt) as
    ``backward_sweep_compact_ref``; ``cnt`` counts every survivor of a
    diagonal even past R.
    """
    if pt.device.type == "cpu":
        return backward_sweep_compact_ref(pt, fstack, cvecf, threshold, R)
    _check_cuda(pt)
    B, D1 = pt.x0.shape
    dev = pt.device
    _check_out("fstack", fstack, (B, D1, pt.P, pt.W), torch.float32, dev)
    _check_out("cvecf", cvecf, (B, D1), torch.float64, dev)
    b_incr = torch.empty(B, D1, dtype=torch.float32, device=dev)
    lse_b = torch.empty(B, dtype=torch.float32, device=dev)
    slot_cell = torch.empty(B, D1, R, dtype=torch.int32, device=dev)
    slot_val = torch.empty(B, D1, R, dtype=torch.float32, device=dev)
    cnt = torch.empty(B, D1, dtype=torch.int32, device=dev)
    _launch("sa_bwd_sweep_compact", pt,
            (fstack, cvecf, b_incr, lse_b, slot_cell, slot_val, cnt),
            (B, D1, pt.W, pt.P, pt.ref.shape[-1], pt.ev.shape[-1], R),
            (float(threshold),))
    backward_sweep_compact.launches += 1
    return b_incr, lse_b, slot_cell, slot_val, cnt


backward_sweep_compact.launches = 0


def reset_launch_counts() -> None:
    forward_sweep.launches = 0
    backward_sweep_compact.launches = 0


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


class HopperAligner:
    """One bucket of problems with 1 <= P <= 8 paths per cell on one
    device. A MODE_HDP bucket takes ``hdp_tables``: the run's HDP tables,
    already on ``device`` (``convert.hdp_tables``)."""

    def __init__(self, problems: Sequence[bfb.BandedProblem], W: int,
                 device: torch.device,
                 hdp_tables: Optional[bfb.HdpTables] = None):
        self.problems = list(problems)
        self.pt = problem_tensors(self.problems, W, device, hdp_tables)

    def _survivors(self, threshold: float):
        """Both sweeps on the device; returns device tensors (problem b,
        diagonal d, cell, val) of every survivor in (problem, diagonal,
        offset, path) order, survivors per problem n, and float64
        total_f / total_b."""
        pt = self.pt
        R = survivor_slots(threshold)
        fstack, f_incr, lse_f = forward_sweep(pt)
        fo, total_f = bfb.forward_offsets(f_incr, lse_f, pt.meta[:, bfb.M_NDIAG])
        cvecf = (fo - total_f[:, None]).contiguous()
        b_incr, lse_b, slot_cell, slot_val, cnt = backward_sweep_compact(
            pt, fstack, cvecf, threshold, R)
        del fstack
        _, total_b = bfb.backward_offsets(b_incr, lse_b)
        cmax = int(cnt.max())
        if cmax > R:
            raise RuntimeError(f"{cmax} survivors on one diagonal exceed "
                               f"the {R} slots")
        # flatten: the first cnt slots of every (problem, diagonal), in order
        keep = torch.arange(R, device=cnt.device) < cnt[:, :, None]
        b, d, _ = keep.nonzero(as_tuple=True)
        return (b, d, slot_cell[keep], slot_val[keep], cnt.sum(dim=1),
                total_f, total_b)

    def run(self, threshold: float = 0.01) -> Dict[str, np.ndarray]:
        """Both sweeps and the survivor flattening; returns host arrays:
        diagonal "d", cell "cell" (o*P + p) and posterior "val" of every
        survivor in (problem, diagonal, offset, path) order, survivors per
        problem "n", and float64 "total_f" / "total_b"."""
        _, d, cell, val, n, total_f, total_b = self._survivors(threshold)
        return {k: v.cpu().numpy() for k, v in (
            ("d", d.int()), ("cell", cell), ("val", val), ("n", n),
            ("total_f", total_f), ("total_b", total_b))}

    def decode(self, arrays: Dict[str, np.ndarray]) -> List[Dict]:
        """Per-problem {"pairs", "total_f", "total_b"} from ``run``'s arrays."""
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
                "total_b": float(arrays["total_b"][i])})
        return results

    def execute(self, threshold: float = 0.01) -> List[Dict]:
        """Per-problem {"pairs", "total_f", "total_b"}."""
        return self.decode(self.run(threshold))

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
        float64, "total_f", "total_b"}.
        """
        pt = self.pt
        B, P = len(self.problems), pt.P
        NS = max([len(s) for s in sites] + [1])
        slot = np.full((B, pt.ref.shape[-1]), -1, np.int64)
        for i, xs in enumerate(sites):
            slot[i, np.asarray(xs, dtype=np.int64)] = np.arange(len(xs))
        slot = torch.from_numpy(slot).to(pt.device)
        b, d, cell, val, _, total_f, total_b = self._survivors(threshold)
        cell = cell.long()
        x = pt.x0[b, d].long() + cell // P
        s = slot[b, x]
        hit = s >= 0
        table = torch.zeros(B * NS * P, dtype=torch.float32, device=pt.device)
        table.index_add_(0, ((b * NS + s) * P + cell % P)[hit], val[hit])
        table = table.view(B, NS, P).cpu().numpy().astype(np.float64)
        total_f = total_f.cpu().numpy()
        total_b = total_b.cpu().numpy()
        return [{"site_probs": table[i, :len(xs)].T,
                 "total_f": float(total_f[i]), "total_b": float(total_b[i])}
                for i, xs in enumerate(sites)]
