"""Each Hopper kernel of the port against its plain PyTorch twin on the
card, for P = 1 and for P = 2, 4, 8 and 16 paths per cell, with every
kernel instance (1, 2, 4 and 8 cells per thread of the P > 2 instances,
at P = 1 too past 2048 cells; the per-pair instances of P <= 2 at each
K the dispatch table uses, on shapes that select it), with Gaussian and
with HDP emissions, the EM expectation instances (P = 1 per-pair at each
K the table uses; the P > 2 and wide instances' expectation pass at P =
2, 4, 8, 16, 64 and at P = 1 W = 2304, the wide ones on the cluster
instance and past its CAP on the scratch instance; Gaussian and HDP),
and the
probability-space kernels (P = 1, W = 256 and 512, and
segments that exhaust their f32 range). Needs a CUDA GPU and nvcc;
skipped without a GPU. On a GPU host:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances (same formulas, built without multiply-add contraction; only
the final logsumexp reductions sum in another order): totals within
1e-2 nats, posteriors within 1e-4, survivor sets equal except cells
within 1e-4 of the threshold; the expectation instances' three-state
stacks, offsets and survivors equal their twins', and their texp and kx
(per-cell float32 terms summed in float64, in another association than
the twin's XLA-form core) within 1e-5 relative of the twin's (P = 1 per
pair) or 1e-3 of its largest value (P > 1 summed in the sweep), and
within 1e-6 of it where sa_expect_sums adds the twin's own terms (the
P > 2 register instances' buckets).
"""

import numpy as np
import pytest
import torch

from signalalign_tpu_torch.convert import hdp_tables, problem_tensors
from signalalign_tpu_torch.models.pore_model import ScalingParams
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.utils.synthetic import (outlier_segments,
                                                   synthetic_hdp,
                                                   synthetic_pore_model)

pytestmark = pytest.mark.cuda
THR = 0.01


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


# HDP cases: a 5-mer ACEGT model, its synthetic HDP on the trainer's grid
# (30-180 pA, 1200 points) and the code P (C or E)
HDP_MODEL = None


def _hdp_model():
    global HDP_MODEL
    if HDP_MODEL is None:
        model = synthetic_pore_model(0, "ACEGT", 5)
        HDP_MODEL = model, synthetic_hdp(model, 1)
    return HDP_MODEL


def _problems(n, sizes, gap, W, Dpad, seed, P=1, hdp=False, dense=None,
              prep_w=None, cluster_at=200):
    """n problems with random lengths in ``sizes`` whose anchors (every 20
    events) leave out ``gap``, so the band bulges there. For P > 1 the
    sequence carries the ambiguity code (Y, or P with ``hdp``; B for
    P = 3) every 40 positions and a cluster of log2(P) codes in one 5-mer
    every 400 from ``cluster_at`` (events read each code as C; P = 64:
    three four-way X codes in one 5-mer, read as A); ``dense`` = (start, stop)
    puts the code at every other position there, where most path pairs
    of neighbouring cells are illegal. ``prep_w`` prepares the problems
    at another band width than W. Returns (problems, the HDP or None)."""
    model, h = _hdp_model() if hdp else (synthetic_pore_model(0), None)
    code = "B" if P == 3 else "P" if hdp else "Y"
    rng = np.random.default_rng(seed)
    cluster = {1: "", 2: "Y", 3: "Y", 4: "YGY", 8: "YGYGY",
               16: "YYGYY", 64: "XGXGX"}[P].replace("Y", code)
    out = []
    for i in range(n):
        seq = list(rng.choice(list("ACGT"), size=int(rng.integers(*sizes))))
        if P > 1:
            for j in range(20, len(seq) - 8, 40):
                seq[j] = code
            for j in range(cluster_at, len(seq) - 8, 400):
                seq[j:j + len(cluster)] = cluster
        if dense:
            seq[dense[0]:dense[1]:2] = code * len(range(*dense, 2))
        seq = "".join(seq)
        ids = model.alphabet.seq_to_kmer_ids(
            seq.replace(code, "C").replace("X", "A"))
        ev = np.stack([model.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                       np.ones(len(ids)), np.full(len(ids), .005),
                       np.arange(len(ids)) * .005], 1)
        anchors = [(j, j) for j in range(8, len(ids) - 8, 20)
                   if not gap[0] < j < gap[1]]
        out.append(bfb.prepare_problem(
            seq, ev, model, ScalingParams(shift=0.1 * i), DEFAULT_AMBIG_BASES,
            W=prep_w or W, Dpad=Dpad, P=P, anchor_pairs=anchors,
            expansion=10, mode=bfb.MODE_HDP if hdp else bfb.MODE_MEAN_ONLY,
            hdp=h))
    assert max(int(p.n_paths.max()) for p in out) == P
    return out, h


@pytest.fixture(scope="module",
                params=["narrow", "wide", "p2", "p4", "p8", "p8w512", "p8wide",
                        "hdp_narrow", "hdp_p8", "hdp_p8w512", "hdp_p8wide"])
def bucket(request):
    """(problems, W, HDP or None): six W=256 P=1 problems as on the main
    path; two whose bands pass 1024 offsets (W=1280: two cells per
    thread); four W=256 problems of P = 2, 4 or 8 paths; two P=8 problems
    at W=512 (4096 cells: the four-cells-per-thread kernels); or two P=8
    problems at the widest W the runner makes (768: 6144 cells, six per
    thread). The hdp_ cases run the HDP instances at cells per thread 1
    (P=1, W=256), 2 (P=8, W=256), 4 (W=512) and 8 (W=768)."""
    name = request.param
    hdp = name.startswith("hdp_")
    name = name[4:] if hdp else name
    if name == "narrow":
        return _case(_problems(6, (200, 600), (100, 160), 256, 2048, 4,
                               hdp=hdp), 256)
    if name == "wide":
        probs = _problems(2, (1450, 1550), (200, 1300), 1280, 4096, 5)
        assert max(int(p.width.max()) for p in probs[0]) > 1024
        return _case(probs, 1280)
    if name == "p8w512":
        probs = _problems(2, (1000, 1100), (200, 550), 512, 4096, 9, P=8,
                          hdp=hdp)
        assert max(int(p.width.max()) for p in probs[0]) > 256
        return _case(probs, 512)
    if name == "p8wide":
        probs = _problems(2, (1300, 1400), (200, 850), 768, 4096, 7, P=8,
                          hdp=hdp)
        assert max(int(p.width.max()) for p in probs[0]) > 512
        return _case(probs, 768)
    P = int(name[1:])
    return _case(_problems(4, (700, 900), (100, 300), 256, 2048, 10 + P, P=P,
                           hdp=hdp), 256)


def _case(problems_hdp, W):
    problems, h = problems_hdp
    return problems, W, h


def _hdp_tables(h, dev):
    return hdp_tables(*h.density_arrays(), dev) if h is not None else None


def _tensors(bucket, dev):
    problems, W, h = bucket
    return problem_tensors(problems, W, dev, _hdp_tables(h, dev))


def _forward_both(pt):
    nds = pt.meta[:, bfb.M_NDIAG]
    fk = hk.forward_sweep(pt)
    fr = hk.forward_sweep_ref(pt)
    torch.cuda.synchronize()
    return nds, fk, fr


def test_forward_kernel_matches_twin(dev, bucket):
    pt = _tensors(bucket, dev)
    n0 = hk.forward_sweep.launches
    nds, (f_k, fi_k, lf_k), (f_r, fi_r, lf_r) = _forward_both(pt)
    assert hk.forward_sweep.launches == n0 + 1
    _, tf_k = bfb.forward_offsets(fi_k, lf_k, nds)
    _, tf_r = bfb.forward_offsets(fi_r, lf_r, nds)
    assert (tf_k - tf_r).abs().max().item() <= 1e-2
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    assert (f_k.exp() - f_r.exp()).abs().amax(dim=2)[rows].max().item() <= 1e-4


def test_backward_kernel_matches_twin(dev, bucket):
    pt = _tensors(bucket, dev)
    nds, _, (f_r, fi_r, lf_r) = _forward_both(pt)
    fo, tf = bfb.forward_offsets(fi_r, lf_r, nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    n0 = hk.backward_sweep_compact.launches
    bk = hk.backward_sweep_compact(pt, f_r, cvecf, THR, R)
    br = hk.backward_sweep_compact_ref(pt, f_r, cvecf, THR, R)
    torch.cuda.synchronize()
    assert hk.backward_sweep_compact.launches == n0 + 1
    _, tb_k = bfb.backward_offsets(bk[0], bk[1])
    _, tb_r = bfb.backward_offsets(br[0], br[1])
    assert (tb_k - tb_r).abs().max().item() <= 1e-2
    assert int(bk[4].max()) <= R

    def surv(off, val, cnt):
        keep = torch.arange(R, device=dev) < cnt[:, :, None]
        b, d, _ = keep.nonzero(as_tuple=True)
        return {(int(x), int(y), int(o)): float(v) for x, y, o, v in zip(
            b.tolist(), d.tolist(), off[keep].tolist(), val[keep].tolist())}

    sk, sr = surv(*bk[2:]), surv(*br[2:])
    for key in set(sk) ^ set(sr):
        assert abs(sk.get(key, sr.get(key)) - THR) <= 1e-4
    assert max(abs(sk[k] - sr[k]) for k in set(sk) & set(sr)) <= 1e-4


def test_aligner_on_gpu_matches_cpu(dev, bucket):
    """The whole bucket path (kernels, float64 scans, flattening, decode)
    on the card against the same path on the CPU (twins). The CPU's
    exp/log round otherwise, and a posterior's log terms reach hundreds
    of nats, where f32 resolves ~1e-4: pairs within 1e-3."""
    problems, W, h = bucket
    cpu_dev = torch.device("cpu")
    gpu = hk.HopperAligner(problems, W, dev, _hdp_tables(h, dev)).execute(THR)
    cpu = hk.HopperAligner(problems, W, cpu_dev,
                           _hdp_tables(h, cpu_dev)).execute(THR)
    for g, c in zip(gpu, cpu):
        assert abs(g["total_f"] - c["total_f"]) <= 1e-2
        dg = {(x, y, k): p for p, x, y, k in g["pairs"]}
        dc = {(x, y, k): p for p, x, y, k in c["pairs"]}
        for key in set(dg) ^ set(dc):
            assert abs(dg.get(key, dc.get(key)) / 1e7 - THR) <= 1e-3
        assert all(abs(dg[k] - dc[k]) <= 1e-3 * 1e7 for k in set(dg) & set(dc))


PATH_CASES = ["p2", "p3w512", "p4w1024", "p8w128", "p8", "p8w512", "p8w768",
              "p2w4096", "p1w2304", "p1w8192", "p16", "p64", "p16w768",
              "edges", "clamp", "illegal", "wedges", "wclamp", "willegal",
              "p64w768", "pastcap"]


@pytest.fixture(scope="module",
                params=PATH_CASES + ["hdp_" + c for c in PATH_CASES])
def paths_case(request):
    """(problems, W, HDP or None) for the P > 2 instances, Gaussian or HDP
    (hdp_), at every cells-per-thread instance: pP[wW] (W = 256 by
    default) gives K = 1 (P*W <= 1024), 2 (p3w512, p8), 4 (p4w1024,
    p8w512, p16, p1w2304), 8 (p8w768, p2w4096, p1w8192) or the wide
    instances past 8192 cells (p64: 16,384 cells and two legality words a
    mask; p16w768: 12,288 cells, bands past 512 offsets; p64w768: P =
    64 at W = 768, 49,152 cells (the cluster instance's CAP, its K = 8
    instances), a band past 512 offsets; all on the cluster instance;
    pastcap: P = 64 at W = 1024, 65,536 cells, past the cluster
    instance's CAP, on the scratch instance, ~200 diagonals). P =
    2 runs the per-pair instances up to 2048 cells (p2 among them), P > 2 and
    wider P <= 2 buckets the P > 2 ones: p1w2304 is the runner's bucket
    of a P = 1 band 2,271 offsets wide, p1w8192 the same problems at the
    widest P = 1 bucket. ``edges``: P = 8 problems whose band
    fills W at its bulge (W = their widest band), so reads fall outside
    the window at both band edges; ``clamp``: P = 4 problems prepared at
    W = 128 and run at W = 256, so the reference and event windows clamp
    at reflen - W and evlen - W; ``illegal``: P = 8 problems with the
    code at every other position over 60 positions, where most path
    pairs of neighbouring cells are illegal. ``wedges``, ``wclamp`` and
    ``willegal`` are the same on the cluster instance, where a block's
    edge offsets read its neighbours' rings: P = 16 at W = its widest
    band (past 512 offsets), P = 16 prepared at W = 512 and run at W =
    768, and P = 16 at W = 768 with the dense codes."""
    name = request.param
    hdp = name.startswith("hdp_")
    return _paths_bucket(name[4:] if hdp else name, hdp)


def _paths_bucket(name, hdp):
    """``paths_case``'s bucket ``name`` (without its hdp_ prefix)."""
    if name == "wedges":
        probe, _ = _problems(2, (1300, 1400), (200, 850), 768, 4096, 22, P=16,
                             hdp=hdp)
        W = max(int(p.width.max()) for p in probe)
        assert W > 512
        probs = _problems(2, (1300, 1400), (200, 850), W, 4096, 22, P=16,
                          hdp=hdp)
        assert max(int(p.width.max()) for p in probs[0]) == W
        return _case(probs, W)
    if name == "wclamp":
        probs = _problems(2, (500, 700), (100, 160), 768, 2048, 23, P=16,
                          hdp=hdp, prep_w=512)
        assert all(p.x0[:p.n_diag + 1].max() > p.ref_params.shape[-1] - 768
                   for p in probs[0])
        return _case(probs, 768)
    if name == "willegal":
        probs = _problems(2, (1300, 1400), (200, 850), 768, 4096, 24, P=16,
                          hdp=hdp, dense=(100, 160))
        legal = np.concatenate([p.legal.reshape(256, -1)[:, 101:160]
                                for p in probs[0]], axis=1)
        assert legal.mean() < 0.25
        return _case(probs, 768)
    if name == "p64w768":
        probs = _problems(1, (600, 660), (30, 560), 768, 1536, 26, P=64,
                          hdp=hdp)
        assert int(probs[0][0].width.max()) > 512
        return _case(probs, 768)
    if name == "pastcap":
        return _case(_problems(1, (90, 110), (0, 0), 1024, 256, 25, P=64,
                               hdp=hdp, cluster_at=40), 1024)
    if name == "edges":
        probe, _ = _problems(2, (700, 900), (100, 300), 512, 2048, 18, P=8,
                             hdp=hdp)
        W = max(int(p.width.max()) for p in probe)
        probs = _problems(2, (700, 900), (100, 300), W, 2048, 18, P=8,
                          hdp=hdp)
        assert max(int(p.width.max()) for p in probs[0]) == W
        return _case(probs, W)
    if name == "clamp":
        probs = _problems(3, (500, 700), (100, 160), 256, 2048, 19, P=4,
                          hdp=hdp, prep_w=128)
        # x0 passes reflen - W on each problem's last diagonals
        assert all(p.x0[:p.n_diag + 1].max() > p.ref_params.shape[-1] - 256
                   for p in probs[0])
        return _case(probs, 256)
    if name == "illegal":
        probs = _problems(3, (500, 700), (100, 300), 256, 2048, 20, P=8,
                          hdp=hdp, dense=(100, 160))
        legal = np.concatenate([p.legal.reshape(64, -1)[:, 101:160]
                                for p in probs[0]], axis=1)
        assert legal.mean() < 0.25
        return _case(probs, 256)
    P, _, W = name[1:].partition("w")
    P, W = int(P), int(W or 256)
    # (sizes, anchor gap, Dpad): bands up to ~W wide
    sizes, gap, dpad = {128: ((400, 600), (100, 150), 2048),
                        768: ((1300, 1400), (200, 850), 4096),
                        1024: ((1300, 1400), (200, 850), 4096),
                        2304: ((2500, 2600), (150, 2400), 6144),
                        4096: ((1300, 1400), (200, 850), 4096),
                        8192: ((2500, 2600), (150, 2400), 6144)}.get(
                            W, ((700, 900), (100, 300), 2048))
    return _case(_problems(2, sizes, gap, W, dpad, 30 + P, P=P, hdp=hdp), W)


# the widest bucket of the runner at P <= 64 (P = 64 at W = 768), which
# the cluster instance takes (its CAP); past it the scratch instance runs
CLUSTER_CELLS = 64 * 768


def _wide_counts():
    return [(fn.cluster_launches, fn.wide_scratch_launches)
            for fn in (hk.forward_sweep, hk.backward_sweep_compact)]


def _check_wide(pt, before, expect=False):
    """Each sweep of a bucket past 8192 cells a diagonal ran once on the
    cluster instance (up to CLUSTER_CELLS) or on the scratch instance
    (past them); a narrower bucket on neither."""
    for bwd, (c0, s0), (c1, s1) in zip((0, 1), before, _wide_counts()):
        if hk.cells_per_thread(pt.W, pt.P, expect, bwd) >= -8:
            assert (c1, s1) == (c0, s0)
            continue
        C = hk.cluster_ctas(pt.W, pt.P, expect, bwd)
        assert (C > 0) == (pt.P * pt.W <= CLUSTER_CELLS)
        assert (c1, s1) == ((c0 + 1, s0) if C else (c0, s0 + 1))


def test_paths_kernels_equal_twins_bit_for_bit(dev, paths_case):
    """Both kernels on a P > 1 bucket or a P = 1 bucket past the per-pair
    instances (for the P > 2 instances the source-side terms in the
    forward's ring, the target-side terms staged once per (offset, path)
    in the backward, the logsumexps over legal paths only) against their
    twins: fstack, offsets, totals' terms and survivors equal bit for
    bit."""
    pt = _tensors(paths_case, dev)
    assert pt.P > 1 or hk.cells_per_thread(pt.W, pt.P) < 0
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    wide0 = _wide_counts()
    nds, fk, fr = _forward_both(pt)
    assert torch.equal(fk[0][rows], fr[0][rows])
    assert torch.equal(fk[1][rows], fr[1][rows]) and torch.equal(fk[2], fr[2])
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    bk = hk.backward_sweep_compact(pt, fr[0], cvecf, THR, R)
    br = hk.backward_sweep_compact_ref(pt, fr[0], cvecf, THR, R)
    torch.cuda.synchronize()
    _check_wide(pt, wide0)
    assert torch.equal(bk[0][rows], br[0][rows]) and torch.equal(bk[1], br[1])
    assert torch.equal(bk[4][rows], br[4][rows]) and int(bk[4].max()) <= R
    keep = torch.arange(R, device=dev) < bk[4][:, :, None]
    assert keep.any()
    assert torch.equal(bk[2][keep], br[2][keep])
    assert torch.equal(bk[3][keep], br[3][keep])


@pytest.fixture(scope="module",
                params=["narrow", "wide", "hdp_narrow", "hdp_wide"])
def expect_bucket(request):
    """P = 1 buckets for the expectation instances: six W=256 problems
    (one cell per thread) or two whose bands pass 1024 offsets (W=1280:
    two cells per thread), Gaussian or HDP."""
    hdp = request.param.startswith("hdp_")
    if request.param.endswith("narrow"):
        return _case(_problems(6, (200, 600), (100, 160), 256, 2048, 4,
                               hdp=hdp), 256)
    probs = _problems(2, (1450, 1550), (200, 1300), 1280, 4096, 5, hdp=hdp)
    assert max(int(p.width.max()) for p in probs[0]) > 1024
    return _case(probs, 1280)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def test_expect_kernels_match_twins(dev, expect_bucket):
    problems, W, h = expect_bucket
    pt = problem_tensors(problems, W, dev, _hdp_tables(h, dev), kmer_ids=True)
    nds = pt.meta[:, bfb.M_NDIAG]
    n0 = (hk.forward_sweep.expect_launches,
          hk.backward_sweep_compact.expect_launches)
    fk = hk.forward_sweep(pt, expect=True)
    fr = hk.forward_sweep_ref(pt, expect=True)
    torch.cuda.synchronize()
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    assert fk[0].shape == fr[0].shape == (*pt.x0.shape, 3, 1, W)
    assert torch.equal(fk[0][rows], fr[0][rows])
    assert torch.equal(fk[1][rows], fr[1][rows]) and torch.equal(fk[2], fr[2])
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    bk = hk.backward_sweep_compact(pt, fr[0], cvecf, THR, R, expect=True)
    br = hk.backward_sweep_compact_ref(pt, fr[0], cvecf, THR, R, expect=True)
    torch.cuda.synchronize()
    assert (hk.forward_sweep.expect_launches,
            hk.backward_sweep_compact.expect_launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(bk[0][rows], br[0][rows]) and torch.equal(bk[1], br[1])
    assert torch.equal(bk[4][rows], br[4][rows])
    keep = torch.arange(R, device=dev) < bk[4][:, :, None]
    assert torch.equal(bk[2][keep], br[2][keep])
    assert torch.equal(bk[3][keep], br[3][keep])
    assert _rel(bk[5], br[5]) <= 1e-5
    if h is None:
        assert _rel(bk[6], br[6]) <= 1e-5 and bk[6].abs().max() > 0
    else:
        assert not bk[6].any()


def test_expect_aligner_on_gpu_matches_cpu(dev, expect_bucket):
    """HopperAligner.expect on the card against the same pass on the CPU
    (twins): totals within 1e-2 nats, texp rtol 2e-4 / atol 5e-3, kexp
    rtol 2e-3 / atol 5e-3 (the CPU's exp/log round otherwise)."""
    problems, W, h = expect_bucket
    cpu_dev = torch.device("cpu")
    gpu = hk.HopperAligner(problems, W, dev, _hdp_tables(h, dev),
                           expect=True).expect(THR)
    cpu = hk.HopperAligner(problems, W, cpu_dev, _hdp_tables(h, cpu_dev),
                           expect=True).expect(THR)
    for g, c in zip(gpu, cpu):
        assert abs(g["total_f"] - c["total_f"]) <= 1e-2
        np.testing.assert_allclose(g["texp"], c["texp"], rtol=2e-4, atol=5e-3)
        np.testing.assert_allclose(g["kexp"], c["kexp"], rtol=2e-3, atol=5e-3)


# (P, W, K): a bucket shape of each cells-per-thread instance the
# dispatch table gives the per-pair sweeps
PAIR_SHAPES = [(1, 256, 1), (1, 768, 2), (1, 1280, 4),
               (2, 256, 1), (2, 512, 2), (2, 1024, 4)]
# (sizes, anchor gap, Dpad) of problems whose bands reach ~W offsets
PAIR_PROBLEMS = {256: ((500, 700), (100, 200), 2048),
                 512: ((700, 900), (100, 400), 2048),
                 768: ((1300, 1400), (200, 850), 4096),
                 1024: ((1300, 1400), (200, 850), 4096),
                 1280: ((1450, 1550), (200, 1300), 4096)}


@pytest.mark.parametrize("hdp", [False, True], ids=["gauss", "hdp"])
@pytest.mark.parametrize("P,W,k", PAIR_SHAPES,
                         ids=[f"p{P}w{W}" for P, W, _ in PAIR_SHAPES])
def test_pair_instances_equal_twins_bit_for_bit(dev, P, W, k, hdp):
    """Each per-pair instance (one barrier a diagonal, raw-state ring,
    inputs staged a diagonal ahead) the dispatch table uses, on a bucket
    of P = 1 or 2 paths at a W that selects it (K cells per thread both
    ways), Gaussian or HDP: fstack, offsets, survivor counts, cells and
    posteriors equal the twins' bit for bit; the end logsumexps, which
    sum in thread order, within 1e-2 nats."""
    assert [hk.cells_per_thread(W, P, backward=b) for b in (0, 1)] == [k, k]
    sizes, gap, dpad = PAIR_PROBLEMS[W]
    problems, h = _problems(2 if W > 256 else 3, sizes, gap, W, dpad,
                            40 + P, P=P, hdp=hdp)
    pt = problem_tensors(problems, W, dev, _hdp_tables(h, dev))
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    fk = hk.forward_sweep(pt)
    fr = hk.forward_sweep_ref(pt)
    torch.cuda.synchronize()
    assert torch.equal(fk[0][rows], fr[0][rows])
    assert torch.equal(fk[1][rows], fr[1][rows])
    assert (fk[2] - fr[2]).abs().max().item() <= 1e-2
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    bk = hk.backward_sweep_compact(pt, fr[0], cvecf, THR, R)
    br = hk.backward_sweep_compact_ref(pt, fr[0], cvecf, THR, R)
    torch.cuda.synchronize()
    assert torch.equal(bk[0][rows], br[0][rows])
    assert (bk[1] - br[1]).abs().max().item() <= 1e-2
    assert torch.equal(bk[4][rows], br[4][rows]) and int(bk[4].max()) <= R
    keep = torch.arange(R, device=dev) < bk[4][:, :, None]
    assert keep.any()
    assert torch.equal(bk[2][keep], br[2][keep])
    assert torch.equal(bk[3][keep], br[3][keep])


# (W, forward K, backward K): a P = 1 bucket shape of each instance the
# dispatch table gives the expectation sweeps
EXPECT_SHAPES = [(128, 1, 1), (256, 1, 2), (768, 2, 2), (1280, 4, 4)]


@pytest.mark.parametrize("hdp", [False, True], ids=["gauss", "hdp"])
@pytest.mark.parametrize("W,kf,kb", EXPECT_SHAPES,
                         ids=[f"w{W}" for W, _, _ in EXPECT_SHAPES])
def test_expect_instances_at_every_k(dev, W, kf, kb, hdp):
    """The expectation instances the dispatch table uses, on P = 1
    buckets at a W that selects each (forward K kf, backward K kb):
    three-state stacks, offsets and survivors equal the twins' bit for
    bit, texp and kx within 1e-5 relative (float64 sums in another
    association)."""
    assert [hk.cells_per_thread(W, 1, True, b) for b in (0, 1)] == [kf, kb]
    sizes, gap, dpad = PAIR_PROBLEMS.get(W, ((300, 600), (100, 160), 2048))
    problems, h = _problems(2 if W > 256 else 4, sizes, gap, W, dpad, 4,
                            hdp=hdp)
    pt = problem_tensors(problems, W, dev, _hdp_tables(h, dev),
                         kmer_ids=True)
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    fk = hk.forward_sweep(pt, expect=True)
    fr = hk.forward_sweep_ref(pt, expect=True)
    torch.cuda.synchronize()
    assert torch.equal(fk[0][rows], fr[0][rows])
    assert torch.equal(fk[1][rows], fr[1][rows])
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    bk = hk.backward_sweep_compact(pt, fr[0], cvecf, THR, R, expect=True)
    br = hk.backward_sweep_compact_ref(pt, fr[0], cvecf, THR, R, expect=True)
    torch.cuda.synchronize()
    assert torch.equal(bk[0][rows], br[0][rows])
    assert torch.equal(bk[4][rows], br[4][rows])
    keep = torch.arange(R, device=dev) < bk[4][:, :, None]
    assert torch.equal(bk[2][keep], br[2][keep])
    assert torch.equal(bk[3][keep], br[3][keep])
    assert _rel(bk[5], br[5]) <= 1e-5
    if h is None:
        assert _rel(bk[6], br[6]) <= 1e-5 and bk[6].abs().max() > 0
    else:
        assert not bk[6].any()


# the expectation buckets of more than one path, and of one past the
# per-pair instances: P = 2 at W = 256 (the per-pair instance widened to
# two paths) and at W = 4096, P = 3, 4, 8 and 16 at W = 256, P = 64 at W =
# 128 (two legality words) and a P = 1 band of 2,271 offsets (W = 2304)
# (the P > 2 register instances, whose sums sa_expect_sums takes), the
# cluster instance (P = 64 at W = 256 and at W = 768, its CAP; P = 16 at
# W = 768; and paths_case's wide-shaped band edges and sparse legality)
# and the scratch instance past its CAP. Windows clamped at reflen - W
# are held apart (test_expect_clamped_windows)
EXPECT_PATH_CASES = ["p2", "p2w4096", "p3", "p4", "p8", "p16", "p64w128",
                     "p1w2304", "p64", "p16w768", "p64w768", "wedges",
                     "willegal", "pastcap"]
# texp and kx against the twin's, relative to its largest value: the
# register instances' buckets (sa_expect_sums adds the twin's own
# float32 pair terms, in float64 in another order) and the others (the
# sweep sums a source cell's transitions through its to-cell logsumexp
# over the legal targets, the twin each (source, target) pair, as the
# JAX XLA core does)
TOL_SPLIT, TOL_SWEEP = 1e-6, 1e-3


@pytest.mark.parametrize("hdp", [False, True], ids=["gauss", "hdp"])
@pytest.mark.parametrize("case", EXPECT_PATH_CASES)
def test_expect_paths_instances_match_twins(dev, case, hdp):
    """The expectation pass at P > 1 (and at P = 1 past 2,048 cells),
    Gaussian or HDP, on the instance the dispatch picks, against the
    twins: three-state stacks, offsets and survivors equal bit for bit;
    texp and kx (B, 3, P, LX) within TOL_SPLIT of the twin's largest
    value on the register instances' buckets, TOL_SWEEP on the others; kx
    zero under HDP. On the register instances' buckets also: the
    backward's stored three-state stack equals the twin's ``store_full``
    stack bit for bit, sa_expect_sums launched once (and on no other
    bucket), and two launches of it on the same stacks give the same
    bits."""
    problems, W, h = _paths_bucket(case, hdp)
    pt = problem_tensors(problems, W, dev, _hdp_tables(h, dev),
                         kmer_ids=True)
    P = pt.P
    ks = [hk.cells_per_thread(W, P, True, b) for b in (0, 1)]
    assert all(ks) and (case == "p2" or all(k < 0 for k in ks))
    split = hk.expect_split(W, P)
    assert split == (-8 <= ks[1] < 0)
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    n0 = (hk.forward_sweep.expect_launches,
          hk.backward_sweep_compact.expect_launches)
    pair0 = (hk.forward_sweep.expect_pair2_launches,
             hk.backward_sweep_compact.expect_pair2_launches)
    wide0 = _wide_counts()
    sums0 = hk.expect_sums.launches
    fk = hk.forward_sweep(pt, expect=True)
    fr = hk.forward_sweep_ref(pt, expect=True)
    torch.cuda.synchronize()
    assert fk[0].shape == fr[0].shape == (*pt.x0.shape, 3, P, W)
    assert torch.equal(fk[0][rows], fr[0][rows])
    assert torch.equal(fk[1][rows], fr[1][rows]) and torch.equal(fk[2], fr[2])
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    bk = hk.backward_sweep_compact(pt, fr[0], cvecf, THR, R, expect=True)
    br = hk.backward_sweep_compact_ref(pt, fr[0], cvecf, THR, R, expect=True)
    torch.cuda.synchronize()
    assert (hk.forward_sweep.expect_launches,
            hk.backward_sweep_compact.expect_launches) == (n0[0] + 1, n0[1] + 1)
    assert hk.expect_sums.launches == sums0 + int(split)
    # the per-pair instance's two-path launches are counted apart
    on_pair = int(P == 2 and ks[0] > 0)
    assert (hk.forward_sweep.expect_pair2_launches,
            hk.backward_sweep_compact.expect_pair2_launches) == (
        pair0[0] + on_pair, pair0[1] + on_pair)
    _check_wide(pt, wide0, expect=True)
    assert torch.equal(bk[0][rows], br[0][rows]) and torch.equal(bk[1], br[1])
    assert torch.equal(bk[4][rows], br[4][rows])
    keep = torch.arange(R, device=dev) < bk[4][:, :, None]
    assert keep.any()
    assert torch.equal(bk[2][keep], br[2][keep])
    assert torch.equal(bk[3][keep], br[3][keep])
    assert bk[6].shape == (pt.x0.shape[0], 3, P, pt.ref.shape[-1])
    tol = TOL_SPLIT if split else TOL_SWEEP
    assert _rel(bk[5], br[5]) <= tol and bk[5].sum() > 0
    if h is None:
        assert _rel(bk[6], br[6]) <= tol and bk[6].abs().max() > 0
    else:
        assert not bk[6].any()
    if not split:
        return
    sk = hk.backward_sweep_stack(pt, fr[0], cvecf, THR, R)
    bs = bfb.sweep_backward(pt, store_full=True)[0]
    torch.cuda.synchronize()
    assert torch.equal(sk[5][rows], bs[rows])
    bo, _ = bfb.backward_offsets(sk[0], sk[1])
    first = hk.expect_sums(pt, fr[0], sk[5], cvecf, bo)
    again = hk.expect_sums(pt, fr[0], sk[5], cvecf, bo)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(first, bk[5:]))


@pytest.mark.parametrize("hdp", [False, True], ids=["gauss", "hdp"])
@pytest.mark.parametrize("case", ["clamp", "wclamp"])
def test_expect_clamped_windows(dev, case, hdp):
    """The expectation pass on windows clamped at reflen - W (problems
    prepared at a narrower W than they run: the register instance at P =
    4, the cluster instance at P = 16): three-state stacks, offsets,
    totals' terms and survivors equal the twins' bit for bit. The sums
    are not compared: there the forward reads a cell's emission at
    clamp(x0[d]) + o, the backward a target's at clamp(x0[d] + 1) + o and
    the twin's sums at the target diagonal's clamped window, so forward
    and backward run different models (the twin's totals part by more
    than a nat on every problem) and f + b - total is no log posterior.
    The runner prepares every problem at the W it runs, so its windows
    never clamp (test_torch_runner.py::test_runner_windows_never_clamp).
    Prints each problem's readings (pytest -s)."""
    problems, W, h = _paths_bucket(case, hdp)
    pt = problem_tensors(problems, W, dev, _hdp_tables(h, dev),
                         kmer_ids=True)
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    wide0 = _wide_counts()
    fk = hk.forward_sweep(pt, expect=True)
    fr = hk.forward_sweep_ref(pt, expect=True)
    torch.cuda.synchronize()
    assert torch.equal(fk[0][rows], fr[0][rows])
    assert torch.equal(fk[1][rows], fr[1][rows]) and torch.equal(fk[2], fr[2])
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    R = hk.survivor_slots(THR)
    bk = hk.backward_sweep_compact(pt, fr[0], cvecf, THR, R, expect=True)
    br = hk.backward_sweep_compact_ref(pt, fr[0], cvecf, THR, R, expect=True)
    torch.cuda.synchronize()
    _check_wide(pt, wide0, expect=True)
    assert torch.equal(bk[0][rows], br[0][rows]) and torch.equal(bk[1], br[1])
    assert torch.equal(bk[4][rows], br[4][rows])
    keep = torch.arange(R, device=dev) < bk[4][:, :, None]
    assert torch.equal(bk[2][keep], br[2][keep])
    assert torch.equal(bk[3][keep], br[3][keep])
    _, tb = bfb.backward_offsets(br[0], br[1])
    reflen = pt.meta[:, bfb.M_REFLEN]
    for i, p in enumerate(problems):
        clamped = int((pt.x0[i, :p.n_diag + 1] + 1 > reflen[i] - W).sum())
        gap = abs(float(tf[i]) - float(tb[i]))
        print(f"{case} {'hdp' if hdp else 'gauss'} P={pt.P} W={W} problem "
              f"{i}: n_diag {p.n_diag}, clamped diagonals {clamped}, twin "
              f"|total_f - total_b| {gap:.3f} nats, texp sums kernel "
              f"{float(bk[5][i].sum()):.4g} twin {float(br[5][i].sum()):.4g}")
        assert clamped > 0 and gap > 1.0


# ---------------------------------------------- probability-space kernels

def outlier_problems():
    """``outlier_segments``' four segments (the even ones carry a run of
    outlier events) at W=512, without anchors."""
    model = synthetic_pore_model(0)
    return [bfb.prepare_problem(seq, ev, model, ScalingParams(),
                                DEFAULT_AMBIG_BASES, W=512, Dpad=1024, P=1,
                                anchor_pairs=[], expansion=60)
            for seq, ev in outlier_segments(model)]


@pytest.fixture(scope="module", params=["narrow", "w512", "outliers"])
def prob_case(request):
    """(problems, W, the lanes that trip) for the probability-space
    kernels: six W=256 P=1 problems, two whose bands pass 256 offsets
    (W=512, the widest the runner gives them), or the four outlier
    segments, of which the two with the outlier run trip."""
    if request.param == "narrow":
        return (_problems(6, (200, 600), (100, 160), 256, 2048, 4)[0], 256,
                [False] * 6)
    if request.param == "w512":
        probs = _problems(2, (1000, 1100), (200, 550), 512, 4096, 9)[0]
        assert max(int(p.width.max()) for p in probs) > 256
        return probs, 512, [False] * 2
    return outlier_problems(), 512, [True, False, True, False]


def _prob_both(pt):
    """Both probability-space sweeps, kernel and twin, on ``pt``: the
    forwards, the twin's float64 offsets and totals, the backwards on the
    twin's stack; and the rows of each problem (d <= n_diag) and its
    lanes that did not trip (finite totals within 1 nat)."""
    nds = pt.meta[:, bfb.M_NDIAG]
    R = hk.survivor_slots(THR)
    fk = hk.forward_sweep_prob(pt)
    fr = hk.forward_sweep_prob_ref(pt)
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    bk = hk.backward_sweep_compact_prob(pt, fr[0], cvecf, THR, R)
    br = hk.backward_sweep_compact_prob_ref(pt, fr[0], cvecf, THR, R)
    torch.cuda.synchronize()
    _, tb = bfb.backward_offsets(br[0], br[1])
    rows = torch.arange(pt.x0.shape[1], device=pt.device)[None, :] <= nds[:, None]
    ok = (tf - tb).abs() < 1.0
    return fk, fr, bk, br, rows, ok, R


def test_prob_kernels_match_twins(dev, prob_case):
    """Totals within 1e-2 nats, exp(fstack) within 1e-4, the survivor
    sets equal except threshold-edge cells and posteriors within 1e-4 on
    the lanes that did not trip; on the tripped lanes kernel and twin
    trip alike; one launch each."""
    problems, W, trips = prob_case
    pt = problem_tensors(problems, W, dev, prob=True)
    n0 = (hk.forward_sweep_prob.launches,
          hk.backward_sweep_compact_prob.launches)
    fk, fr, bk, br, rows, ok, R = _prob_both(pt)
    assert (hk.forward_sweep_prob.launches,
            hk.backward_sweep_compact_prob.launches) == (n0[0] + 1, n0[1] + 1)
    nds = pt.meta[:, bfb.M_NDIAG]
    _, tf_k = bfb.forward_offsets(fk[1], fk[2], nds)
    _, tf_r = bfb.forward_offsets(fr[1], fr[2], nds)
    _, tb_k = bfb.backward_offsets(bk[0], bk[1])
    _, tb_r = bfb.backward_offsets(br[0], br[1])
    assert torch.equal(~((tf_k - tb_k).abs() < 1.0), ~ok)
    assert (~ok).tolist() == trips
    assert (tf_k - tf_r)[ok].abs().max().item() <= 1e-2
    assert (tb_k - tb_r)[ok].abs().max().item() <= 1e-2
    live = rows & ok[:, None]
    assert (fk[0].exp() - fr[0].exp())[:, :, 0][live].abs().max().item() <= 1e-4
    assert int(bk[4][ok].max()) <= R

    def surv(off, val, cnt):
        keep = (torch.arange(R, device=dev) < cnt[:, :, None]) \
            & ok[:, None, None]
        b, d, _ = keep.nonzero(as_tuple=True)
        return {(int(x), int(y), int(o)): float(v) for x, y, o, v in zip(
            b.tolist(), d.tolist(), off[keep].tolist(), val[keep].tolist())}

    sk, sr = surv(*bk[2:]), surv(*br[2:])
    for key in set(sk) ^ set(sr):
        assert abs(sk.get(key, sr.get(key)) - THR) <= 1e-4
    assert max(abs(sk[k] - sr[k]) for k in set(sk) & set(sr)) <= 1e-4


def test_prob_aligner_on_gpu_matches_cpu(dev, prob_case):
    """HopperAligner(log_space=False) on the card against the CPU
    (twins): the same lanes flagged numerics_suspect (they report no
    pairs); the others' totals within 1e-2 nats and pairs within 1e-3."""
    problems, W, trips = prob_case
    cpu_dev = torch.device("cpu")
    gpu = hk.HopperAligner(problems, W, dev, log_space=False).execute(THR)
    cpu = hk.HopperAligner(problems, W, cpu_dev, log_space=False).execute(THR)
    assert [g["numerics_suspect"] for g in gpu] \
        == [c["numerics_suspect"] for c in cpu] == trips
    for g, c in zip(gpu, cpu):
        if g["numerics_suspect"]:
            assert g["pairs"] == [] == c["pairs"]
            continue
        assert abs(g["total_f"] - c["total_f"]) <= 1e-2
        dg = {(x, y, k): p for p, x, y, k in g["pairs"]}
        dc = {(x, y, k): p for p, x, y, k in c["pairs"]}
        for key in set(dg) ^ set(dc):
            assert abs(dg.get(key, dc.get(key)) / 1e7 - THR) <= 1e-3
        assert all(abs(dg[k] - dc[k]) <= 1e-3 * 1e7 for k in set(dg) & set(dc))
