"""The port's P > 1 path axis against the JAX package on the CPU:
degenerate-base problems with 2, 4 and 8 paths per cell through the host
problem build, the bucket tensors, the plain sweeps (the Hopper kernels'
twins), the aligner's pair output and its device site sums, held to the
JAX XLA path, the float64 oracle and the lane-batched Pallas kernels in
interpret mode. Inputs are seeded synthetic problems."""

import dataclasses

import numpy as np
import pytest
import torch

from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.banded_fb_pallas_batch import PallasBatchAligner
from signalalign_tpu.ops.batch import run_banded_fb_batch as jax_batch
from signalalign_tpu.ops.batch import stack_problems
from signalalign_tpu.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_tpu.pipeline.variant_caller import (marginals_from_pairs,
                                                     marginals_from_site_probs)
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.convert import (legality_bits, masks_by_source,
                                           pore_model_from_numpy,
                                           problem_from_numpy, problem_tensors)
from signalalign_tpu_torch.models import pore_model as port_pm
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.ops.batch import run_banded_fb_batch
from signalalign_tpu_torch.pipeline import variant_caller as port_vc
from signalalign_tpu_torch.pipeline.runner import _site_cells
from signalalign_tpu_torch.utils.synthetic import synthetic_pore_model

W, DPAD, THR = 128, 192, 0.01
CPU = torch.device("cpu")


def _models(seed=0, alphabet="ACGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = JPoreModel(alphabet, k)
    src = synthetic_pore_model(seed, alphabet, k)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm, pore_model_from_numpy(jm)


MODEL, PORT_MODEL = _models()
K = MODEL.kmer_length
# ambiguity clusters that set the largest path count of a segment: one Y
# (2 paths), two Y in a 5-mer (4), three (8) and four (16); three
# four-way X (64)
CLUSTERS = {2: "Y", 4: "YGY", 8: "YGYGY", 16: "YYGYY", 64: "XGXGX"}


def _problem_args(P, i, seed):
    """(args, kwargs) of prepare_problem for a segment whose largest
    expansion is P paths: single Y codes every ~25 positions, one cluster
    of CLUSTERS[P] mid-sequence, events drawn from a resolved sequence
    (each Y read as C or T), and anchors every 15 events with a gap for
    a band bulge (none in problem 0). Segments of 55-85 bases (each
    comparison holds per problem, cell by cell) and Dpad 192, above their
    152 diagonals at most: the JAX scans run Dpad + 1 diagonals."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(55, 85))
    seq = list(rng.choice(list("ACGT"), size=L))
    for j in range(8, L - 8, 25):
        seq[j] = "Y"
    mid = 18 + 25 * ((L // 2 - 8) // 25)     # between two single codes
    seq[mid:mid + len(CLUSTERS[P])] = CLUSTERS[P]
    seq = "".join(seq)
    resolved = "".join(rng.choice(["C", "T"]) if c == "Y" else
                       rng.choice(list("ACGT")) if c == "X" else c
                       for c in seq)
    ids = MODEL.alphabet.seq_to_kmer_ids(resolved)
    ev = np.stack([MODEL.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                   np.ones(len(ids)), np.full(len(ids), .005),
                   np.arange(len(ids)) * .005], 1)
    n = len(ev)
    anchors = [(j, j) for j in range(8, n - 8, 15)
               if not (i and n // 3 < j < n // 3 + 40)]
    return ((seq, ev, MODEL, ScalingParams(shift=0.2 * i, var=1 + 0.1 * i),
             DEFAULT_AMBIG_BASES),
            dict(W=W, Dpad=DPAD, P=P, mode=bfb.MODE_MEAN_ONLY,
                 anchor_pairs=anchors, expansion=8))


def _args(P):
    return [_problem_args(P, i, 100 * P + i) for i in range(4)]


@pytest.fixture(scope="module", params=[2, 4, 8])
def bucket(request):
    """(P, JAX problems, the port's copies) of one P bucket."""
    P = request.param
    jp = [jbfb.prepare_problem(*a, **kw) for a, kw in _args(P)]
    assert all(p.ref_params.shape[1] == P for p in jp)
    assert max(int(p.n_paths.max()) for p in jp) == P
    return P, jp, [problem_from_numpy(p) for p in jp]


@pytest.fixture(scope="module")
def port(bucket):
    """The aligner on CPU tensors (the kernels' twins): pairs + totals."""
    P, _, tp = bucket
    return hk.HopperAligner(tp, W, CPU).execute(THR)


@pytest.fixture(scope="module")
def xla(bucket):
    """JAX XLA path: posterior band, totals and aligned pairs per problem."""
    P, jp, _ = bucket
    out = jax_batch(jp, W=W, P=P)
    for p, r in zip(jp, out):
        r["pairs"] = jbfb.extract_aligned_pairs(p, r["post"], THR)
    return out


def _assert_pairs_close(want, got, tol_int, edge=1e-4):
    """Same (x, y, kmer) set except cells within ``edge`` of the
    threshold; shared pairs' prob_int within tol_int; JAX order."""
    dw = {(x, y, k): p for p, x, y, k in want}
    dg = {(x, y, k): p for p, x, y, k in got}
    for key in set(dw) ^ set(dg):
        p = dw.get(key, dg.get(key))
        assert abs(p / 1e7 - THR) <= edge, (key, p)
    shared = set(dw) & set(dg)
    assert len(shared) > 0.98 * max(len(dw), len(dg))
    assert max(abs(dw[k] - dg[k]) for k in shared) <= tol_int
    # (x+y, x), then path: the order extract_aligned_pairs gives
    assert [(x, y, k) for _, x, y, k in got if (x, y, k) in shared] == \
        [(x, y, k) for _, x, y, k in want if (x, y, k) in shared]


@pytest.mark.parametrize("P", [2, 4, 8])
def test_prepare_problem_matches_jax(P):
    """Field for field and bit for bit, dtypes included (the event
    normaliser, which the port forms apart, by ``event_normaliser``)."""
    args, kw = _problem_args(P, 1, 7)
    want = jbfb.prepare_problem(*args, **kw)
    seq, ev, _, params, amb = args
    got = bfb.event_normaliser(bfb.prepare_problem(
        seq, ev, PORT_MODEL, port_pm.ScalingParams(**dataclasses.asdict(params)),
        dict(amb), **kw))
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _decode_masks(masks, P):
    """(LX, P * NW) masks -> (P_to, P_from, LX) bool: bit q % 32 of word
    q // 32 of each target path."""
    u = masks.view(np.uint32).reshape(masks.shape[0], P, -1)
    q = np.arange(P)
    bits = (u[:, :, q // 32] >> (q % 32).astype(np.uint32)) & 1
    return bits.transpose(1, 2, 0).astype(bool)


@pytest.mark.parametrize("P", [2, 8, 16, 64])
def test_legality_masks_hold_the_jax_legal_planes(P):
    """convert.legality_bits against the JAX package's legal planes:
    ceil(P / 32) int32 words per (position, target path p) in which bit
    q % 32 of word q // 32 is legal[p, q, x] (one word, bit q, at P <=
    32; two at P = 64), and problem_tensors carries them as (B, LX, P *
    words)."""
    args, kw = _problem_args(P, 1, 300 + P)
    jp = jbfb.prepare_problem(*args, **kw)
    assert int(jp.n_paths.max()) == P
    LX = jp.legal.shape[-1]
    masks = legality_bits(jp.legal)
    NW = bfb.leg_words(P)
    assert NW == (2 if P == 64 else 1)
    assert masks.dtype == np.int32 and masks.shape == (LX, P * NW)
    assert np.array_equal(_decode_masks(masks, P), jp.legal)
    if P <= 32:
        bit = np.arange(P, dtype=np.uint32)
        legal = (masks.view(np.uint32).T[:, None, :] >> bit[None, :, None]) & 1
        assert np.array_equal(legal.astype(bool), jp.legal)
    assert jp.legal.any() and not jp.legal.all()
    pt = problem_tensors([problem_from_numpy(jp)], W, CPU)
    assert pt.leg.shape == (1, pt.ref.shape[-1], P * NW)
    assert np.array_equal(pt.leg[0, :LX].numpy(), masks)
    assert pt.leg_src is None        # derived on the device for CUDA only


@pytest.mark.parametrize("P", [1, 2, 8, 16, 32, 64])
def test_masks_by_source_transpose_the_legal_planes(P):
    """convert.masks_by_source (the backward kernel's masks, bit p % 32 of
    word p // 32 of [x, q] = legal[p, q, x]) against legality_bits of the
    transposed planes, on seeded planes over (2, LX) positions: bit 31
    (P = 32, 64) keeps its sign in int32, and P = 64 has two words a
    path."""
    rng = np.random.default_rng(400 + P)
    legal = rng.random((2, P, P, 37)) < 0.4
    leg = torch.from_numpy(np.stack([legality_bits(lp) for lp in legal]))
    want = np.stack([legality_bits(lp.transpose(1, 0, 2)) for lp in legal])
    got = masks_by_source(leg, P)
    assert got.dtype == torch.int32
    assert got.shape == (2, 37, P * bfb.leg_words(P))
    assert np.array_equal(got.numpy(), want)


def test_problem_tensors_carry_the_path_tables(bucket):
    """problem_tensors field for field: per-path reference rows, the
    legality bits (which decode back to legal[p_to, q_from, x]), events,
    meta and the packed parameters."""
    P, _, tp = bucket
    pt = problem_tensors(tp, W, CPU)
    assert pt.P == P and pt.ref.shape[:3] == (len(tp), bfb.NREF, P)
    bit = np.arange(P)
    for i, p in enumerate(tp):
        lx = p.ref_params.shape[-1]
        assert np.array_equal(pt.ref[i, :, :, :lx].numpy(),
                              p.ref_params[:bfb.NREF])
        assert not pt.ref[i, :, :, lx:].any()
        masks = pt.leg[i, :lx].numpy().T              # (P_to, LX)
        legal = (masks[:, None, :] >> bit[None, :, None]) & 1
        assert np.array_equal(legal.astype(bool), p.legal)
        le = p.ev_params.shape[-1]
        assert np.array_equal(pt.ev[i, 0, :le].numpy(), p.ev_params[0])
        assert np.array_equal(pt.ev[i, 1, :le].numpy(), p.ev_params[3])
        n = p.n_diag + 1
        assert np.array_equal(pt.x0[i, :n].numpy(), p.x0[:n])
        assert np.array_equal(pt.width[i, :n].numpy(), p.width[:n])
        assert pt.meta[i, :6].tolist() == [p.lX, p.lY, p.n_diag,
                                           p.ev_front_pad, lx, le]
        assert np.array_equal(pt.par[i, :9].numpy(), p.log_trans)


def test_sweeps_match_jax_core(bucket):
    """sweep_forward / sweep_backward with P paths against the JAX
    _banded_sweeps_core diagonal by diagonal: normalised rows within 1e-4
    on the probability scale, offsets within 1e-3 nats, totals within
    5e-3 nats."""
    P, jp, tp = bucket
    fj, fij, lfj, bj, bij, lbj = (np.asarray(a) for a in jbfb.banded_sweeps_batched(
        *stack_problems(jp), W=W, P=P, mode=bfb.MODE_MEAN_ONLY,
        store_full=False))
    pt = problem_tensors(tp, W, CPU)
    ft, fit, lft = bfb.sweep_forward(pt)
    bt, bit, lbt = bfb.sweep_backward(pt)
    nd = pt.meta[:, bfb.M_NDIAG]
    _, tf = bfb.forward_offsets(fit, lft, nd)
    _, tb = bfb.backward_offsets(bit, lbt)
    for i, p in enumerate(tp):
        n = p.n_diag + 1
        assert np.abs(np.exp(fj[i, :n]) - np.exp(ft[i, :n].numpy())).max() < 1e-4
        assert np.abs(np.exp(bj[i, :n]) - np.exp(bt[i, :n].numpy())).max() < 1e-4
        assert np.abs(fij[i, :n] - fit[i, :n].numpy()).max() < 1e-3
        assert np.abs(bij[i, :n] - bit[i, :n].numpy()).max() < 1e-3
        jtf = float(lfj[i]) + np.cumsum(fij[i].astype(np.float64))[p.n_diag]
        jtb = float(lbj[i]) + np.sum(bij[i].astype(np.float64))
        assert abs(jtf - float(tf[i])) < 5e-3 and abs(jtb - float(tb[i])) < 5e-3


def test_posterior_matches_xla(bucket, xla):
    """ops.batch.run_banded_fb_batch with P paths (the port's XLA
    counterpart): posterior bands (Dpad+1, P, W) within 1e-4, totals
    within 5e-3 nats."""
    P, _, tp = bucket
    res = run_banded_fb_batch(tp, W, P, device=CPU)
    for r, x in zip(res, xla):
        assert r["post"].shape == x["post"].shape == (DPAD + 1, P, W)
        assert np.abs(r["post"] - x["post"]).max() <= 1e-4
        assert abs(r["total_f"] - x["total_f"]) <= 5e-3
        assert abs(r["total_b"] - x["total_b"]) <= 5e-3


def test_twins_match_xla(port, xla):
    """The aligner's pairs (forward_sweep_ref + backward_sweep_compact_ref,
    decode with path k-mers) against run_banded_fb_batch +
    extract_aligned_pairs: totals within 5e-3 nats, identical pairs and
    order except threshold-edge cells, posteriors within 1e-4."""
    for r, x in zip(port, xla):
        assert abs(r["total_f"] - x["total_f"]) <= 5e-3
        assert abs(r["total_b"] - x["total_b"]) <= 5e-3
        _assert_pairs_close(x["pairs"], r["pairs"], 1e-4 * 1e7 + 1)


@pytest.mark.parametrize("i", range(4))
def test_twins_match_float64_oracle(bucket, port, i):
    """The float64 oracle with path expansion (fb_oracle CellPaths) on
    problems of <= 180 events: totals within 1e-4 relative, identical
    pairs except threshold-edge cells, posteriors within 1e-4."""
    P = bucket[0]
    (seq, ev, model, params, amb), kw = _args(P)[i]
    assert len(ev) <= 180
    o = banded_forward_backward(
        CellPaths.from_sequence(seq, model, amb), ev, model,
        Emissions(model, params, mode="mean_only"),
        anchor_pairs=kw["anchor_pairs"], expansion=kw["expansion"],
        threshold=THR)
    r = port[i]
    assert abs(r["total_f"] - o["total_log_prob_f"]) <= 1e-4 * abs(r["total_f"])
    assert abs(r["total_b"] - o["total_log_prob_b"]) <= 1e-4 * abs(r["total_b"])
    _assert_pairs_close(o["aligned_pairs"], r["pairs"], 1e-4 * 1e7 + 1)


def _pallas(jp, P):
    return PallasBatchAligner(jp, W=W, T=48, S=2 * P, RB=256, interpret=True,
                              log_space=True, P=P)


@pytest.mark.parametrize("bucket", [2, 4], indirect=True)
def test_twins_match_pallas_batch_paths(bucket, port):
    """Against the lane-batched log kernels with paths in lanes
    (interpret mode; they take P <= 4, and the JAX runner sends P = 8
    buckets to XLA): totals within 0.05 nats, pairs within 5e-3 (JAX's
    P > 1 survivors are u8, rounded to 1/255)."""
    P, jp, _ = bucket
    pal = _pallas(jp, P).execute(compact_k=1024, threshold=THR)
    for r, p in zip(port, pal):
        assert not p["numerics_suspect"]
        assert abs(r["total_f"] - p["total_f"]) <= 0.05
        assert abs(r["total_b"] - p["total_b"]) <= 0.05
        _assert_pairs_close(p["pairs"], r["pairs"], 5e-3 * 1e7, edge=5e-3)


def test_site_sums_match_folded_pairs(bucket, port):
    """HopperAligner.site_sums (index_add_ of the survivors at site cells)
    equals folding the reported pairs (marginals_from_pairs): per-site
    calls within 1e-6 (the pairs' 1e-7 flooring)."""
    P, _, tp = bucket
    sites = [_site_cells(p, K, "Y") for p in tp]
    assert all(len(s) for s in sites)
    sums = hk.HopperAligner(tp, W, CPU).site_sums(sites, THR)
    for p, s, r, x in zip(tp, sums, port, sites):
        assert s["site_probs"].shape == (P, len(x))
        assert s["total_f"] == r["total_f"]
        got = port_vc.marginals_from_site_probs(x, s["site_probs"], p, "CT")
        want = marginals_from_pairs(r["pairs"], x, p, "CT")
        assert set(got) == set(want)
        for pos in want:
            for b in "CT":
                assert abs(got[pos][b] - want[pos][b]) <= 1e-6


@pytest.mark.parametrize("bucket", [2, 4], indirect=True)
def test_site_sums_match_execute_site_marginals(bucket):
    """Against the JAX device site path (execute_site_marginals over the
    u16 posterior stack, interpret mode; P <= 4): per-site calls within
    0.02, JAX's own bound against the host marginalizer."""
    P, jp, tp = bucket
    sites = [_site_cells(p, K, "Y") for p in tp]
    want = _pallas(jp, P).execute_site_marginals(sites, threshold=THR)()
    got = hk.HopperAligner(tp, W, CPU).site_sums(sites, THR)
    for p, x, w, g in zip(tp, sites, want, got):
        assert abs(w["total_f"] - g["total_f"]) <= 0.05
        cw = marginals_from_site_probs(x, w["site_probs"][:P], p, "CT")
        cg = port_vc.marginals_from_site_probs(x, g["site_probs"], p, "CT")
        assert set(cw) == set(cg) and len(cg) >= len(x) // 2
        for pos in cw:
            assert abs(cw[pos]["C"] - cg[pos]["C"]) <= 0.02


def test_reset_launch_counts_zeroes_every_counter():
    """``reset_launch_counts`` zeroes every launch counter of both
    log-space wrappers, the wide instances' by instance (cluster, scratch)
    among them, of the expectation sums and of the probability-space
    pair."""
    names = ("launches", "expect_launches", "expect_paths_launches",
             "expect_pair2_launches", "wide_launches", "cluster_launches",
             "wide_scratch_launches")
    fns = (hk.forward_sweep, hk.backward_sweep_compact)
    for fn in fns:
        for name in names:
            setattr(fn, name, 3)
    hk.expect_sums.launches = 3
    hk.forward_sweep_prob.launches = 3
    hk.backward_sweep_compact_prob.launches = 3
    hk.reset_launch_counts()
    assert all(getattr(fn, name) == 0 for fn in fns for name in names)
    assert hk.expect_sums.launches == 0
    assert hk.forward_sweep_prob.launches == 0
    assert hk.backward_sweep_compact_prob.launches == 0


def test_wrappers_take_paths_on_cpu_and_count_no_launch(bucket):
    """On CPU tensors the wrappers are their twins for P > 1 too, and no
    launch is counted; survivor slots never overflow."""
    P, _, tp = bucket
    hk.reset_launch_counts()
    pt = problem_tensors(tp[:2], W, CPU)
    f, fi, lf = hk.forward_sweep(pt)
    assert f.shape == (2, pt.x0.shape[1], P, W)
    f_ref, _, lf_ref = hk.forward_sweep_ref(pt)
    assert torch.equal(f, f_ref) and torch.equal(lf, lf_ref)
    fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
    R = hk.survivor_slots(THR)
    got = hk.backward_sweep_compact(pt, f, fo - tf[:, None], THR, R)
    want = hk.backward_sweep_compact_ref(pt, f, fo - tf[:, None], THR, R)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert 0 < int(got[4].max()) <= R
    assert hk.forward_sweep.launches == hk.backward_sweep_compact.launches == 0
