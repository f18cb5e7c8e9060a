"""The port's EM expectation pass against the JAX package on the CPU: the
plain expectation core (``bfb.expectations`` through
``run_banded_fb_batch(with_expectations=True)``) against the JAX XLA
core, the bucket aligner's ``expect`` (the kernels' twins on CPU tensors)
against ``PallasBatchAligner.execute_expect`` in interpret mode, the
transition posteriors against the float64 oracle, the wrappers on CPU
tensors, and em_train on reads whose segments have P = 4 paths per cell
against the JAX em_train (``tests/test_torch_expect_paths.py`` holds the
P > 1 expectation core itself). Gaussian and HDP problems are seeded
synthetic P = 1 segments; the HDP is a synthetic one written as an
``.nhdp`` file that the JAX package loads.

Tolerances: texp rtol 2e-4 / atol 5e-3 and kexp rtol 2e-3 / atol 5e-3,
those of the JAX package's own Pallas-vs-XLA expectation tests
(``tests/test_banded_fb.py:424-427``): both sides are f32 DPs whose
per-cell posteriors differ by f32 round-off; the JAX side sums them in
f32, the port in f64."""

import copy
import math

import numpy as np
import pytest
import torch

from signalalign_tpu.io.reference import \
    ProcessedReference as JaxProcessedReference
from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.banded_fb_pallas_batch import PallasBatchAligner
from signalalign_tpu.ops.batch import run_banded_fb_batch as jax_batch
from signalalign_tpu.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_tpu.pipeline.train import em_train as jax_em_train
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu.utils.synthetic import \
    build_synthetic_batch as jax_build_synthetic_batch
from signalalign_tpu_torch.convert import (hdp_tables, pore_model_from_numpy,
                                           problem_from_numpy, problem_tensors)
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.io.reference import (ProcessedReference,
                                                iter_fasta)
from signalalign_tpu_torch.ops.batch import run_banded_fb_batch
from signalalign_tpu_torch.pipeline.train import em_train
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_hdp,
                                                   synthetic_pore_model,
                                                   write_genome_fasta,
                                                   write_nhdp_text)

W, DPAD, THR = 128, 288, 0.01
CPU = torch.device("cpu")
TEXP_TOL = dict(rtol=2e-4, atol=5e-3)
KEXP_TOL = dict(rtol=2e-3, atol=5e-3)


def _models(alphabet="ACGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = JPoreModel(alphabet, k)
    src = synthetic_pore_model(0, alphabet, k)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm, pore_model_from_numpy(jm)


def _problem_args(jm, seed, n=3, L=120):
    """prepare_problem arguments of n P = 1 segments of L bases (events
    from the model's levels + N(0, 1.5 pA), anchors every 15 events;
    segment 1 lacks a run of anchors, so its band bulges)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        ids = jm.alphabet.seq_to_kmer_ids(seq)
        ev = np.stack([jm.level_mean[ids] + rng.normal(0, 1.5, len(ids)),
                       np.ones(len(ids)), np.full(len(ids), .005),
                       np.arange(len(ids)) * .005], 1)
        anchors = [(j, j) for j in range(10, len(ids) - 10, 15)
                   if not (i == 1 and 40 < j < 85)]
        out.append(((seq, ev, jm, ScalingParams(shift=1.0 + 0.3 * i,
                                                 var=1.0 + 0.05 * i),
                     DEFAULT_AMBIG_BASES),
                    dict(W=W, Dpad=DPAD, P=1, anchor_pairs=anchors,
                         expansion=8)))
    return out


@pytest.fixture(scope="module", params=["gaussian", "hdp"])
def case(request, tmp_path_factory):
    """(mode name, JAX problems, the port's copies, the port's HDP tables
    or None). HDP: an ACEGT 5-mer model and its synthetic HDP on a
    121-point grid."""
    if request.param == "gaussian":
        jm, _ = _models()
        args = _problem_args(jm, 5)
        jp = [jbfb.prepare_problem(*a, **kw, mode=bfb.MODE_MEAN_ONLY)
              for a, kw in args]
        return "gaussian", jp, [problem_from_numpy(p) for p in jp], None
    jm, pm = _models("ACEGT")
    path = str(tmp_path_factory.mktemp("hdp") / "m.nhdp")
    write_nhdp_text(synthetic_hdp(pm, 1, grid_length=121), path)
    jh = jax_hdp_model.load_nhdp(path)
    jp = [jbfb.prepare_problem(*a, **kw, mode=bfb.MODE_HDP, hdp=jh)
          for a, kw in _problem_args(jm, 11)]
    tp = [problem_from_numpy(p) for p in jp]
    tables = hdp_tables(tp[0].hdp_dens, tp[0].hdp_slopes, *tp[0].hdp_grid,
                        CPU)
    return "hdp", jp, tp, tables


@pytest.fixture(scope="module")
def port_expect(case):
    """The aligner's expectation pass on CPU tensors (the twins)."""
    _, _, tp, tables = case
    return hk.HopperAligner(tp, W, CPU, tables, expect=True).expect(THR)


def test_expectations_match_jax_xla_core(case):
    """run_banded_fb_batch(with_expectations=True) against the JAX batch
    path (the XLA ``_expectations_core``): totals within 5e-3 nats, texp
    and (Gaussian) kexp within the module's tolerances. In MODE_HDP the
    JAX XLA path alone computes Gaussian moments; the port returns zero
    kexp there (the TPU kernel's contract), and its ``expectations`` core
    with num_kmers reproduces the XLA moments."""
    mode, jp, tp, _ = case
    want = jax_batch(jp, W=W, P=1, with_expectations=True)
    got = run_banded_fb_batch(tp, W, 1, True, device=CPU)
    for g, x in zip(got, want):
        assert abs(g["total_f"] - x["total_f"]) <= 5e-3
        np.testing.assert_allclose(g["texp"], x["texp"], **TEXP_TOL)
        assert g["texp"].sum() > 100
        if mode == "gaussian":
            np.testing.assert_allclose(g["kexp"], x["kexp"], **KEXP_TOL)
        else:
            assert g["kexp"].shape == (3, 1) and not g["kexp"].any()
            assert np.abs(x["kexp"]).max() > 1.0
    if mode == "hdp":
        pt = problem_tensors(tp, W, CPU, case[3])
        f, fi, lf = bfb.sweep_forward(pt, store_full=True)
        b, bi, lb = bfb.sweep_backward(pt, store_full=True)
        fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
        bo, _ = bfb.backward_offsets(bi, lb)
        _, kexp = bfb.expectations(pt, f, b,
                                   *bfb.expect_cvecs(fo - tf[:, None], bo),
                                   tp[0].num_kmers)
        for i, x in enumerate(want):
            np.testing.assert_allclose(kexp[i].numpy(), x["kexp"], **KEXP_TOL)


def test_aligner_expect_matches_pallas_execute_expect(case, port_expect):
    """HopperAligner.expect (twins) against the lane-batched Pallas
    kernels' ``execute_expect`` in interpret mode, built as the JAX
    package's own expectation tests build it: totals within 1e-5
    relative, texp and kexp within the module's tolerances (HDP: both
    zero), the same aligned (x, y) cells."""
    mode, jp, _, _ = case
    al = PallasBatchAligner(jp, W=W, T=48, S=4, RB=256, interpret=True,
                            log_space=True, expect=True)
    pal = al.execute_expect(compact_k=1024)()
    for r, q in zip(port_expect, pal):
        assert math.isclose(r["total_f"], q["total_f"], rel_tol=1e-5)
        assert math.isclose(r["total_b"], q["total_b"], rel_tol=1e-5)
        np.testing.assert_allclose(r["texp"], q["texp"], **TEXP_TOL)
        if mode == "gaussian":
            np.testing.assert_allclose(r["kexp"], q["kexp"], **KEXP_TOL)
        else:
            assert not np.any(r["kexp"]) and not np.any(q["kexp"])
        assert {(x, y) for _, x, y, _ in r["pairs"]} \
            == {(x, y) for _, x, y, _ in q["pairs"]}


@pytest.mark.parametrize("i", range(3))
def test_texp_matches_float64_oracle(i):
    """Transition posteriors of the aligner's expectation pass against the
    float64 oracle's (``compute_expectations``) on short Gaussian
    segments, and the reference-style likelihood total_f * n_diag."""
    jm, _ = _models()
    (seq, ev, model, params, amb), kw = _problem_args(jm, 7, L=60)[i]
    o = banded_forward_backward(
        CellPaths.from_sequence(seq, model, amb), ev, model,
        Emissions(model, params, mode="mean_only"),
        anchor_pairs=kw["anchor_pairs"], expansion=kw["expansion"],
        threshold=THR, compute_expectations=True)
    p = problem_from_numpy(jbfb.prepare_problem(
        seq, ev, model, params, amb, **dict(kw, Dpad=160)))
    r = hk.HopperAligner([p], W, CPU, expect=True).expect(THR)[0]
    np.testing.assert_allclose(r["texp"], o["transition_expectations"],
                               **TEXP_TOL)
    assert abs(r["total_f"] * p.n_diag - o["likelihood"]) \
        <= 1e-4 * abs(o["likelihood"])


def test_wrappers_expect_on_cpu():
    """On CPU tensors both wrappers run their twins and launch nothing:
    the three-state forward's match rows equal the plain forward's, the
    expectation backward's survivors and offsets equal the plain
    backward's, and its texp / kx equal the twin's."""
    jm, _ = _models()
    tp = [problem_from_numpy(jbfb.prepare_problem(*a, **kw))
          for a, kw in _problem_args(jm, 5)[:2]]
    pt = problem_tensors(tp, W, CPU, kmer_ids=True)
    hk.reset_launch_counts()
    f3, fi3, lf3 = hk.forward_sweep(pt, expect=True)
    f1, fi1, lf1 = hk.forward_sweep(pt)
    B, D1 = pt.x0.shape
    assert f3.shape == (B, D1, 3, 1, W)
    assert torch.equal(f3[:, :, bfb.MATCH], f1) and torch.equal(fi3, fi1)
    fo, tf = bfb.forward_offsets(fi1, lf1, pt.meta[:, bfb.M_NDIAG])
    cvecf = fo - tf[:, None]
    R = hk.survivor_slots(THR)
    got = hk.backward_sweep_compact(pt, f3, cvecf, THR, R, expect=True)
    plain = hk.backward_sweep_compact(pt, f1, cvecf, THR, R)
    ref = hk.backward_sweep_compact_ref(pt, f3, cvecf, THR, R, expect=True)
    assert len(got) == 7 and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(got[:5], plain))
    texp, kx = got[5:]
    assert texp.shape == (B, 7) and kx.shape == (B, 3, 1, pt.ref.shape[-1])
    # kx's Σp over positions is the into-match transitions' sum (each
    # cell's three terms are added in f32 for kx)
    assert torch.allclose(kx[:, 0].sum((1, 2)), texp[:, 2:5].sum(1),
                          rtol=1e-6)
    for fn in (hk.forward_sweep, hk.backward_sweep_compact):
        assert fn.launches == 0 and fn.expect_launches == 0


def test_kexp_by_kmer_matches_numpy():
    """kexp_by_kmer (a float64 index_add_) against numpy's add.at."""
    rng = np.random.default_rng(1)
    kx = rng.normal(size=(3, 3, 50))
    kid = rng.integers(0, 16, size=(3, 50))
    want = np.zeros((3, 3, 16))
    for b in range(3):
        for r in range(3):
            np.add.at(want[b, r], kid[b], kx[b, r])
    got = bfb.kexp_by_kmer(torch.from_numpy(kx), torch.from_numpy(kid), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_em_train_with_more_than_one_path_matches_jax(tmp_path):
    """em_train on a two-read batch whose reference carries X (ACGT)
    codes in each read's window, clear of each other's k-mers, so that
    each read's segment has P = 4 paths per cell, against the JAX
    em_train (which sends such buckets to its XLA expectation core): one
    iteration of transitions and emissions (prior weight 5), within
    tests/test_torch_train.py's tolerances (transitions 1e-5, the
    log-likelihood 0.2 nats, level means and sds 5e-3 pA; kexp as there,
    rtol 2e-3 / atol 0.2)."""
    jm, pm = _models()
    # seed 14: both reads' one segment lands in one (W = 128, P = 4)
    # bucket, so each package compiles and runs one bucket shape
    kw = dict(n_reads=2, ev_min=300, ev_max=420, seed=14, genome_len=5_000,
              fasta_path=str(tmp_path / "plain.fa"))
    jr = jax_build_synthetic_batch(jm, **kw)[0]
    pr = build_synthetic_batch(pm, **kw)[0]
    genome = list(next(iter_fasta(kw["fasta_path"]))[1])
    for _, g in pr:
        for x in range(g.window_start + 40, g.window_end - 40, 60):
            genome[x] = "X"
    xfa = write_genome_fasta("".join(genome), str(tmp_path / "x.fa"))
    jref, pref = JaxProcessedReference(xfa), ProcessedReference(xfa)
    start = copy.deepcopy(jm)
    start.level_mean = start.level_mean + np.random.default_rng(99).normal(
        0.0, 1.5, size=start.level_mean.shape)
    em_kw = dict(iterations=1, update_transitions=True, update_emissions=True,
                 emission_prior_weight=5.0)
    want = jax_em_train([(r, g, jref) for r, g in jr], jref, start, **em_kw)
    got = em_train([(r, g, pref) for r, g in pr], pref,
                   pore_model_from_numpy(start), device=CPU, **em_kw)
    np.testing.assert_allclose(got.transitions_history[0],
                               want.transitions_history[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                               atol=0.2, rtol=0)
    np.testing.assert_allclose(got.kexp_history[0], want.kexp_history[0],
                               rtol=2e-3, atol=0.2)
    np.testing.assert_allclose(got.model.level_mean, want.model.level_mean,
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(got.model.level_sd, want.model.level_sd,
                               atol=5e-3, rtol=0)
    assert got.kexp_history[0][0].sum() > 100
    assert np.isfinite(got.log_likelihoods[0])
