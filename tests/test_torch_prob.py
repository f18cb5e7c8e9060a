"""The port's probability-space DP (the plain twins of the Hopper kernels
``sa_fwd_sweep_prob`` / ``sa_bwd_sweep_compact_prob``, through
``HopperAligner(..., log_space=False)``) and the runner's residual guard,
on the CPU: held to the JAX package's probability-space Pallas kernels
(``PallasBatchAligner(log_space=False)`` in interpret mode), to the
port's log-space twins and to the float64 oracle, on the seeded problems
of ``test_torch_banded_fb`` and on ``outlier_segments``, which exhaust
the f32 range of the probability-space DP."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.banded_fb_pallas_batch import (PallasBatchAligner,
                                                        _pack16)
from signalalign_tpu.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.convert import problem_from_numpy, problem_tensors
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.pipeline import runner
from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   outlier_segments,
                                                   synthetic_read)
from test_torch_banded_fb import (MODEL, PORT_MODEL, THR, W,
                                  _assert_pairs_close, _port_args,
                                  _problem_args)

CPU = torch.device("cpu")
# posteriors of two f32 implementations whose log terms reach ~2^10 nats
# (8 f32 ulps there), as in test_torch_runner.py
TOL_PATH = 1e-3
W_OUT, DPAD_OUT = 512, 1024     # the outlier segments' bucket


@pytest.fixture(scope="module")
def problems():
    """The five seeded segments: JAX problems and the port's copies."""
    jp = [jbfb.prepare_problem(*a, **kw) for a, kw in _problem_args()]
    return jp, [problem_from_numpy(p) for p in jp]


@pytest.fixture(scope="module")
def jax_prob(problems):
    """The JAX probability-space kernels, interpret mode, once."""
    return PallasBatchAligner(problems[0], W=W, T=48, S=4, RB=256,
                              interpret=True, log_space=False).execute(
        compact_k=1024, threshold=THR)


@pytest.fixture(scope="module")
def port_prob(problems):
    return hk.HopperAligner(problems[1], W, CPU, log_space=False).execute(THR)


@pytest.fixture(scope="module")
def port_log(problems):
    return hk.HopperAligner(problems[1], W, CPU).execute(THR)


def test_prob_tensors_match_jax_inputs(problems):
    """The pack is the JAX ``_pack16`` (exp of the logs in float64, NEG an
    exact 0), the exp constants np.exp of the f32 ref rows, the event row
    and normaliser the problem's own."""
    jp, tp = problems
    pt = problem_tensors(tp, W, CPU, prob=True)
    pr = pt.prob
    for i, (j, p) in enumerate(zip(jp, tp)):
        assert np.array_equal(pr.par[i, :16].numpy(), _pack16(j))
        lx = p.ref_params.shape[-1]
        assert np.array_equal(pr.cexp[i, 0, :lx].numpy(),
                              np.exp(p.ref_params[2, 0]))
        assert np.array_equal(pr.cexp[i, 1, :lx].numpy(),
                              np.exp(p.ref_params[4, 0]))
        assert np.array_equal(pr.ev_best[i, :p.ev_best.shape[0]].numpy(),
                              j.ev_best)
        assert pr.ev_norm[i].item() == j.ev_norm_total
    assert pr.par[0, bfb.PACK_START + bfb.MATCH].item() == 0.0   # ragged


def test_prob_twins_match_jax_prob_kernels(jax_prob, port_prob):
    """Against ``_fwd_kernel``/``_bwd_kernel`` (log_space=False): totals
    within 0.05 nats, the same numerics_suspect lanes (none here), pairs
    within 4e-3 (the JAX u8 survivor values)."""
    assert [r["numerics_suspect"] for r in port_prob] \
        == [p["numerics_suspect"] for p in jax_prob] == [False] * 5
    for r, p in zip(port_prob, jax_prob):
        assert abs(r["total_f"] - p["total_f"]) <= 0.05
        assert abs(r["total_b"] - p["total_b"]) <= 0.05
        _assert_pairs_close(p["pairs"], r["pairs"], 4e-3 * 1e7)


def test_prob_twins_match_log_twins(port_prob, port_log):
    """The same problems through the log-space twins: totals within 5e-3
    nats, pairs within TOL_PATH."""
    for r, g in zip(port_prob, port_log):
        assert abs(r["total_f"] - g["total_f"]) <= 5e-3
        assert abs(r["total_b"] - g["total_b"]) <= 5e-3
        _assert_pairs_close(g["pairs"], r["pairs"], TOL_PATH * 1e7 + 1)


@pytest.mark.parametrize("i", range(5))
def test_prob_twins_match_float64_oracle(port_prob, i):
    """Totals within 1e-4 relative, pairs within 1e-4, against
    ``fb_oracle.banded_forward_backward``."""
    (seq, ev, model, params, amb), kw = _problem_args()[i]
    o = banded_forward_backward(
        CellPaths.from_sequence(seq, model, amb), ev, model,
        Emissions(model, params, mode="mean_only"),
        anchor_pairs=kw["anchor_pairs"], expansion=kw["expansion"],
        threshold=THR)
    r = port_prob[i]
    assert abs(r["total_f"] - o["total_log_prob_f"]) <= 1e-4 * abs(r["total_f"])
    assert abs(r["total_b"] - o["total_log_prob_b"]) <= 1e-4 * abs(r["total_b"])
    _assert_pairs_close(o["aligned_pairs"], r["pairs"], 1e-4 * 1e7 + 1)


@pytest.fixture(scope="module")
def outliers():
    """``outlier_segments`` (seed 7: the even ones carry a run of outlier
    events) at W=512 without anchors: JAX problems, the port's, the JAX
    probability-space kernels' results and the port's of both spaces."""
    kw = dict(W=W_OUT, Dpad=DPAD_OUT, P=1, mode=bfb.MODE_MEAN_ONLY,
              anchor_pairs=[], expansion=60)
    jp = [jbfb.prepare_problem(seq, ev, MODEL, ScalingParams(),
                               DEFAULT_AMBIG_BASES, **kw)
          for seq, ev in outlier_segments(PORT_MODEL)]
    tp = [problem_from_numpy(p) for p in jp]
    jres = PallasBatchAligner(jp, W=W_OUT, T=48, S=4, RB=256,
                              interpret=True, log_space=False).execute(
        compact_k=1024, threshold=THR)
    return (tp, jres,
            hk.HopperAligner(tp, W_OUT, CPU, log_space=False).execute(THR),
            hk.HopperAligner(tp, W_OUT, CPU).execute(THR))


def test_outliers_flag_the_lanes_jax_flags(outliers):
    """The port flags the lanes the JAX kernels flag (the two with the
    outlier run, whose totals are NaN), without raising; they report no
    pairs. The others match the log-space twins."""
    _, jres, prob, log = outliers
    assert [r["numerics_suspect"] for r in prob] \
        == [r["numerics_suspect"] for r in jres] == [True, False, True, False]
    for r, j, g in zip(prob, jres, log):
        assert not g["numerics_suspect"]
        if r["numerics_suspect"]:
            assert r["pairs"] == [] and not np.isfinite(r["total_f"])
            continue
        assert abs(r["total_f"] - j["total_f"]) <= 0.05
        _assert_pairs_close(j["pairs"], r["pairs"], 4e-3 * 1e7)
        assert abs(r["total_f"] - g["total_f"]) <= 5e-3
        _assert_pairs_close(g["pairs"], r["pairs"], TOL_PATH * 1e7 + 1)


def test_rerun_gives_flagged_lanes_the_log_results(outliers):
    """``runner.rerun_suspects`` replaces exactly the flagged results by
    the log-space path's, bit for bit."""
    tp, _, prob, log = outliers
    results = list(prob)
    tasks = [(0, 0, 0, p, W_OUT, DPAD_OUT, 1) for p in tp]
    assert runner.rerun_suspects(tasks, results, range(len(tp)), CPU,
                                 THR) == 2
    for i in (0, 2):
        assert results[i] == log[i]
    for i in (1, 3):
        assert results[i] is prob[i]


def test_prob_wrappers_use_twins_on_cpu_and_never_fall_back(problems):
    tp = problems[1][:2]
    hk.reset_launch_counts()
    pt = problem_tensors(tp, W, CPU, prob=True)
    f, fi, lf = hk.forward_sweep_prob(pt)
    want = hk.forward_sweep_prob_ref(pt)
    assert all(torch.equal(a, b) for a, b in zip((f, fi, lf), want))
    fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
    R = hk.survivor_slots(THR)
    got = hk.backward_sweep_compact_prob(pt, f, fo - tf[:, None], THR, R)
    want = hk.backward_sweep_compact_prob_ref(pt, f, fo - tf[:, None], THR, R)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert hk.forward_sweep_prob.launches == 0
    assert hk.backward_sweep_compact_prob.launches == 0
    # a tensor neither on the CPU nor on a CUDA device raises
    with pytest.raises(ValueError):
        hk.forward_sweep_prob(dataclasses.replace(pt, x0=pt.x0.to("meta")))
    # and log-space tensors do not run the probability-space sweeps
    with pytest.raises(ValueError, match="prob=True"):
        hk.forward_sweep_prob(problem_tensors(tp, W, CPU))


def test_prob_refuses_what_the_jax_kernels_refuse(problems):
    """P > 1, HDP, the expectation pass and W > 512 raise before any
    sweep, as the JAX aligner's asserts do."""
    tp = problems[1][:1]
    with pytest.raises(ValueError, match="W=768"):
        hk.HopperAligner(tp, 768, CPU, log_space=False)
    with pytest.raises(ValueError, match="expect True"):
        hk.HopperAligner(tp, W, CPU, expect=True, log_space=False)
    with pytest.raises(ValueError, match="P=2"):
        bfb.check_prob(W, 2, False)
    with pytest.raises(ValueError, match="HDP True"):
        bfb.check_prob(W, 1, True)


def test_prob_bucket_is_the_jax_gate(monkeypatch):
    """Only with the switch set, and then only P = 1 Gaussian pair-mode
    buckets of W <= 512 and at least 32 segments without expectations."""
    cfg = AlignmentConfig()
    monkeypatch.delenv(runner.PROB_SWITCH, raising=False)
    assert not runner.prob_bucket(256, 1, 64, cfg, False)
    monkeypatch.setenv(runner.PROB_SWITCH, "1")
    assert runner.prob_bucket(256, 1, 64, cfg, False)
    assert runner.prob_bucket(512, 1, 32, cfg, False)
    assert not runner.prob_bucket(768, 1, 64, cfg, False)
    assert not runner.prob_bucket(256, 2, 64, cfg, False)
    assert not runner.prob_bucket(256, 1, 31, cfg, False)
    assert not runner.prob_bucket(256, 1, 64, cfg, True)
    assert not runner.prob_bucket(
        256, 1, 64, AlignmentConfig(emission_mode=bfb.MODE_HDP), False)
    assert not runner.prob_bucket(
        256, 1, 64, AlignmentConfig(compute_expectations=True), False)
    monkeypatch.setenv(runner.PROB_SWITCH, "0")
    assert not runner.prob_bucket(256, 1, 64, cfg, False)


def test_event_normaliser_only_with_the_switch(problems):
    """The probability-space sweeps' event normaliser (a best case over
    every k-mer of the model for each event) is left out of the prep:
    ``prepare_problem`` gives Gaussian problems without it, log-space
    tensors of them form none, and ``problem_tensors(..., prob=True)``
    forms it, equal to the JAX ``prepare_problem``'s field. Which buckets
    of the runner form it (those run with SIGNALALIGN_TPU_PROB_KERNELS=1)
    is held by ``test_runner_prob_switch``."""
    jp = problems[0]
    port = [bfb.prepare_problem(*_port_args(a), **kw)
            for a, kw in _problem_args()]
    assert all(p.ev_best is None and p.ev_norm_total == 0.0
               and p.norm_source is not None for p in port)
    assert problem_tensors(port, W, CPU).prob is None
    assert all(p.ev_best is None for p in port)
    pt = problem_tensors(port, W, CPU, prob=True)
    for i, (p, j) in enumerate(zip(port, jp)):
        assert np.array_equal(p.ev_best, j.ev_best)
        assert p.ev_norm_total == j.ev_norm_total < 0.0
        assert np.array_equal(pt.prob.ev_best[i, :p.ev_best.shape[0]].numpy(),
                              j.ev_best)
        assert np.array_equal(p.ref_params, j.ref_params)


def test_runner_prob_switch(monkeypatch, capsys):
    """``run_alignment_batch`` with SIGNALALIGN_TPU_PROB_KERNELS=1 on a
    seeded ``build_synthetic_batch`` (whose reads follow their basecall
    errors, so every segment of theirs trips the guard) plus error-free
    reads from ``synthetic_read`` (a 32+ segment bucket where most pass):
    exactly the buckets ``prob_bucket`` admits take the probability-space
    aligner, the flagged segments run again on the log-space one, and
    every read equals the default run's: totals within 5e-3 nats, pairs
    within TOL_PATH. P > 1 buckets (the CpG edition) stay log-space."""
    model = PORT_MODEL
    with tempfile.TemporaryDirectory() as tmp:
        rgs, ref, amb_rgs, amb_ref, _ = build_synthetic_batch(
            model, n_reads=6, ev_min=300, ev_max=900, seed=5,
            genome_len=20_000, fasta_path=os.path.join(tmp, "g.fa"),
            ambig_frac=1 / 3)
    rng = np.random.default_rng(3)
    genome = ref.forward["synth"]
    rgs = rgs + [synthetic_read(
        rng, genome, model, int(rng.integers(0, 19_000 - 700)),
        int(rng.integers(300, 600)), f"clean{i}", sub_rate=0.0,
        ins_rate=0.0, del_rate=0.0) for i in range(36)]
    cfg = AlignmentConfig(split_bigger_than=2500)
    seen = []

    normalised = []     # per aligner: its problems with an event normaliser

    class Recording(hk.HopperAligner):
        def __init__(self, problems, W, device, *args, **kw):
            normalised.append(sum(q.ev_best is not None for q in problems))
            super().__init__(problems, W, device, *args, **kw)
            seen.append((W, self.pt.P, len(problems), self.log_space))

    monkeypatch.setattr(runner, "HopperAligner", Recording)
    monkeypatch.delenv(runner.PROB_SWITCH, raising=False)
    base = runner.run_alignment_batch(rgs, ref, model, cfg, device=CPU)
    assert all(s[3] for s in seen) and not any(normalised)
    buckets = seen[:]
    seen.clear()
    normalised.clear()
    monkeypatch.setenv(runner.PROB_SWITCH, "1")
    stages = {}
    got = runner.run_alignment_batch(rgs, ref, model, cfg, device=CPU,
                                     stage_seconds=stages, verbose=True)
    prob = [s for s in seen if not s[3]]
    assert prob == [(w, p, n, False) for w, p, n, _ in buckets
                    if runner.prob_bucket(w, p, n, cfg, False)]
    assert prob and any(n < runner.PROB_MIN_BUCKET for _, _, n, _ in buckets)
    # the runner forms the event normaliser for the probability-space
    # buckets alone, before their aligners
    assert normalised[:len(buckets)] == [0 if s[3] else s[2]
                                         for s in seen[:len(buckets)]]
    n_prob = sum(n for _, _, n, _ in prob)
    n_rerun = sum(n for _, _, n, _ in seen[len(buckets):])
    assert 0 < n_rerun < n_prob and "rerun" in stages
    assert (f"re-running {n_rerun} of {n_prob} probability-space"
            in capsys.readouterr().err)
    assert len(got) == len(base) == len(rgs)
    for a, b in zip(base, got):
        assert a.read_label == b.read_label
        assert abs(a.total_log_prob - b.total_log_prob) <= 5e-3
        _assert_pairs_close(a.aligned_pairs, b.aligned_pairs,
                            TOL_PATH * 1e7 + 1)
    # the CpG edition's P > 1 buckets stay on the log-space sweeps (one
    # read's buckets show it)
    seen.clear()
    runner.run_alignment_batch(amb_rgs[:1], amb_ref, model, cfg, device=CPU)
    assert any(p > 1 for _, p, _, _ in seen)
    assert all(s[3] for s in seen if s[1] > 1)
