"""The port's banded forward-backward against the JAX package on the CPU:
the host problem build, the plain sweeps (the Hopper kernels' twins) and
the bucket aligner, held to the JAX XLA path and to both Pallas kernel
pairs in interpret mode. Inputs are seeded synthetic problems."""

import dataclasses

import numpy as np
import pytest
import torch

from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.banded_fb_pallas import PallasAligner
from signalalign_tpu.ops.banded_fb_pallas_batch import PallasBatchAligner
from signalalign_tpu.ops.batch import stack_problems
from signalalign_tpu.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.convert import (pore_model_from_numpy,
                                           problem_from_numpy, problem_tensors)
from signalalign_tpu_torch.models import pore_model as port_pm
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.ops.batch import run_banded_fb_batch
from signalalign_tpu_torch.utils.synthetic import synthetic_pore_model

W, DPAD, THR = 128, 512, 0.01
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


def _port_args(args):
    """prepare_problem's positional arguments with the port's model and
    scaling parameters in place of the JAX package's."""
    seq, ev, _, params, amb = args
    return (seq, ev, PORT_MODEL,
            port_pm.ScalingParams(**dataclasses.asdict(params)), dict(amb))


def _events(rng, seq, sd=1.2):
    ids = MODEL.alphabet.seq_to_kmer_ids(seq)
    return np.stack([MODEL.level_mean[ids] + rng.normal(0, sd, len(ids)),
                     np.ones(len(ids)), np.full(len(ids), .005),
                     np.arange(len(ids)) * .005], 1)


def _problem_args(seed=3):
    """(args, kwargs) of prepare_problem for 5 segments: one short (n_diag
    well below Dpad) and four with a band bulge where anchors are missing."""
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate((40, 120, 150, 175, 180)):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        ev = _events(rng, seq)
        n = len(ev)
        anchors = [(j, j) for j in range(8, n - 8, 15)
                   if not (i and n // 3 < j < n // 3 + 45)]
        out.append(((seq, ev, MODEL, ScalingParams(shift=0.2 * i, var=1 + 0.1 * i),
                     DEFAULT_AMBIG_BASES),
                    dict(W=W, Dpad=DPAD, P=1, mode=bfb.MODE_MEAN_ONLY,
                         anchor_pairs=anchors, expansion=8)))
    return out


@pytest.fixture(scope="module")
def problems():
    """The same segments for both packages: JAX problems, and the port's
    copies made with convert.problem_from_numpy."""
    jp = [jbfb.prepare_problem(*a, **kw) for a, kw in _problem_args()]
    return jp, [problem_from_numpy(p) for p in jp]


@pytest.fixture(scope="module")
def xla(problems):
    """JAX XLA path: posterior band, totals and aligned pairs per problem."""
    out = []
    for p in problems[0]:
        r = jbfb.run_banded_fb(p, W=W, P=1)
        r["pairs"] = jbfb.extract_aligned_pairs(p, r["post"], THR)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def port(problems):
    """The port's main path over the bucket: the wrappers on CPU tensors,
    i.e. forward_sweep_ref + backward_sweep_compact_ref."""
    return hk.HopperAligner(problems[1], W, CPU).execute(THR)


def _assert_pairs_close(want, got, tol_int):
    """Same (x, y, kmer) set except cells within 1e-4 of the threshold;
    shared pairs' prob_int within tol_int."""
    dw = {(x, y, k): p for p, x, y, k in want}
    dg = {(x, y, k): p for p, x, y, k in got}
    for key in set(dw) ^ set(dg):
        p = dw.get(key, dg.get(key))
        assert abs(p / 1e7 - THR) <= 1e-4, (key, p)
    shared = set(dw) & set(dg)
    assert len(shared) > 0.99 * max(len(dw), len(dg))
    assert max(abs(dw[k] - dg[k]) for k in shared) <= tol_int
    order = [(x, y) for _, x, y, _ in got]
    assert order == sorted(order, key=lambda c: (c[0] + c[1], c[0]))


def _ambiguous_args():
    rng = np.random.default_rng(11)
    seq = list("".join(rng.choice(list("ACGT"), size=60)))
    seq[20] = seq[40] = "Y"
    seq = "".join(seq)
    ev = _events(rng, seq.replace("Y", "C"))
    return ((seq, ev, MODEL, ScalingParams(), DEFAULT_AMBIG_BASES),
            dict(W=64, Dpad=256, P=2, mode=bfb.MODE_MEAN_ONLY, expansion=8))


@pytest.mark.parametrize("case", ["short", "bulge", "ambiguous"])
def test_prepare_problem_matches_jax(case):
    """Field for field and bit for bit, dtypes included (the event
    normaliser, which the port forms apart, by ``event_normaliser``)."""
    args, kw = {"short": _problem_args()[0], "bulge": _problem_args()[3],
                "ambiguous": _ambiguous_args()}[case]
    want = jbfb.prepare_problem(*args, **kw)
    got = bfb.event_normaliser(bfb.prepare_problem(*_port_args(args), **kw))
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_problems_have_bulges_and_padding(problems):
    jp = problems[0]
    assert jp[0].n_diag < DPAD // 4
    for p in jp[1:]:
        w = p.width[:p.n_diag + 1]
        assert w.max() > 2 * np.median(w)


def test_sweeps_match_jax_core(problems):
    """sweep_forward / sweep_backward (the twins' DP) against the JAX
    _banded_sweeps_core diagonal by diagonal: normalised rows within 1e-5
    on the probability scale, offsets within 1e-4 nats (f32 round-off)."""
    jp, tp = problems
    fj, fij, lfj, bj, bij, lbj = (np.asarray(a) for a in jbfb.banded_sweeps_batched(
        *stack_problems(jp), W=W, P=1, mode=bfb.MODE_MEAN_ONLY,
        store_full=False))
    pt = problem_tensors(tp, W, CPU)
    ft, fit, lft = (a.numpy() for a in bfb.sweep_forward(pt))
    bt, bit, lbt = (a.numpy() for a in bfb.sweep_backward(pt))
    for i, p in enumerate(tp):
        n = p.n_diag + 1
        assert np.abs(np.exp(fj[i, :n, 0]) - np.exp(ft[i, :n, 0])).max() < 1e-5
        assert np.abs(np.exp(bj[i, :n, 0]) - np.exp(bt[i, :n, 0])).max() < 1e-5
        assert np.abs(fij[i, :n] - fit[i, :n]).max() < 1e-4
        assert np.abs(bij[i, :n] - bit[i, :n]).max() < 1e-4
        assert abs(lfj[i] - lft[i]) < 1e-4 and abs(lbj[i] - lbt[i]) < 1e-4


def test_posterior_matches_xla(problems, xla):
    """ops.batch.run_banded_fb_batch and run_banded_fb (the port's XLA
    counterparts): totals within 5e-3 nats, posteriors within 1e-4."""
    res = run_banded_fb_batch(problems[1], W, 1, device=CPU)
    single = bfb.run_banded_fb(problems[1][1], W, 1, device=CPU)
    assert np.array_equal(single["post"], res[1]["post"])
    for r, x in zip(res, xla):
        assert r["post"].shape == x["post"].shape
        assert np.abs(r["post"] - x["post"]).max() <= 1e-4
        assert abs(r["total_f"] - x["total_f"]) <= 5e-3
        assert abs(r["total_b"] - x["total_b"]) <= 5e-3


def test_twins_match_xla(port, xla):
    """forward_sweep_ref + backward_sweep_compact_ref through the aligner
    against run_banded_fb + extract_aligned_pairs: totals within 5e-3
    nats, identical pairs except threshold-edge cells, posteriors within
    1e-4 (+1 for the floor to prob_int)."""
    for r, x in zip(port, xla):
        assert abs(r["total_f"] - x["total_f"]) <= 5e-3
        assert abs(r["total_b"] - x["total_b"]) <= 5e-3
        _assert_pairs_close(x["pairs"], r["pairs"], 1e-4 * 1e7 + 1)


@pytest.mark.parametrize("i", range(5))
def test_twins_match_float64_oracle(port, i):
    """The end of the reference chain: the float64 oracle. Totals within
    1e-4 relative (as the JAX package's own oracle tests), identical pairs
    except threshold-edge cells, posteriors within 1e-4."""
    (seq, ev, model, params, amb), kw = _problem_args()[i]
    o = banded_forward_backward(
        CellPaths.from_sequence(seq, model, amb), ev, model,
        Emissions(model, params, mode="mean_only"),
        anchor_pairs=kw["anchor_pairs"], expansion=kw["expansion"],
        threshold=THR)
    r = port[i]
    assert abs(r["total_f"] - o["total_log_prob_f"]) <= 1e-4 * abs(r["total_f"])
    assert abs(r["total_b"] - o["total_log_prob_b"]) <= 1e-4 * abs(r["total_b"])
    _assert_pairs_close(o["aligned_pairs"], r["pairs"], 1e-4 * 1e7 + 1)


def test_twins_match_pallas_aligner(problems, port):
    """Against the per-read-row Pallas kernels (interpret mode; x-frame,
    f64 host offset sums): totals within 0.05 nats, pairs within 1e-4."""
    pal = PallasAligner(problems[0], W, T=48, interpret=True).execute(
        compact_k=1024, threshold=THR)
    for r, p in zip(port, pal):
        assert abs(r["total_f"] - p["total_f"]) <= 0.05
        assert abs(r["total_b"] - p["total_b"]) <= 0.05
        _assert_pairs_close(p["pairs"], r["pairs"], 1e-4 * 1e7 + 1)


def test_twins_match_pallas_batch_fuse_compact(problems, port):
    """Against the lane-batched log kernels with in-sweep compaction
    (fuse_compact, interpret mode): totals within 0.05 nats, pairs within
    4e-3 (the u8 survivor values). Lanes JAX flags numerics_suspect (its
    5-slot rank overflow) are reported and left out; the port has none."""
    pal = PallasBatchAligner(problems[0], W=W, T=48, S=4, RB=256,
                             interpret=True, log_space=True).execute(
        compact_k=1024, threshold=THR)
    suspect = [i for i, p in enumerate(pal) if p["numerics_suspect"]]
    print(f"numerics_suspect lanes excluded: {suspect}")
    assert len(suspect) < len(pal)
    for i, (r, p) in enumerate(zip(port, pal)):
        if i in suspect:
            continue
        assert abs(r["total_f"] - p["total_f"]) <= 0.05
        assert abs(r["total_b"] - p["total_b"]) <= 0.05
        _assert_pairs_close(p["pairs"], r["pairs"], 4e-3 * 1e7)


def test_wrappers_use_twins_on_cpu_and_never_fall_back(problems):
    tp = problems[1][:2]
    hk.reset_launch_counts()
    pt = problem_tensors(tp, W, CPU)
    f, fi, lf = hk.forward_sweep(pt)
    f_ref, fi_ref, lf_ref = hk.forward_sweep_ref(pt)
    assert torch.equal(f, f_ref) and torch.equal(lf, lf_ref)
    fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
    cvecf = fo - tf[:, None]
    R = hk.survivor_slots(THR)
    got = hk.backward_sweep_compact(pt, f, cvecf, THR, R)
    want = hk.backward_sweep_compact_ref(pt, f, cvecf, THR, R)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[4].max()) <= R
    assert hk.forward_sweep.launches == 0
    assert hk.backward_sweep_compact.launches == 0
    # a tensor that is neither on the CPU nor on a CUDA device raises
    meta = dataclasses.replace(pt, x0=pt.x0.to("meta"))
    with pytest.raises(ValueError):
        hk.forward_sweep(meta)


def test_outside_the_slice_raises():
    """More than 32 paths per cell (three four-way codes in one 5-mer: 64
    paths) stack, with two legality words a mask that decode to the
    problem's legal planes; non-Gaussian emissions raise; EM expectations
    run (texp and kexp of a Gaussian problem from the same entry
    point)."""
    args, kw = _ambiguous_args()
    seq = args[0][:20] + "XXX" + args[0][23:]
    p64 = bfb.prepare_problem(*_port_args((seq, *args[1:])), **dict(kw, P=64))
    pt = problem_tensors([p64], 64, CPU)
    lx = p64.legal.shape[-1]
    assert pt.P == 64 and pt.leg.shape == (1, pt.ref.shape[-1], 128)
    u = pt.leg[0, :lx].numpy().view(np.uint32).reshape(lx, 64, 2)
    q = np.arange(64)
    legal = (u[:, :, q // 32] >> (q % 32).astype(np.uint32)) & 1
    assert np.array_equal(legal.transpose(1, 2, 0).astype(bool), p64.legal)
    args, kw = _problem_args()[0]
    p = bfb.prepare_problem(*_port_args(args), **dict(kw, mode=bfb.MODE_FULL))
    with pytest.raises(NotImplementedError, match="MODE_MEAN_ONLY"):
        problem_tensors([p], W, CPU)
    gauss = bfb.prepare_problem(*_port_args(args), **kw)
    r = run_banded_fb_batch([gauss], W, 1, True, device=CPU)[0]
    assert r["texp"].shape == (3, 3) and r["kexp"].shape == (3, 1024)
    assert np.isfinite(r["texp"]).all() and (r["texp"] >= 0).all()
    # every event is matched or stayed on once: the into-match and
    # into-gapY posteriors sum to the event count
    assert abs(r["texp"][:, [0, 2]].sum() - gauss.lY) <= 1e-3 * gauss.lY
    assert abs(r["kexp"][0].sum() - r["texp"][:, 0].sum()) <= 1e-6 * gauss.lY
