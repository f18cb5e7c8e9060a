"""The port's HDP emissions against the JAX package on the CPU: the spline
twin (``hdp_spline_density``/``hdp_log_emission``) against the JAX spline
and the float64 host density, both packages' ``load_nhdp`` on one file,
and the plain sweeps in MODE_HDP (the Hopper kernels' twins) with 1, 2, 4
and 8 paths per cell, held to the JAX XLA scan, the lane-batched Pallas
kernels with the HDP emission stream in interpret mode (banked and fused
spline kernels) and the float64 oracle. The HDP is a seeded synthetic
one over a seeded synthetic ACEGT pore model, written as an ``.nhdp``
file that the JAX package loads; the port gets converted copies."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.banded_fb_pallas_batch import PallasBatchAligner
from signalalign_tpu.ops.batch import run_banded_fb_batch as jax_batch
from signalalign_tpu.ops.emission_stream import hdp_emission_stacks
from signalalign_tpu.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.convert import (hdp_from_numpy, hdp_tables,
                                           pore_model_from_numpy,
                                           problem_from_numpy, problem_tensors)
from signalalign_tpu_torch.models import hdp_model as port_hdp_model
from signalalign_tpu_torch.models import pore_model as port_pm
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.ops.batch import run_banded_fb_batch
from signalalign_tpu_torch.utils.synthetic import (synthetic_hdp,
                                                   synthetic_pore_model,
                                                   write_nhdp_text)

W, DPAD, THR = 128, 192, 0.01
CPU = torch.device("cpu")
# ambiguity clusters that set the largest path count of a segment: one P
# (C or E: 2 paths), two P in a 5-mer (4) and three (8)
CLUSTERS = {1: "", 2: "P", 4: "PGP", 8: "PGPGP"}


def _models(alphabet="ACEGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = JPoreModel(alphabet, k)
    src = synthetic_pore_model(0, alphabet, k)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm, pore_model_from_numpy(jm)


def _hdps(path, model, grid_length=121):
    """(JAX NanoporeHDP loaded by the JAX package from an .nhdp file that
    write_nhdp_text made from synthetic_hdp, the port's copy of it)."""
    write_nhdp_text(synthetic_hdp(model, 1, grid_length=grid_length), path)
    jh = jax_hdp_model.load_nhdp(path)
    return jh, hdp_from_numpy(jh)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX model, port model, JAX HDP, port HDP (ACEGT 5-mers, grid
    30-180 pA at 121 points)."""
    jm, pm = _models()
    jh, ph = _hdps(str(tmp_path_factory.mktemp("hdp") / "m.nhdp"), pm)
    return jm, pm, jh, ph


def test_load_nhdp_matches_jax_and_round_trips(tmp_path):
    """Both packages' load_nhdp on one write_nhdp_text file (ACEGOT
    3-mers, a 61-point grid) give equal arrays, equal to the tables that
    were written; hdp_from_numpy copies the JAX object field for field."""
    _, pm = _models("ACEGOT", 3)
    src = synthetic_hdp(pm, 2, grid_length=61)
    path = write_nhdp_text(src, str(tmp_path / "t.nhdp"))
    jh = jax_hdp_model.load_nhdp(path)
    ph = port_hdp_model.load_nhdp(path)
    conv = hdp_from_numpy(jh)
    for h in (ph, conv):
        assert h.alphabet.letters == jh.alphabet.letters == "ACEGOT"
        assert h.alphabet.kmer_length == 3 and h.num_dps == jh.num_dps
        for name in ("grid", "densities", "slopes", "observed", "dp_parent"):
            a, b = getattr(jh, name), getattr(h, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert all(np.array_equal(a, b)
                   for a, b in zip(jh.dp_densities, h.dp_densities))
    assert np.array_equal(ph.densities, src.densities.astype(np.float64))
    assert np.array_equal(ph.slopes, src.slopes.astype(np.float64))
    assert np.array_equal(ph.grid, src.grid) and ph.observed.all()
    # density_arrays converts once and hands out the same arrays
    a1, a2 = ph.density_arrays(), ph.density_arrays()
    assert a1[0] is a2[0] and a1[1] is a2[1] and a1[0].dtype == np.float32


def test_spline_matches_jax_and_host_density(tmp_path):
    """hdp_spline_density / hdp_log_emission against the JAX
    hdp_spline_density (XLA, f32) and the float64 hdp_log_density_batch,
    at x below, on and above the grid, on knots and between them, for
    k-mers whose densities are broad enough that the grid's ends carry
    mass: densities within 1e-6 relative, logs within 1e-5 absolute."""
    jm, pm = _models()
    pm.level_sd = pm.level_sd * 25.0
    jh, ph = _hdps(str(tmp_path / "wide.nhdp"), pm, grid_length=121)
    dens, slopes, g0, dx = jh.density_arrays()
    tables = hdp_tables(dens, slopes, g0, dx, CPU)
    rng = np.random.default_rng(5)
    g = jh.grid
    x = np.concatenate([[g[0] - 7.3, g[0] - 0.01, g[0], g[-1], g[-1] + 0.02,
                         g[-1] + 9.1], g[::7], g[3::11] + 0.3 * dx,
                        rng.uniform(g[0] - 5, g[-1] + 5, 300)])
    kid = rng.integers(0, dens.shape[0], x.size)
    kid[:8] = 0                     # the id a path slot a position lacks gets
    x32 = x.astype(np.float32)
    want = np.asarray(jbfb.hdp_spline_density(
        x32, kid.astype(np.int32), dens, slopes, np.float32(g0),
        np.float32(dx)))
    got = bfb.hdp_spline_density(torch.from_numpy(x32), torch.from_numpy(kid),
                                 tables).numpy()
    assert (want > 0).sum() > 250
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    var = 1.07
    host = jax_hdp_model.hdp_log_density_batch(jh, kid, x32.astype(np.float64),
                                               var)
    logs = bfb.hdp_log_emission(torch.from_numpy(x32), torch.from_numpy(kid),
                                torch.tensor(var, dtype=torch.float32),
                                tables).numpy()
    finite = np.isfinite(host)
    assert finite.sum() > 250
    assert np.abs(logs[finite] - host[finite]).max() <= 1e-5
    assert (logs[~finite] == bfb.NEG).all()
    # the port's own float64 host density is the JAX package's copy
    assert np.array_equal(
        port_hdp_model.hdp_log_density_batch(ph, kid, x32.astype(np.float64),
                                             var), host)


def _problem_args(P, i, seed, jm):
    """(args, kwargs) of prepare_problem in MODE_HDP for a segment whose
    largest expansion is P paths: single P codes every ~25 positions (for
    P > 1), one cluster of CLUSTERS[P] mid-sequence, events drawn from the
    sequence with each P read as C, anchors every 15 events with a gap for
    a band bulge (none in problem 0). Segments of 55-85 bases (each
    comparison holds per problem, cell by cell) and Dpad 192 above their
    diagonals: the JAX scans run Dpad + 1 diagonals."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(55, 85))
    seq = list(rng.choice(list("ACGT"), size=L))
    if P > 1:
        for j in range(8, L - 8, 25):
            seq[j] = "P"
        mid = 18 + 25 * ((L // 2 - 8) // 25)
        seq[mid:mid + len(CLUSTERS[P])] = CLUSTERS[P]
    seq = "".join(seq)
    ids = jm.alphabet.seq_to_kmer_ids(seq.replace("P", "C"))
    ev = np.stack([jm.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                   np.ones(len(ids)), np.full(len(ids), .005),
                   np.arange(len(ids)) * .005], 1)
    n = len(ev)
    anchors = [(j, j) for j in range(8, n - 8, 15)
               if not (i and n // 3 < j < n // 3 + 40)]
    return ((seq, ev, jm, ScalingParams(shift=0.2 * i, var=1 + 0.05 * i),
             DEFAULT_AMBIG_BASES),
            dict(W=W, Dpad=DPAD, P=P, mode=bfb.MODE_HDP,
                 anchor_pairs=anchors, expansion=8))


@pytest.fixture(scope="module", params=[1, 2, 4, 8])
def bucket(request, models):
    """(P, JAX problems, the port's copies) of one HDP bucket: two
    problems of 55-85 bases, one with a band bulge (each is compared on
    its own; the JAX XLA scans run Dpad + 1 diagonals at P = 8, the
    costliest here)."""
    P = request.param
    jm, _, jh, _ = models
    jp = [jbfb.prepare_problem(*a, **kw, hdp=jh)
          for a, kw in (_problem_args(P, i, 300 + 10 * P + i, jm)
                        for i in range(2))]
    assert max(int(p.n_paths.max()) for p in jp) == P
    return P, jp, [problem_from_numpy(p) for p in jp]


@pytest.fixture(scope="module")
def port(bucket):
    """The aligner on CPU tensors (the kernels' twins): pairs + totals."""
    _, _, tp = bucket
    p0 = tp[0]
    tables = hdp_tables(p0.hdp_dens, p0.hdp_slopes, *p0.hdp_grid, CPU)
    return hk.HopperAligner(tp, W, CPU, tables).execute(THR)


def _assert_pairs_close(want, got, tol, edge):
    """Same (x, y, kmer) set except cells within ``edge`` of the
    threshold; shared pairs' posteriors within ``tol``; JAX order."""
    dw = {(x, y, k): p / 1e7 for p, x, y, k in want}
    dg = {(x, y, k): p / 1e7 for p, x, y, k in got}
    for key in set(dw) ^ set(dg):
        p = dw.get(key, dg.get(key))
        assert abs(p - THR) <= edge, (key, p)
    shared = set(dw) & set(dg)
    assert len(shared) > 0.98 * max(len(dw), len(dg))
    assert max(abs(dw[k] - dg[k]) for k in shared) <= tol
    assert [(x, y, k) for _, x, y, k in got if (x, y, k) in shared] == \
        [(x, y, k) for _, x, y, k in want if (x, y, k) in shared]


def test_prepare_problem_matches_jax_and_shares_tables(models):
    """The port's prepare_problem in MODE_HDP field for field and bit for
    bit against the JAX one, and every problem holds the HDP's own
    float32 tables (one conversion per HDP, no copy per problem)."""
    jm, pm, jh, ph = models
    got = []
    for i in range(2):
        args, kw = _problem_args(4, i, 17 + i, jm)
        want = jbfb.prepare_problem(*args, **kw, hdp=jh)
        seq, ev, _, params, amb = args
        got.append(bfb.prepare_problem(
            seq, ev, pm, port_pm.ScalingParams(**dataclasses.asdict(params)),
            dict(amb), **kw, hdp=ph))
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got[-1], f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
    dens, slopes = ph.density_arrays()[:2]
    assert all(p.hdp_dens is dens and p.hdp_slopes is slopes for p in got)


def test_problem_tensors_carry_the_hdp_rows(bucket):
    """problem_tensors of an HDP bucket: k-mer ids and level means per
    (problem, path, position) as in the problems, var in par, the tables
    by reference; a missing table and a mixed-mode bucket raise."""
    P, _, tp = bucket
    p0 = tp[0]
    tables = hdp_tables(p0.hdp_dens, p0.hdp_slopes, *p0.hdp_grid, CPU)
    pt = problem_tensors(tp, W, CPU, tables)
    assert pt.hdp is tables and pt.kid.dtype == torch.int32
    for i, p in enumerate(tp):
        lx = p.ref_params.shape[-1]
        assert np.array_equal(pt.kid[i, :, :lx].numpy(), p.kmer_ids)
        assert np.array_equal(pt.mu[i, :, :lx].numpy(), p.ref_params[7])
        assert pt.par[i, bfb.PACK_VAR].item() == np.float32(p.var)
    assert tables.gN == float(np.float32(p0.hdp_grid[0])
                              + np.float32(tables.NG - 1)
                              * np.float32(p0.hdp_grid[1]))
    with pytest.raises(ValueError, match="HDP tables"):
        problem_tensors(tp, W, CPU)
    gauss = dataclasses.replace(tp[0], mode=bfb.MODE_MEAN_ONLY)
    with pytest.raises(ValueError, match="mixes"):
        problem_tensors([gauss, tp[1]], W, CPU, tables)


def test_sweeps_match_jax_xla(bucket, port):
    """The port's XLA counterpart (ops.batch.run_banded_fb_batch) and the
    aligner's twins in MODE_HDP against the JAX XLA scan
    (run_banded_fb_batch, MODE_HDP): totals within 1e-5 relative, the
    same pairs except those within 2e-3 of the 0.01 threshold, shared
    posteriors within 1e-3 (f32 at ~2^10-nat log terms, PERF.md)."""
    P, jp, tp = bucket
    want = jax_batch(jp, W=W, P=P)
    res = run_banded_fb_batch(tp, W, P, device=CPU)
    for r, w, a, p in zip(res, want, port, jp):
        for got in (r, a):
            assert math.isclose(got["total_f"], w["total_f"], rel_tol=1e-5)
            assert math.isclose(got["total_b"], w["total_b"], rel_tol=1e-5)
        assert np.abs(r["post"] - w["post"]).max() <= 1e-3
        _assert_pairs_close(jbfb.extract_aligned_pairs(p, w["post"], THR),
                            a["pairs"], 1e-3, 2e-3)


@pytest.mark.parametrize("bucket", [1, 2], indirect=True)
def test_twins_match_pallas_hdp_stream(bucket, port):
    """Against the lane-batched log kernels fed by the HDP emission stream
    (interpret mode), once through the banked spline kernel
    (_spline_eval_banked_kernel, the default) and once through the fused
    one (_spline_eval_fused_kernel, forced with bank_maxb = 0): the two
    streams agree within 1e-5 nats on every cell, and each run's totals
    are within 0.05 nats of the twins' and its pairs within 5e-3 (JAX's
    survivors are u8)."""
    P, jp, _ = bucket
    al = PallasBatchAligner(jp, W=W, T=48, S=8, RB=256, interpret=True,
                            log_space=True, P=P)
    assert al.estream and al.bank_maxb > 0
    args = (*al.stream_in, al.hdp_dens, al.hdp_slopes, al.hdp_grid)
    banked = hdp_emission_stacks(*args, T=al.T, WBe=al.WBe,
                                 maxb=al.bank_maxb, interpret=True)
    fused = hdp_emission_stacks(*args, T=al.T, WBe=al.WBe, maxb=0,
                                interpret=True)
    for b, f in zip(banked, fused):
        # cells far from a k-mer's level underflow its Gaussian density
        # to 0 (NEG) in both
        b, f = np.asarray(b), np.asarray(f)
        live = (b > bfb.NEG / 2) | (f > bfb.NEG / 2)
        assert live.sum() > 100
        assert np.abs(b[live] - f[live]).max() <= 1e-5
        assert np.array_equal(b[~live], f[~live])
    runs = [al.execute(compact_k=1024, threshold=THR)]
    al.bank_maxb = 0
    runs.append(al.execute(compact_k=1024, threshold=THR))
    for pal in runs:
        for r, p in zip(port, pal):
            assert not p["numerics_suspect"]
            assert abs(r["total_f"] - p["total_f"]) <= 0.05
            assert abs(r["total_b"] - p["total_b"]) <= 0.05
            _assert_pairs_close(p["pairs"], r["pairs"], 5e-3, 5e-3)


@pytest.mark.parametrize("bucket", [1, 2], indirect=True)
@pytest.mark.parametrize("i", range(2))
def test_twins_match_float64_oracle(models, bucket, port, i):
    """The float64 oracle with HDP emissions (fb_oracle Emissions "hdp")
    on the bucket's first two problems: totals within 1e-4 relative, the
    same pairs except threshold-edge cells, posteriors within 3e-3."""
    P = bucket[0]
    jm, _, jh, _ = models
    (seq, ev, model, params, amb), kw = _problem_args(P, i, 300 + 10 * P + i,
                                                      jm)
    o = banded_forward_backward(
        CellPaths.from_sequence(seq, model, amb), ev, model,
        Emissions(model, params, mode="hdp", hdp=jh),
        anchor_pairs=kw["anchor_pairs"], expansion=kw["expansion"],
        threshold=THR)
    r = port[i]
    assert abs(r["total_f"] - o["total_log_prob_f"]) <= 1e-4 * abs(r["total_f"])
    assert abs(r["total_b"] - o["total_log_prob_b"]) <= 1e-4 * abs(r["total_b"])
    _assert_pairs_close(o["aligned_pairs"], r["pairs"], 3e-3, 3e-3)


def test_wrappers_take_hdp_on_cpu_and_count_no_launch(bucket):
    """On CPU tensors the wrappers are their twins in MODE_HDP too, and no
    launch is counted; survivor slots never overflow."""
    P, _, tp = bucket
    p0 = tp[0]
    tables = hdp_tables(p0.hdp_dens, p0.hdp_slopes, *p0.hdp_grid, CPU)
    hk.reset_launch_counts()
    pt = problem_tensors(tp[:2], W, CPU, tables)
    f, fi, lf = hk.forward_sweep(pt)
    f_ref, _, lf_ref = hk.forward_sweep_ref(pt)
    assert torch.equal(f, f_ref) and torch.equal(lf, lf_ref)
    fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
    R = hk.survivor_slots(THR)
    got = hk.backward_sweep_compact(pt, f, fo - tf[:, None], THR, R)
    want = hk.backward_sweep_compact_ref(pt, f, fo - tf[:, None], THR, R)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert 0 < int(got[4].max()) <= R
    assert hk.forward_sweep.launches == hk.backward_sweep_compact.launches == 0
