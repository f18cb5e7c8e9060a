"""The port's batch runner against the JAX runner on the CPU, on seeded
synthetic reads: the XLA path and the Pallas interpret path, the TSVs
written by write_outputs, output properties, HDP emissions through the
same entry point, a read with a segment of 64 paths per cell (three X
sites in one 5-mer) through both entry points against the JAX
package's, and the features outside the port's slice."""

import numpy as np
import pytest
import torch

from signalalign_tpu.io.reference import \
    ProcessedReference as JaxProcessedReference
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.pipeline.runner import \
    run_alignment_batch as jax_run_alignment_batch
from signalalign_tpu.pipeline.signal_align import \
    AlignmentConfig as JaxAlignmentConfig
from signalalign_tpu.utils.synthetic import \
    build_synthetic_batch as jax_build_synthetic_batch
from signalalign_tpu.utils.synthetic import \
    synthetic_read as jax_synthetic_read
from signalalign_tpu_torch.convert import pore_model_from_numpy
from signalalign_tpu_torch.io.reference import ProcessedReference
from signalalign_tpu_torch.ops.banded_fb import MODE_HDP
from signalalign_tpu_torch.pipeline.runner import (prepare_read,
                                                   run_alignment_batch,
                                                   write_outputs)
from signalalign_tpu_torch.pipeline.signal_align import (AlignmentConfig,
                                                         align_read)
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_hdp,
                                                   synthetic_pore_model,
                                                   synthetic_read)

CPU = torch.device("cpu")
THR = 0.01
# Posterior tolerance against the JAX package on these reads. Both are f32,
# and at the cells that carry the alignment the normalised forward and
# backward logs and the offset constant reach ~2^10 nats (measured: f -614,
# b -326, cvec +940), where one f32 ulp is 1.2e-4: each package's posterior
# carries a few such ulps of its own (measured 2.4e-4 apart, and each
# 0.5e-3 to 1.3e-3 from the float64 oracle on these segments), so 1e-4
# cannot hold; 1e-3 is 8 ulps at 2^10.
TOL_POST = 1e-3


def _models(seed=0, alphabet="ACGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = JPoreModel(alphabet, k)
    src = synthetic_pore_model(seed, alphabet, k)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm, pore_model_from_numpy(jm)


def _both_batches(jm, pm, fasta, **kw):
    """One seeded batch from both packages' build_synthetic_batch: the JAX
    objects for the JAX runner, the port's for the port; their event
    arrays, event maps, reads and guide ops are equal."""
    j = jax_build_synthetic_batch(jm, fasta_path=fasta, **kw)
    p = build_synthetic_batch(pm, fasta_path=fasta, **kw)
    for jl, pl in ((j[0], p[0]), (j[2], p[2])):
        assert len(jl) == len(pl)
        for (jr, jg), (pr, pg) in zip(jl, pl):
            assert np.array_equal(jr.events, pr.events)
            assert np.array_equal(jr.event_map, pr.event_map)
            assert jr.template_read == pr.template_read and jg.ops == pg.ops
    return j, p


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """(JAX model, reads, reference), (the port's model, reads,
    reference)."""
    jm, pm = _models()
    fasta = tmp_path_factory.mktemp("ref") / "genome.fa"
    j, p = _both_batches(jm, pm, str(fasta), n_reads=4, ev_min=300,
                         ev_max=900, seed=5, genome_len=20_000)
    return (jm, j[0], j[1]), (pm, p[0], p[1])


@pytest.fixture(scope="module")
def port(batch):
    model, rgs, reference = batch[1]
    return run_alignment_batch(rgs, reference, model, device=CPU)


@pytest.fixture(scope="module")
def xla(batch):
    model, rgs, reference = batch[0]
    return jax_run_alignment_batch(rgs, reference, model, JaxAlignmentConfig(),
                                   use_pallas=False)


def _pairs_close(want, got, tol_int):
    dw = {(x, y, k): p for p, x, y, k in want}
    dg = {(x, y, k): p for p, x, y, k in got}
    for key in set(dw) ^ set(dg):
        p = dw.get(key, dg.get(key))
        assert abs(p / 1e7 - THR) <= TOL_POST, (key, p)
    return max(abs(dw[k] - dg[k]) for k in set(dw) & set(dg)) <= tol_int


def test_matches_jax_xla_runner(port, xla):
    """Totals within 5e-3 nats, pairs identical except threshold-edge
    cells, posteriors within TOL_POST."""
    assert len(port) == len(xla) == 4
    for p, x in zip(port, xla):
        assert p.read_label == x.read_label
        assert abs(p.total_log_prob - x.total_log_prob) <= 5e-3
        assert _pairs_close(x.aligned_pairs, p.aligned_pairs, TOL_POST * 1e7)
        assert p.event_offset == x.event_offset
        assert p.ref_offset == x.ref_offset and p.forward == x.forward
        assert p.target == x.target


def test_matches_jax_pallas_interpret_runner(batch, port):
    """Against the Pallas kernels in interpret mode (the per-read-row
    PallasAligner): totals within 0.05 nats, pairs within TOL_POST."""
    model, rgs, reference = batch[0]
    pal = jax_run_alignment_batch(rgs, reference, model, JaxAlignmentConfig(),
                                  use_pallas=True, pallas_interpret=True)
    for p, j in zip(port, pal):
        assert abs(p.total_log_prob - j.total_log_prob) <= 0.05
        assert _pairs_close(j.aligned_pairs, p.aligned_pairs, TOL_POST * 1e7)


@pytest.mark.parametrize("fmt", ["full", "variantCaller"])
def test_tsv_rows_match_jax(batch, port, xla, tmp_path, fmt):
    """write_outputs TSVs against the JAX results' rows: every column but
    the posterior identical, posteriors within TOL_POST."""
    jm, pm = batch[0][0], batch[1][0]
    written = write_outputs(port, pm, str(tmp_path), fmt)
    assert len(written) == len(port)
    prob_col = 12 if fmt == "full" else 3
    for path, x in zip(written, xla):
        rows = x.full_rows(jm) if fmt == "full" else x.vc_rows(jm)
        want = {}
        for r in rows:
            line = r.tsv() if fmt == "full" else \
                "\t".join(f"{v:f}" if isinstance(v, float) else str(v)
                          for v in r) + "\n"
            cols = line.rstrip("\n").split("\t")
            want[tuple(cols[:prob_col])] = cols
        got = {}
        with open(path) as fh:
            for line in fh:
                cols = line.rstrip("\n").split("\t")
                got[tuple(cols[:prob_col])] = cols
        assert len(set(want) ^ set(got)) <= 2        # threshold-edge cells
        for key in set(want) & set(got):
            w, g = want[key], got[key]
            assert abs(float(w[prob_col]) - float(g[prob_col])) <= TOL_POST + 1e-6
            skip = {prob_col} if fmt == "full" else {prob_col, 7}  # vc: score
            assert [c for i, c in enumerate(w) if i not in skip] == \
                [c for i, c in enumerate(g) if i not in skip]


def test_output_properties(batch, port, tmp_path):
    """Pair counts within [n/2, 3n] events (the upstream upper bound; these
    reads carry ~1.39 events per k-mer and only match events report a
    pair), every output k-mer equals the reference, totals agree."""
    model, rgs, reference = batch[1]
    genome = reference.forward["synth"]
    k = model.kmer_length
    for (read, _), r in zip(rgs, port):
        n = read.n_events
        assert n // 2 <= len(r.aligned_pairs) <= 3 * n
        assert r.max_total_gap < 1e-2
        for row in r.full_rows(model):
            i = row.reference_index
            assert genome[i:i + k] == row.reference_kmer
    written = write_outputs(port, model, str(tmp_path), "both")
    assert len(written) == 2 * len(port)


def test_hdp_emissions_run(batch):
    """MODE_HDP through the same entry point with ``hdp=`` (a synthetic
    HDP over the model's k-mers): every read aligns, its pairs sit within
    [n/2, 3n] events with output k-mers equal to the reference, and its
    totals agree."""
    model, rgs, reference = batch[1]
    hdp = synthetic_hdp(model, 1, grid_length=121)
    res = run_alignment_batch(rgs, reference, model,
                              AlignmentConfig(emission_mode=MODE_HDP), hdp,
                              device=CPU)
    genome = reference.forward["synth"]
    assert len(res) == len(rgs)
    for (read, _), r in zip(rgs, res):
        assert read.n_events // 2 <= len(r.aligned_pairs) <= 3 * read.n_events
        assert r.max_total_gap < 1e-2 and r.total_log_prob > -1e29
        for row in r.full_rows(model):
            i = row.reference_index
            assert genome[i:i + model.kmer_length] == row.reference_kmer


def test_outside_the_slice_raises(batch, port, tmp_path):
    """EM expectations run through the same entry point (per read: the
    transition posteriors, the Gaussian moments and the likelihood, with
    the pairs and totals of the plain run); the variants format needs its
    candidate bases."""
    model, rgs, reference = batch[1]
    res = run_alignment_batch(rgs, reference, model,
                              AlignmentConfig(compute_expectations=True),
                              device=CPU)
    assert len(res) == len(rgs)
    for r, p in zip(res, port):
        assert r.aligned_pairs == p.aligned_pairs
        assert r.total_log_prob == p.total_log_prob
        te = r.transition_expectations
        assert te.shape == (3, 3) and (te >= 0).all() and te.sum() > 0
        assert r.emission_expectations.shape == (3, model.num_kmers)
        # the into-match posteriors are the moments' Σp
        assert abs(r.emission_expectations[0].sum() - te[:, 0].sum()) \
            <= 1e-6 * te.sum()
        assert np.isfinite(r.likelihood) and r.likelihood < 0
    with pytest.raises(ValueError, match="variants="):
        write_outputs([], model, str(tmp_path), "variants")


@pytest.fixture(scope="module")
def x64(tmp_path_factory):
    """A read with a segment of 64 paths per cell: the motif edition puts
    the four-way code X (ACGT) at every C of a CG, so a CGCGCG window
    holds three X in one 5-mer (two legality words a mask). The read is
    60 bases (W = 64). Returns the port's run_alignment_batch and
    align_read results for it and the JAX package's, computed once: the
    JAX P = 64 sweeps cost ~30 s a call on the CPU, several times that
    beside tier-1's other workers. The read is one segment, which the
    JAX align_read and the JAX runner's XLA path run as the same problem
    (measured on the CPU: equal totals and equal pairs), so the JAX
    runner's result stands for both of its entry points."""
    tmp_path = tmp_path_factory.mktemp("x64")
    jm, model = _models(1)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=1, ev_min=300, ev_max=400, seed=2, genome_len=5000,
        fasta_path=str(tmp_path / "g.fa"))
    with open(fasta) as fh:
        body = "".join(line.strip() for line in fh if not line.startswith(">"))
    genome = body[:1000] + "ACGCGCGTA" + body[1009:]
    with open(fasta, "w") as fh:
        fh.write(">synth\n" + genome + "\n")
    reference = ProcessedReference(fasta, motifs=[("CG", "XG")])
    jref = JaxProcessedReference(fasta, motifs=[("CG", "XG")])
    read, guide = synthetic_read(np.random.default_rng(3), genome, model,
                                 970, 60, "x64")
    jread, jguide = jax_synthetic_read(np.random.default_rng(3), genome, jm,
                                       970, 60, "x64")
    assert np.array_equal(read.events, jread.events)
    config = AlignmentConfig(ambig_map={"X": "ACGT"})
    jconfig = JaxAlignmentConfig(ambig_map={"X": "ACGT"})
    assert [t[4] for t in prepare_read(read, guide, reference, model,
                                       config)[4]] == [64]
    want = jax_run_alignment_batch([(jread, jguide)], jref, jm, jconfig,
                                   use_pallas=False)
    got = run_alignment_batch([(read, guide)], reference, model, config,
                              device=CPU)
    one = align_read(read, guide, reference, model, config, device=CPU)
    return got, one, want, want[0]


def test_p64_read_aligns_as_the_jax_package(x64):
    """The x64 read (P = 64) through run_alignment_batch and align_read
    against the JAX package's (its runner's result, which its align_read
    gives on this one-segment read): the runner's totals within 5e-3 nats
    and pairs within TOL_POST but for threshold-edge cells; align_read's
    totals within 1e-3 relative and the same pairs, its X positions
    reporting their path's k-mer."""
    got, one, want, want1 = x64
    assert [r.read_label for r in got] == [r.read_label for r in want] \
        == ["x64"]
    assert abs(got[0].total_log_prob - want[0].total_log_prob) <= 5e-3
    assert _pairs_close(want[0].aligned_pairs, got[0].aligned_pairs,
                        TOL_POST * 1e7)
    assert abs(one.total_log_prob - want1.total_log_prob) \
        <= 1e-3 * abs(want1.total_log_prob)
    dw = {r[1:]: r[0] for r in want1.aligned_pairs}
    dg = {r[1:]: r[0] for r in one.aligned_pairs}
    assert set(dw) == set(dg) and len(dw) > 30
    assert max(abs(dw[k] - dg[k]) for k in dw) <= TOL_POST * 1e7
    assert {k for k in dg if "X" in k[2]} == set()


def test_p_greater_than_one_raises(x64):
    """A read with a segment of more than 32 paths per cell aligns (the
    port once dropped it): the x64 read through run_alignment_batch and
    align_read as the JAX package's runner aligns it (its align_read runs
    the read's one segment the same way): totals within 5e-3 nats, the
    same pairs but for threshold-edge cells, posteriors within TOL_POST,
    and the forward and backward totals within 1 nat."""
    got, one, want, _ = x64
    w = want[0]
    for g in (got[0], one):
        assert abs(g.total_log_prob - w.total_log_prob) <= 5e-3
        assert _pairs_close(w.aligned_pairs, g.aligned_pairs, TOL_POST * 1e7)
        assert len(g.aligned_pairs) > 30 and g.max_total_gap < 1.0
        assert g.target == w.target and g.event_offset == w.event_offset


def test_runner_windows_never_clamp(tmp_path):
    """Every problem prepare_read makes, on plain reads and on the same
    reads against the CG -> YG edition (P > 1), reads its W-wide
    reference and event windows inside its own tables on every diagonal
    the sweeps run: the clamps at 0, reflen - W and evlen - W (the JAX
    package's dynamic slices, which the kernels and twins copy) never
    move a window, since the runner prepares each problem at the W it
    runs (prepare_problem's tables are lX + 1 + W and lY + 6 + W long).
    Only a problem run wider than it was prepared clamps (the CUDA tests'
    clamp cases)."""
    _, model = _models(1)
    _, reference, rgs, amb_ref, _ = build_synthetic_batch(
        model, n_reads=6, ev_min=300, ev_max=3000, seed=5, genome_len=30000,
        fasta_path=str(tmp_path / "g.fa"), ambig_frac=1.0)
    config = AlignmentConfig()
    shapes = set()
    for ref in (reference, amb_ref):
        for read, guide in rgs:
            for _, p, W, _, P in prepare_read(read, guide, ref, model,
                                              config)[4]:
                shapes.add((W, P))
                d = np.arange(p.n_diag + 1)
                x0 = p.x0[:p.n_diag + 1].astype(np.int64)
                es = p.lY - d + x0 + p.ev_front_pad
                # the backward reads its targets' columns from x0 + 1
                assert x0.min() >= 0
                assert x0.max() + 1 <= p.ref_params.shape[-1] - W
                assert es.min() - 1 >= 0
                assert es.max() <= p.ev_params.shape[-1] - W
    assert any(P > 1 for _, P in shapes) and any(P == 1 for _, P in shapes)
