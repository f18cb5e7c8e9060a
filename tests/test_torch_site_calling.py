"""The port's site-mode methylation calling and P > 1 pair output through
the batch runner, against the JAX runner on the CPU, on seeded synthetic
reads over a CpG-ambiguous reference edition (``Y`` at every C of a CG):
the exact XLA fold, the Pallas interpret site path, the pair TSVs, and
the three ``variants`` files against what JAX ``run_signal_align``
writes."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import signalalign_tpu.pipeline.runner as jax_runner
from signalalign_tpu.io import guide as jax_guide
from signalalign_tpu.io import read as jax_read
from signalalign_tpu.io import reference as jax_reference
from signalalign_tpu.models import pore_model as jax_pm
from signalalign_tpu.pipeline.signal_align import \
    AlignmentConfig as JaxAlignmentConfig
from signalalign_tpu.utils.synthetic import \
    build_synthetic_batch as jax_build_synthetic_batch
from signalalign_tpu_torch.convert import pore_model_from_numpy
from signalalign_tpu_torch.io import guide as port_guide
from signalalign_tpu_torch.io import read as port_read
from signalalign_tpu_torch.io import reference as port_reference
from signalalign_tpu_torch.models import pore_model as port_pm
from signalalign_tpu_torch.pipeline.runner import (prepare_read,
                                                   run_alignment_batch,
                                                   write_outputs)
from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_pore_model)

CPU = torch.device("cpu")
THR = 0.01
AMB = {"Y": "CT"}
# posteriors: two f32 implementations at ~2^10-nat log terms (see
# tests/test_torch_runner.py)
TOL_POST = 1e-3


def _models(seed=0, alphabet="ACGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = jax_pm.PoreModel(alphabet, k)
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
    """(JAX model, reads, CpG edition), (the port's), fasta path. Two
    reads: each comparison below holds per read and per segment, and two
    reads of the CpG edition still give segments of more than one path
    count."""
    jm, pm = _models()
    fasta = str(tmp_path_factory.mktemp("ref") / "genome.fa")
    j, p = _both_batches(jm, pm, fasta, n_reads=2, ev_min=300, ev_max=700,
                         seed=6, genome_len=20_000, ambig_frac=1.0)
    return (jm, j[2], j[3]), (pm, p[2], p[3]), fasta


@pytest.fixture(scope="module")
def port_calls(batch):
    model, rgs, reference = batch[1]
    return run_alignment_batch(rgs, reference, model,
                               AlignmentConfig(ambig_map=AMB), device=CPU,
                               call_variants="CT")


@pytest.fixture(scope="module")
def port_pairs(batch):
    model, rgs, reference = batch[1]
    return run_alignment_batch(rgs, reference, model,
                               AlignmentConfig(ambig_map=AMB), device=CPU)


@pytest.fixture(scope="module")
def xla_pairs(batch):
    model, rgs, reference = batch[0]
    return jax_runner.run_alignment_batch(
        rgs, reference, model, JaxAlignmentConfig(ambig_map=AMB),
        use_pallas=False)


def _rows(df):
    return [(r.strand, int(r.position)) for r in df.itertuples()]


def _assert_calls_close(got, want, tol):
    """The same (strand, position) rows in the same order, C and T within
    ``tol``, and C + T = 1."""
    assert _rows(got) == _rows(want)
    assert list(got.columns) == list(want.columns)
    assert np.abs(got["C"].to_numpy() - want["C"].to_numpy()).max() <= tol
    assert np.abs(got["T"].to_numpy() - want["T"].to_numpy()).max() <= tol
    assert np.abs(got["C"] + got["T"] - 1.0).max() <= 1e-6


def test_path_split_segments_match_jax(tmp_path):
    """With path_split the port cuts the same segments as the JAX runner
    (start, sequence, events, W, Dpad, P), on longer reads whose segments
    hold P = 4 and P = 8 windows; the split isolates some of them."""
    jm, pm = _models()
    j, p = _both_batches(jm, pm, str(tmp_path / "g.fa"), n_reads=4,
                         ev_min=1500, ev_max=3000, seed=6, genome_len=20_000,
                         ambig_frac=1.0)
    counts = {}
    for split in (False, True):
        ps = set()
        n = 0
        for jrg, prg in zip(j[2], p[2]):
            want = jax_runner.prepare_read(
                *jrg, j[3], jm,
                JaxAlignmentConfig(ambig_map=AMB, path_split=split))[4]
            got = prepare_read(*prg, p[3], pm,
                               AlignmentConfig(ambig_map=AMB,
                                               path_split=split))[4]
            assert len(got) == len(want)
            for (go, gp, gW, gD, gP), (wo, wp, wW, wD, wP) in zip(got, want):
                assert (go, gp.seq, gW, gD, gP) == (wo, wp.seq, wW, wD, wP)
                assert np.array_equal(gp.ev_params, wp.ev_params)
                ps.add(gP)
            n += len(got)
        assert ps == {4, 8}
        counts[split] = n
    assert counts[True] > counts[False]


def test_site_calls_match_jax_xla_fold(batch, port_calls):
    """Against JAX run_alignment_batch(use_pallas=False,
    call_variants="CT"), the exact fold of the XLA pair stream: each
    probability within 1e-2 (0.01 of site mass is one threshold-edge
    survivor). Both skip P = 1 segments and give them total_f 0.0."""
    model, rgs, reference = batch[0]
    want = jax_runner.run_alignment_batch(
        rgs, reference, model, JaxAlignmentConfig(ambig_map=AMB),
        use_pallas=False, call_variants="CT")
    assert len(port_calls) == len(want) == len(rgs)
    for g, w in zip(port_calls, want):
        assert g.read_label == w.read_label
        assert g.aligned_pairs == [] and len(g.variant_calls) > 5
        _assert_calls_close(g.variant_calls, w.variant_calls, 1e-2)
        # the same segments run, so the same joint totals
        assert abs(g.total_log_prob - w.total_log_prob) <= 5e-3


@pytest.fixture(scope="module")
def cpg_batch(tmp_path_factory):
    """The JAX package's own site-calling batch (tests/test_site_calling.py)
    with the synthetic model: the first 4 of its 8 reads of 220 bases with
    gap-free guides over a CpG-dense reference whose CG became CGCG (each
    read is compared on its own, so four hold what eight did). Returns the
    JAX package's (model, reads, reference) and the port's."""
    model, pm = _models()
    rng = np.random.default_rng(9)
    core = "".join(rng.choice(list("ACGT"), size=598))
    genome = ("ACGT" * 40 + core + "ACGT" * 40).replace("CG", "CGCG")
    fasta = tmp_path_factory.mktemp("cpg") / "ref.fa"
    fasta.write_text(">chr\n" + genome + "\n")
    k = model.kmer_length
    both = []
    for ri in range(4):
        start, n = 40 + 17 * ri, 220
        read_seq = genome[start:start + n]
        events, event_map = [], []
        for kid in model.alphabet.seq_to_kmer_ids(read_seq):
            event_map.append(len(events))
            events.append([rng.normal(model.level_mean[kid],
                                      model.level_sd[kid]),
                           1.0, .002, len(events) * .002])
        event_map.extend([event_map[-1]] * (k - 1))
        both.append([
            (io_read.NanoporeReadData(
                read_label=f"p2r{ri}", template_read=read_seq,
                events=np.array(events), event_map=np.array(event_map),
                model_states=None, p_model_state=None, kmer_length=k,
                params=pm_mod.ScalingParams(), rna=False),
             io_guide.GuideAlignment(
                contig="chr", forward=True, window_start=start,
                window_end=start + n, query_start=0, query_end=n,
                ops=[(n, "M")]))
            for io_read, io_guide, pm_mod in ((jax_read, jax_guide, jax_pm),
                                              (port_read, port_guide,
                                               port_pm))])
    motifs = [("CG", "YG")]
    return ((model, [b[0] for b in both],
             jax_reference.ProcessedReference(str(fasta), motifs=motifs)),
            (pm, [b[1] for b in both],
             port_reference.ProcessedReference(str(fasta), motifs=motifs)))


def test_site_calls_match_jax_pallas_site_path(cpg_batch):
    """Against the JAX device site path (execute_site_marginals over the
    u16 posterior stack, Pallas interpret mode, u8 fractions) on the JAX
    package's own site batch: within 0.02, JAX's own bound. (On the
    synthetic batch above, whose bands pass 128 offsets, that path returns
    inf or zero sums; ROADMAP section 3.)"""
    (model, rgs, reference), (pm, prgs, pref) = cpg_batch
    cfg = dict(ambig_map=AMB)
    want = jax_runner.run_alignment_batch(
        rgs, reference, model, JaxAlignmentConfig(**cfg), use_pallas=True,
        pallas_interpret=True, call_variants="CT")
    got = run_alignment_batch(prgs, pref, pm, AlignmentConfig(**cfg),
                              device=CPU, call_variants="CT")
    for g, w in zip(got, want):
        assert len(w.variant_calls) > 10
        _assert_calls_close(g.variant_calls, w.variant_calls, 0.02)


def test_pairs_match_jax_xla_runner(batch, port_pairs, xla_pairs):
    """P > 1 pair output: totals within 5e-3 nats, pairs (with their path
    k-mers) identical except threshold-edge cells, posteriors within
    TOL_POST, in the JAX order."""
    assert len(port_pairs) == len(xla_pairs)
    for p, x in zip(port_pairs, xla_pairs):
        assert abs(p.total_log_prob - x.total_log_prob) <= 5e-3
        dw = {(xx, y, k): q for q, xx, y, k in x.aligned_pairs}
        dg = {(xx, y, k): q for q, xx, y, k in p.aligned_pairs}
        for key in set(dw) ^ set(dg):
            assert abs(dw.get(key, dg.get(key)) / 1e7 - THR) <= TOL_POST
        shared = set(dw) & set(dg)
        assert max(abs(dw[k] - dg[k]) for k in shared) <= TOL_POST * 1e7
        assert [r[1:] for r in p.aligned_pairs if r[1:] in shared] == \
            [r[1:] for r in x.aligned_pairs if r[1:] in shared]
        # pairs at ambiguous positions carry their path's k-mer
        amb = [k for _, xx, _, k in p.aligned_pairs
               if "Y" in p.target[xx:xx + len(k)]]
        assert amb and all(set(k) <= set("ACGT") for k in amb)


@pytest.mark.parametrize("fmt", ["full", "variantCaller"])
def test_tsv_rows_match_jax(batch, port_pairs, xla_pairs, tmp_path, fmt):
    """write_outputs P > 1 TSVs against the JAX results' rows: every
    column but the posterior (and the vc score) identical, posteriors
    within TOL_POST."""
    model, pm = batch[0][0], batch[1][0]
    written = write_outputs(port_pairs, pm, str(tmp_path), fmt)
    assert len(written) == len(port_pairs)
    prob_col = 12 if fmt == "full" else 3
    skip = {prob_col} if fmt == "full" else {prob_col, 7}

    def key(cols):
        return tuple(c for i, c in enumerate(cols) if i not in skip)

    for path, x in zip(written, xla_pairs):
        rows = x.full_rows(model) if fmt == "full" else x.vc_rows(model)
        want = {}
        for r in rows:
            line = r.tsv() if fmt == "full" else \
                "\t".join(f"{v:f}" if isinstance(v, float) else str(v)
                          for v in r) + "\n"
            cols = line.rstrip("\n").split("\t")
            want[key(cols)] = float(cols[prob_col])
        got = {}
        with open(path) as fh:
            for line in fh:
                cols = line.rstrip("\n").split("\t")
                got[key(cols)] = float(cols[prob_col])
        assert len(set(want) ^ set(got)) <= 4        # threshold-edge cells
        assert len(set(want) & set(got)) > 20
        for k in set(want) & set(got):
            assert abs(want[k] - got[k]) <= TOL_POST + 1e-6


def test_variants_files_match_jax_run_signal_align(batch, port_calls,
                                                   tmp_path, monkeypatch):
    """write_outputs(..., "variants") against the files JAX
    run_signal_align writes for the same reads (its fast5 and BAM readers
    replaced by the in-memory reads): the same file names, columns and
    row order, probabilities within 1e-2."""
    (model, rgs, _), (pm, _, _), fasta = batch
    monkeypatch.setattr(jax_runner, "filter_reads",
                        lambda *a, **kw: list(rgs))
    monkeypatch.setattr(jax_runner.NanoporeReadData, "from_fast5",
                        staticmethod(lambda read, **kw: read))
    monkeypatch.setattr(jax_runner, "guide_from_sam_record",
                        lambda guide: guide)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jwritten = jax_runner.run_signal_align(
        "unused.bam", "unused.readdb", [], fasta, model, str(jdir),
        config=JaxAlignmentConfig(ambig_map=AMB), output_format="variants",
        motifs=[("CG", "YG")], verbose=False, variants="CT")
    pwritten = write_outputs(port_calls, pm, str(pdir), "variants",
                             variants="CT")
    assert [os.path.basename(p) for p in pwritten] == \
        [os.path.basename(p) for p in jwritten]
    assert len(pwritten) == len(rgs) + 2
    for pp, jp in zip(pwritten, jwritten):
        g = pd.read_csv(pp, sep="\t")
        w = pd.read_csv(jp, sep="\t")
        assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
        for c in g.columns:
            if c in ("C", "T"):
                assert np.abs(g[c] - w[c]).max() <= 1e-2
            else:
                assert g[c].tolist() == w[c].tolist(), (pp, c)
