"""The port's HDP methylation calling through its batch runner against the
JAX runner on the CPU: run_alignment_batch(..., hdp=, call_variants="CE")
on seeded synthetic reads over the CG -> PG edition of the genome (P: C
or E), held to the JAX XLA runner's site calls and to the ``variants``
files JAX run_signal_align writes, and HDP pair output held to the JAX XLA
runner. The JAX package gets its own model, HDP (loaded from an ``.nhdp``
file) and reads; the port gets converted copies and reads from its own
generator, which are checked equal."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import signalalign_tpu.pipeline.runner as jax_runner
from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.pipeline.signal_align import \
    AlignmentConfig as JaxAlignmentConfig
from signalalign_tpu.utils.synthetic import \
    build_synthetic_batch as jax_build_synthetic_batch
from signalalign_tpu_torch.convert import hdp_from_numpy, pore_model_from_numpy
from signalalign_tpu_torch.ops.banded_fb import MODE_HDP
from signalalign_tpu_torch.pipeline.runner import (run_alignment_batch,
                                                   write_outputs)
from signalalign_tpu_torch.pipeline.signal_align import (AlignmentConfig,
                                                         align_read)
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_hdp,
                                                   synthetic_pore_model,
                                                   write_nhdp_text)

CPU = torch.device("cpu")
THR = 0.01
AMB = {"P": "CE"}
# posteriors: two f32 implementations at ~2^10-nat log terms (PERF.md)
TOL_POST = 1e-3


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """(JAX model, HDP, reads, CG -> PG edition), (the port's), fasta. Two
    reads: every comparison below holds per read and per segment, and
    two reads give segments of more than one path (C or E at each P)."""
    jm = JPoreModel("ACEGT", 5)
    src = synthetic_pore_model(0, "ACEGT", 5)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    pm = pore_model_from_numpy(jm)
    tmp = tmp_path_factory.mktemp("hdp_runner")
    path = write_nhdp_text(synthetic_hdp(pm, 1, grid_length=121),
                           str(tmp / "m.nhdp"))
    jh = jax_hdp_model.load_nhdp(path)
    ph = hdp_from_numpy(jh)
    fasta = str(tmp / "genome.fa")
    kw = dict(n_reads=2, ev_min=300, ev_max=600, seed=7, genome_len=20_000,
              fasta_path=fasta, ambig_frac=1.0, ambig_motif=("CG", "PG"))
    j = jax_build_synthetic_batch(jm, **kw)
    p = build_synthetic_batch(pm, **kw)
    assert len(j[2]) == len(p[2]) == 2
    for (jr, jg), (pr, pg) in zip(j[2], p[2]):
        assert np.array_equal(jr.events, pr.events)
        assert np.array_equal(jr.event_map, pr.event_map)
        assert jr.template_read == pr.template_read and jg.ops == pg.ops
    return (jm, jh, j[2], j[3]), (pm, ph, p[2], p[3]), fasta


def _config(port=True):
    cls = AlignmentConfig if port else JaxAlignmentConfig
    return cls(emission_mode=MODE_HDP, ambig_map=AMB)


@pytest.fixture(scope="module")
def port_calls(batch):
    pm, ph, rgs, ref = batch[1]
    return run_alignment_batch(rgs, ref, pm, _config(), ph, device=CPU,
                               call_variants="CE")


def _rows(df):
    return [(r.strand, int(r.position)) for r in df.itertuples()]


def test_site_calls_match_jax_xla_runner(batch, port_calls):
    """Against JAX run_alignment_batch(..., hdp=, call_variants="CE",
    use_pallas=False): the same site rows in the same order, p_C and p_E
    within 1e-3, C + E = 1, totals within 5e-3 nats; every read has
    calls, each on a P of the edition."""
    jm, jh, rgs, ref = batch[0]
    want = jax_runner.run_alignment_batch(
        rgs, ref, jm, _config(False), hdp=jh, use_pallas=False,
        call_variants="CE")
    edition = batch[1][3].forward["synth"]
    assert len(port_calls) == len(want) == len(rgs)
    for g, w in zip(port_calls, want):
        assert g.read_label == w.read_label and g.aligned_pairs == []
        got, exp = g.variant_calls, w.variant_calls
        assert len(got) > 5 and _rows(got) == _rows(exp)
        assert list(got.columns) == list(exp.columns)
        for b in "CE":
            assert np.abs(got[b].to_numpy() - exp[b].to_numpy()).max() <= 1e-3
        assert np.abs(got["C"] + got["E"] - 1.0).max() <= 1e-6
        assert all(edition[int(q) + 4] == "P" for q in got["position"])
        assert abs(g.total_log_prob - w.total_log_prob) <= 5e-3
        assert g.total_log_prob > -1e29      # not an impossible alignment


def test_variants_files_match_jax_run_signal_align(batch, port_calls,
                                                   tmp_path, monkeypatch):
    """write_outputs(..., "variants") against the files JAX
    run_signal_align(..., hdp=) writes for the same reads (its fast5 and
    BAM readers replaced by the in-memory reads): the same file names,
    columns and row order, probabilities within 1e-3."""
    (jm, jh, rgs, _), (pm, _, _, _), fasta = batch
    monkeypatch.setattr(jax_runner, "filter_reads",
                        lambda *a, **kw: list(rgs))
    monkeypatch.setattr(jax_runner.NanoporeReadData, "from_fast5",
                        staticmethod(lambda read, **kw: read))
    monkeypatch.setattr(jax_runner, "guide_from_sam_record",
                        lambda guide: guide)
    jwritten = jax_runner.run_signal_align(
        "unused.bam", "unused.readdb", [], fasta, jm, str(tmp_path / "jax"),
        config=_config(False), output_format="variants",
        motifs=[("CG", "PG")], hdp=jh, verbose=False, variants="CE")
    pwritten = write_outputs(port_calls, pm, str(tmp_path / "port"),
                             "variants", variants="CE")
    assert [os.path.basename(p) for p in pwritten] == \
        [os.path.basename(p) for p in jwritten]
    assert len(pwritten) == len(rgs) + 2
    for pp, jp in zip(pwritten, jwritten):
        g = pd.read_csv(pp, sep="\t")
        w = pd.read_csv(jp, sep="\t")
        assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
        for c in g.columns:
            if c in ("C", "E"):
                assert np.abs(g[c] - w[c]).max() <= 1e-3
            else:
                assert g[c].tolist() == w[c].tolist(), (pp, c)


def test_pairs_match_jax_xla_runner(batch):
    """HDP pair output (call_variants=None) against the JAX XLA runner:
    totals within 5e-3 nats, the same pairs (with their path k-mers) and
    order except those within 2e-3 of the 0.01 threshold, shared
    posteriors within TOL_POST; align_read gives the batch's result for
    one read."""
    jm, jh, rgs, ref = batch[0]
    pm, ph, prgs, pref = batch[1]
    want = jax_runner.run_alignment_batch(rgs, ref, jm, _config(False),
                                          hdp=jh, use_pallas=False)
    got = run_alignment_batch(prgs, pref, pm, _config(), ph, device=CPU)
    assert len(got) == len(want) == len(rgs)
    for p, x in zip(got, want):
        assert abs(p.total_log_prob - x.total_log_prob) <= 5e-3
        assert p.total_log_prob > -1e29
        dw = {r[1:]: r[0] for r in x.aligned_pairs}
        dg = {r[1:]: r[0] for r in p.aligned_pairs}
        for key in set(dw) ^ set(dg):
            assert abs(dw.get(key, dg.get(key)) / 1e7 - THR) <= 2e-3
        shared = set(dw) & set(dg)
        assert len(shared) > 0.98 * max(len(dw), len(dg))
        assert max(abs(dw[k] - dg[k]) for k in shared) <= TOL_POST * 1e7
        assert [r[1:] for r in p.aligned_pairs if r[1:] in shared] == \
            [r[1:] for r in x.aligned_pairs if r[1:] in shared]
        # pairs at ambiguous positions carry their path's k-mer
        amb = [k for _, xx, _, k in p.aligned_pairs
               if "P" in p.target[xx:xx + len(k)]]
        assert amb and all(set(k) <= set("ACEGT") for k in amb)
    one = align_read(*prgs[0], pref, pm, _config(), ph, device=CPU)
    assert one.aligned_pairs == got[0].aligned_pairs


def test_hdp_mode_needs_its_model(batch):
    """MODE_HDP without an HDP raises before any read is prepared."""
    pm, _, rgs, ref = batch[1]
    with pytest.raises(ValueError, match="hdp"):
        run_alignment_batch(rgs, ref, pm, _config(), device=CPU)
