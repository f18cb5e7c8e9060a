"""The port's entry points and its batch runner's per-read isolation,
on the CPU: ``align_read`` against the JAX ``align_read`` on a read long
enough for the batch runner to split it (25,258 diagonals); a read with
a segment of 16 paths per cell (two X sites in one k-mer) through
``run_alignment_batch`` and ``align_read`` against the JAX package's
(the 64-path case is in test_torch_runner.py); a read whose prep fails
reported FAILED while the rest of its batch aligns; and the entry
points' default device."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import signalalign_tpu.pipeline.signal_align as jax_signal_align
from signalalign_tpu.io.reference import \
    ProcessedReference as JaxProcessedReference
from signalalign_tpu.pipeline.runner import \
    run_alignment_batch as jax_run_alignment_batch
from signalalign_tpu.pipeline.signal_align import \
    AlignmentConfig as JaxAlignmentConfig
from signalalign_tpu_torch.io.reference import ProcessedReference
from signalalign_tpu_torch.ops import banded_fb_hopper
from signalalign_tpu_torch.pipeline import train
from signalalign_tpu_torch.pipeline.runner import (prepare_read,
                                                   run_alignment_batch)
from signalalign_tpu_torch.pipeline.signal_align import (AlignmentConfig,
                                                         align_read)
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_pore_model,
                                                   write_genome_fasta)
from test_torch_runner import TOL_POST, _both_batches, _models, _pairs_close

CPU = torch.device("cpu")


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a function or a class)."""
    calls = []
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_align_read_matches_jax_align_read(tmp_path, monkeypatch):
    """A 14,669-event read (25,258 diagonals, past the batch runner's
    11,800-diagonal cap): both align_reads run it as one segment, with the
    same pairs, totals within 1e-3 relative and posteriors within the
    port's TOL_POST (two f32 implementations at ~2^10-nat log terms)."""
    jm, pm = _models()
    j, p = _both_batches(jm, pm, str(tmp_path / "genome.fa"), n_reads=1,
                         ev_min=14000, ev_max=15000, seed=3,
                         genome_len=60_000)
    jax_segments = _counting(monkeypatch, jax_signal_align, "_align_segment")
    want = jax_signal_align.align_read(*j[0][0], j[1], jm,
                                       JaxAlignmentConfig())
    port_segments = _counting(monkeypatch, banded_fb_hopper, "HopperAligner")
    got = align_read(*p[0][0], p[1], pm, device=CPU)
    assert len(jax_segments) == len(port_segments) == 1
    assert abs(got.total_log_prob - want.total_log_prob) \
        <= 1e-3 * abs(want.total_log_prob)
    dw = {r[1:]: r[0] for r in want.aligned_pairs}
    dg = {r[1:]: r[0] for r in got.aligned_pairs}
    assert set(dw) == set(dg) and len(dw) > 10_000
    assert max(abs(dw[k] - dg[k]) for k in dw) <= TOL_POST * 1e7
    assert [r[1:] for r in got.aligned_pairs] == \
        [r[1:] for r in want.aligned_pairs]
    # the runner's numerics guard; f32 totals of ~1e5 nats differ ~1e-2
    assert got.max_total_gap < 1.0
    assert (got.event_offset, got.ref_offset, got.forward, got.target) == \
        (want.event_offset, want.ref_offset, want.forward, want.target)


def _x_batch(tmp_path, sites):
    """Four seeded reads from both packages and a reference edited with
    ``sites`` X (ACGT) codes in one k-mer in the middle of read 0's
    window, which no other read's window reaches: (JAX batch and
    reference, the port's batch and reference)."""
    jm, pm = _models()
    fasta = str(tmp_path / "g.fa")
    j, p = _both_batches(jm, pm, fasta, n_reads=4, ev_min=300, ev_max=600,
                         seed=8, genome_len=20_000)
    with open(fasta) as fh:
        genome = "".join(l.strip() for l in fh if not l.startswith(">"))
    g0 = p[0][0][1]
    site = (g0.window_start + g0.window_end) // 2
    assert not any(g.window_start <= site + sites and site < g.window_end
                   for _, g in p[0][1:])
    edited = str(tmp_path / "x.fa")
    write_genome_fasta(genome[:site] + "X" * sites + genome[site + sites:],
                       edited)
    return ((jm, j[0], JaxProcessedReference(edited)),
            (pm, p[0], ProcessedReference(edited)))


def test_p16_read_aligns_as_the_jax_package(tmp_path):
    """Two X (ACGT) sites in one k-mer of one read's window give that
    read a segment of P = 16, which the kernels take since the legality
    masks hold 32 paths: run_alignment_batch aligns all four reads and
    align_read the P = 16 one, each against the JAX package's same entry
    point on the same files (its XLA path), with this file's tolerances:
    the runner's totals within 5e-3 nats and pairs within TOL_POST,
    align_read's totals within 1e-3 relative and the same pairs."""
    (jm, jrgs, jref), (pm, prgs, pref) = _x_batch(tmp_path, 2)
    got = run_alignment_batch(prgs, pref, pm, AlignmentConfig(), device=CPU)
    want = jax_run_alignment_batch(jrgs, jref, jm, JaxAlignmentConfig(),
                                   use_pallas=False)
    assert [r.read_label for r in got] == [r.read_label for r in want] \
        == [r.read_label for r, _ in prgs]
    for g, w in zip(got, want):
        assert abs(g.total_log_prob - w.total_log_prob) <= 5e-3
        assert _pairs_close(w.aligned_pairs, g.aligned_pairs, TOL_POST * 1e7)
        assert g.max_total_gap < 1.0
    one = align_read(*prgs[0], pref, pm, device=CPU)
    ref1 = jax_signal_align.align_read(*jrgs[0], jref, jm,
                                       JaxAlignmentConfig())
    assert abs(one.total_log_prob - ref1.total_log_prob) \
        <= 1e-3 * abs(ref1.total_log_prob)
    dw = {r[1:]: r[0] for r in ref1.aligned_pairs}
    dg = {r[1:]: r[0] for r in one.aligned_pairs}
    assert set(dw) == set(dg) and len(dw) > 100
    assert max(abs(dw[k] - dg[k]) for k in dw) <= TOL_POST * 1e7
    # the X positions report their path's k-mer, not the code
    assert {k for k in dg if "X" in k[2]} == set()


def test_batch_reports_a_failed_read(tmp_path, capsys):
    """A read whose prep fails (its guide covers one base: prepare_read
    raises ValueError for the empty alignment window) is reported FAILED
    by run_alignment_batch, and the other reads align exactly as they do
    without it; align_read raises for it."""
    _, pm = _models()
    rgs = build_synthetic_batch(pm, n_reads=3, ev_min=200, ev_max=300,
                                seed=4, genome_len=10_000,
                                fasta_path=str(tmp_path / "g.fa"))[0]
    reference = ProcessedReference(str(tmp_path / "g.fa"))
    read, guide = rgs[0]
    empty = dataclasses.replace(guide, query_end=guide.query_start + 1)
    with pytest.raises(ValueError, match="empty alignment window"):
        prepare_read(read, empty, reference, pm, AlignmentConfig())
    both = run_alignment_batch([(read, empty)] + rgs[1:], reference, pm,
                               AlignmentConfig(), device=CPU, verbose=True)
    assert f"[runner] FAILED {read.read_label}: ValueError: " in \
        capsys.readouterr().err
    rest = run_alignment_batch(rgs[1:], reference, pm, AlignmentConfig(),
                               device=CPU)
    assert [r.read_label for r in both] == [r.read_label for r in rest] \
        == [r.read_label for r, _ in rgs[1:]]
    for a, b in zip(both, rest):
        assert a.aligned_pairs == b.aligned_pairs and len(a.aligned_pairs)
        assert a.total_log_prob == b.total_log_prob
    assert np.isfinite([r.total_log_prob for r in rest]).all()
    with pytest.raises(ValueError, match="empty alignment window"):
        align_read(read, empty, reference, pm, device=CPU)


@pytest.mark.parametrize("entry", [
    run_alignment_batch, align_read, train.em_train,
    train.em_train_transitions, train.run_alignment_batch_grouped])
def test_entry_points_run_on_the_card_by_default(entry):
    """Each entry point's ``device`` defaults to CUDA: with no card the
    call raises as CUDA does, there is no CPU fallback."""
    param = inspect.signature(entry).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default == torch.device("cuda")
