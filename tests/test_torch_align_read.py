"""The port's single-read entry point and its batch runner's per-read
isolation, on the CPU: ``align_read`` against the JAX ``align_read`` on a
read long enough for the batch runner to split it (25,258 diagonals),
and ``run_alignment_batch`` on a batch in which one read's window holds
more paths per cell than the kernels take."""

import numpy as np
import pytest
import torch

import signalalign_tpu.pipeline.signal_align as jax_signal_align
from signalalign_tpu.pipeline.signal_align import \
    AlignmentConfig as JaxAlignmentConfig
from signalalign_tpu_torch.io.reference import ProcessedReference
from signalalign_tpu_torch.ops import banded_fb_hopper
from signalalign_tpu_torch.pipeline.runner import run_alignment_batch
from signalalign_tpu_torch.pipeline.signal_align import (AlignmentConfig,
                                                         align_read)
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_pore_model,
                                                   write_genome_fasta)
from test_torch_runner import TOL_POST, _both_batches, _models

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


def test_batch_drops_a_read_of_more_than_8_paths(tmp_path, capsys):
    """Two X (ACGT) sites in one k-mer of one read's window give that
    read P = 16: run_alignment_batch reports it FAILED and aligns the
    others exactly as it does without it."""
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=4, ev_min=300, ev_max=600, seed=8, genome_len=20_000,
        fasta_path=str(tmp_path / "g.fa"))
    with open(fasta) as fh:
        genome = "".join(l.strip() for l in fh if not l.startswith(">"))
    g0 = rgs[0][1]
    site = (g0.window_start + g0.window_end) // 2
    assert not any(g.window_start <= site + 1 and site < g.window_end
                   for _, g in rgs[1:])
    edited = str(tmp_path / "x.fa")
    write_genome_fasta(genome[:site] + "XX" + genome[site + 2:], edited)
    reference = ProcessedReference(edited)
    both = run_alignment_batch(rgs, reference, model, AlignmentConfig(),
                               device=CPU, verbose=True)
    err = capsys.readouterr().err
    assert f"[runner] FAILED {rgs[0][0].read_label}: NotImplementedError: " \
        "segment of P=16" in err
    rest = run_alignment_batch(rgs[1:], reference, model, AlignmentConfig(),
                               device=CPU)
    assert [r.read_label for r in both] == [r.read_label for r in rest] \
        == [r.read_label for r, _ in rgs[1:]]
    for a, b in zip(both, rest):
        assert a.aligned_pairs == b.aligned_pairs and len(a.aligned_pairs)
        assert a.total_log_prob == b.total_log_prob
    with pytest.raises(NotImplementedError, match="P=16"):
        align_read(*rgs[0], reference, model, device=CPU)
    assert np.isfinite([r.total_log_prob for r in rest]).all()
