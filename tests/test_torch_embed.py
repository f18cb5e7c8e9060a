"""``run`` on raw fast5s, with ``--force_kmer_event_alignment`` and with
``--embed`` in the port against the JAX package on the CPU: both CLIs'
``run --embed`` align two seeded synthetic reads, one basecalled fast5
and one raw fast5 (``write_synthetic_run``), each package on its own
copy of the files: the raw read is aligned from its signal, its
generated table written into its fast5, and each read's alignment goes
into its fast5 under /Analyses/SignalAlign_000: the full rows with their
raw coordinates, the MEA labels and the variantCaller rows
(``io.embed.embed_alignment``). Both CLIs'
``--force_kmer_event_alignment`` run on the reads' basecalled fast5s
that hold their raw signal too: the same generated tables and TSVs as
each other, and the port's TSV of the raw read is its raw run's byte
for byte.

Tolerances: the embedded posteriors are the full TSV's, so within
TOL_POST (``tests/test_torch_run_signal_align.py``'s); every other column
of the embedded tables, the raw coordinates and the MEA labels' choice of
events and positions are equal."""

import os
import shutil

import h5py
import numpy as np
import pytest

from signalalign_tpu import cli as jax_cli
from signalalign_tpu.io import embed as jax_embed
from signalalign_tpu.io import fast5 as jax_fast5
from signalalign_tpu_torch import cli as port_cli
from signalalign_tpu_torch.io import embed as port_embed
from signalalign_tpu_torch.io import fast5 as port_fast5
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_pore_model,
                                                   write_synthetic_run)
from test_torch_raw_signal import (FULL_POST_COLS, GENERATED, TOL_POST,
                                   VC_POST_COLS, _rows_close,
                                   jax_native_loaded)

SA = "Analyses/SignalAlign_000"
# float columns of the embedded full table that carry a posterior
POST_FIELDS = ("posterior_probability",)


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    """Both CLIs' `run --embed --output_format both` on their own copies
    of a basecalled fast5 (read 0) and a raw one (read 1): (labels, the
    basecall analysis each read's events come from, {package: (fast5
    dir, output dir)}, the files of basecalled fast5s that hold their raw
    signal too)."""
    jax_native_loaded()
    d = tmp_path_factory.mktemp("embed")
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=2, ev_min=300, ev_max=400, seed=7, genome_len=20_000,
        fasta_path=str(d / "genome.fa"))
    called = write_synthetic_run(rgs, str(d / "called"), fasta, model=model)
    raw = write_synthetic_run(rgs, str(d / "raw"), fasta, model=model,
                              raw=True)
    signal = write_synthetic_run(rgs, str(d / "signal"), fasta, model=model,
                                 signal=True)
    labels = [r.read_label for r, _ in rgs]
    dirs = {}
    for name in ("jax", "port"):
        f5 = d / f"fast5_{name}"
        f5.mkdir()
        for label, files in zip(labels, (called, raw)):
            shutil.copy(os.path.join(files["fast5_dir"], f"{label}.fast5"),
                        f5)
        out = str(d / f"out_{name}")
        args = ["run", "--alignment_file", called["sam"], "--readdb",
                called["readdb"], "--fast5_dir", str(f5), "--ref",
                called["fasta"], "--model", called["model"], "--output_dir",
                out, "--output_format", "both", "--embed"]
        if name == "jax":
            assert jax_cli.main(args) == 0
        else:
            assert port_cli.main(args + ["--device", "cpu"]) == 0
        dirs[name] = (str(f5), out)
    analyses = ["Analyses/Basecall_1D_000",
                "Analyses/SignalAlign_Basecall_1D_000"]
    return labels, analyses, dirs, signal


def _fast5(dirs, name, label):
    return os.path.join(dirs[name][0], f"{label}.fast5")


def _tables_match(a, b, post_fields=POST_FIELDS):
    assert a.dtype == b.dtype and len(a) == len(b) > 0
    for col in a.dtype.names:
        if col in post_fields:
            assert np.abs(a[col] - b[col]).max() <= TOL_POST, col
        else:
            assert np.array_equal(a[col], b[col]), col


def test_cli_run_embed_matches_jax(embedded):
    """Each fast5 gains SignalAlign_000 in both packages' copies: the full
    table (rows and raw coordinates), the MEA labels and the variantCaller
    table, and the attribute naming the basecall events it used (the
    basecaller's, or the table generated from the raw read's signal,
    equal column by column); the TSVs match the JAX CLI's too."""
    labels, analyses, dirs, _ = embedded
    for label, analysis in zip(labels, analyses):
        with h5py.File(_fast5(dirs, "port", label)) as p, \
                h5py.File(_fast5(dirs, "jax", label)) as j:
            assert sorted(p["Analyses"]) == sorted(j["Analyses"])
            assert sorted(p[SA]) == sorted(j[SA]) == [
                "MEA_alignment_labels", "full", "variantCaller"]
            assert dict(p[SA].attrs) == dict(j[SA].attrs) == {
                "basecall_events": np.bytes_(
                    f"{analysis}/BaseCalled_template/Events")}
            full = p[f"{SA}/full"][()]
            _tables_match(full, j[f"{SA}/full"][()])
            assert (full["raw_length"] > 0).all()
            mea = p[f"{SA}/MEA_alignment_labels"][()]
            _tables_match(mea, j[f"{SA}/MEA_alignment_labels"][()])
            assert np.all(np.diff(mea["raw_start"]) >= 0)
            vc = p[f"{SA}/variantCaller"][()]
            assert vc.dtype == j[f"{SA}/variantCaller"].dtype and len(vc) == 0
            events = f"{analysis}/BaseCalled_template/Events"
            _tables_match(p[events][()], j[events][()], ())
    out_j, out_p = dirs["jax"][1], dirs["port"][1]
    names = sorted(os.listdir(out_p))
    assert names == sorted(os.listdir(out_j))
    for name in names:
        _rows_close(os.path.join(out_j, name), os.path.join(out_p, name),
                    VC_POST_COLS if name.endswith(".vc.tsv")
                    else FULL_POST_COLS)


def test_embedded_labels_read_back_as_jax(embedded):
    """CreateLabels, read_signalalign_events and read_mea_labels on the
    port's files give what the JAX package's give on its own, also where
    both fail; add_basecall_alignment_prediction names the ROADMAP item
    it waits for (pipeline.validate)."""
    labels, _, dirs, _ = embedded
    for label in labels:
        pp, jp = _fast5(dirs, "port", label), _fast5(dirs, "jax", label)
        got, want = port_embed.CreateLabels(pp), jax_embed.CreateLabels(jp)
        assert got.read_id == want.read_id == label
        assert np.array_equal(got.raw_signal, want.raw_signal)
        _tables_match(got.add_signal_align_predictions(number=0),
                      want.add_signal_align_predictions(number=0))
        _tables_match(got.add_mea_labels(), want.add_mea_labels(),
                      ("posterior_probability",))
        assert sorted(got.labels) == sorted(want.labels)
        _tables_match(port_embed.read_signalalign_events(pp, number=0),
                      jax_embed.read_signalalign_events(jp, number=0))
        _tables_match(port_embed.read_mea_labels(pp),
                      jax_embed.read_mea_labels(jp),
                      ("posterior_probability",))
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6"):
            got.add_basecall_alignment_prediction(None, None)
    # without a number both packages take the newest analysis whose name
    # starts "SignalAlign_" and holds template events: for the raw read
    # that is its generated SignalAlign_Basecall_1D_000, which has no full
    # table, so both raise KeyError there
    raw = [(_fast5(dirs, "port", labels[1]), port_embed),
           (_fast5(dirs, "jax", labels[1]), jax_embed)]
    for path, module in raw:
        with pytest.raises(KeyError):
            module.read_signalalign_events(path)
    _tables_match(port_embed.read_signalalign_events(
        _fast5(dirs, "port", labels[0])), jax_embed.read_signalalign_events(
        _fast5(dirs, "jax", labels[0])))


def test_embed_helpers_match_jax(embedded):
    """event_raw_coords (raw-coordinate and time-scale tables),
    add_raw_fields and mea_labels_from_events on the same arrays in both
    packages, template and complement rows: equal."""
    labels, analyses, dirs, _ = embedded
    path = _fast5(dirs, "port", labels[0])
    with port_fast5.Fast5(path) as f5:
        events = f5.template_events(analyses[0])
    with h5py.File(path) as fh:
        full = fh[f"{SA}/full"][()]
    sa = np.zeros(len(full), dtype=port_embed.SA_FULL_DTYPE)
    for name in sa.dtype.names:
        sa[name] = full[name]
    sa["strand"][::3] = b"c"
    timed = np.zeros(len(events), dtype=[("start", "<f8"), ("length", "<f8")])
    timed["start"], timed["length"] = events["start"], events["length"]
    for table in (events, timed):
        for a, b in zip(port_embed.event_raw_coords(table, 4000.0, 3),
                        jax_embed.event_raw_coords(table, 4000.0, 3)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    got = port_embed.add_raw_fields(sa, events, timed)
    want = jax_embed.add_raw_fields(sa, events, timed)
    _tables_match(got, want, ())
    for strand in (b"t", b"c"):
        rows = got[got["strand"] == strand]
        _tables_match(port_embed.mea_labels_from_events(rows),
                      jax_embed.mea_labels_from_events(rows), ())
    assert len(port_embed.mea_labels_from_events(got[:0])) == 0


def test_remove_analyses_after_embed_matches_jax(embedded, tmp_path):
    """remove_analyses on copies of the embedded files: the SignalAlign
    groups (the alignment, and the raw read's generated table) go in both
    packages, the basecaller's stays."""
    labels, _, dirs, _ = embedded
    for label in labels:
        kept = []
        for name, module in (("port", port_fast5), ("jax", jax_fast5)):
            path = str(tmp_path / f"{name}_{label}.fast5")
            shutil.copyfile(_fast5(dirs, name, label), path)
            n = module.remove_analyses(path, "SignalAlign")
            with h5py.File(path) as fh:
                kept.append((n, sorted(fh["Analyses"])
                             if "Analyses" in fh else None))
        assert kept[0] == kept[1]
        assert kept[0][0] >= 1


def test_cli_run_on_raw_fast5s_matches_jax(embedded):
    """`run` on a raw-signal fast5 (read 1): both CLIs align it from its
    raw signal and write the same TSVs (posteriors within TOL_POST, every
    other column equal) and the same generated table, column by column,
    as the fast5's only basecall analysis."""
    labels, _, dirs, _ = embedded
    label = labels[1]
    with h5py.File(_fast5(dirs, "port", label)) as p:
        assert sorted(p["Analyses"]) == ["SignalAlign_000",
                                         "SignalAlign_Basecall_1D_000"]
        table = p[f"{GENERATED}/BaseCalled_template/Events"][()]
    with h5py.File(_fast5(dirs, "jax", label)) as j:
        _tables_match(table, j[f"{GENERATED}/BaseCalled_template/Events"][()],
                      ())
    n_rows = 0
    for kind, cols in (("forward", FULL_POST_COLS), ("vc", VC_POST_COLS)):
        name = f"{label}.sm.{kind}.tsv"
        n_rows += _rows_close(os.path.join(dirs["jax"][1], name),
                              os.path.join(dirs["port"][1], name), cols)
    assert n_rows > len(table) // 2


def test_cli_run_force_kmer_event_alignment_matches_jax(embedded, tmp_path):
    """`run --force_kmer_event_alignment` in both CLIs, each on its own
    copy of both reads' basecalled fast5s that hold their raw signal too:
    both align the raw signal, not the basecall table, and number the
    generated table SignalAlign_Basecall_1D_000 beside the basecaller's,
    equal column by column; the TSVs match (posteriors within TOL_POST,
    every other column equal), and the port's TSV of read 1 is its raw
    run's byte for byte."""
    labels, _, dirs, signal = embedded
    names = sorted(f"{label}.sm.forward.tsv" for label in labels)
    runs = {}
    for pkg, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        f5 = tmp_path / f"fast5_{pkg}"
        f5.mkdir()
        for label in labels:
            shutil.copy(os.path.join(signal["fast5_dir"], f"{label}.fast5"),
                        f5)
        out = tmp_path / f"out_{pkg}"
        args = ["run", "--alignment_file", signal["sam"], "--readdb",
                signal["readdb"], "--fast5_dir", str(f5), "--ref",
                signal["fasta"], "--model", signal["model"], "--output_dir",
                str(out), "--force_kmer_event_alignment"]
        assert main(args + (["--device", "cpu"] if pkg == "port" else [])
                    ) == 0
        assert sorted(os.listdir(out)) == names
        runs[pkg] = (f5, out)
    for label in labels:
        name = f"{label}.sm.forward.tsv"
        tables = []
        for f5, _ in runs.values():
            with h5py.File(f5 / f"{label}.fast5") as fh:
                assert sorted(fh["Analyses"]) == [
                    "Basecall_1D_000", "SignalAlign_Basecall_1D_000"]
                tables.append(
                    fh[f"{GENERATED}/BaseCalled_template/Events"][()])
        _tables_match(*tables, ())
        assert _rows_close(str(runs["jax"][1] / name),
                           str(runs["port"][1] / name),
                           FULL_POST_COLS) > len(tables[0]) // 2
    name = f"{labels[1]}.sm.forward.tsv"
    with open(runs["port"][1] / name) as a, \
            open(os.path.join(dirs["port"][1], name)) as b:
        assert a.read() == b.read()
