"""Reads from raw signal in the port against the JAX package on the CPU:
seeded synthetic reads written as raw-signal fast5s (``write_synthetic_run
(..., raw=True)``: ADC samples at each event's level, no Analyses group)
and as basecalled fast5s that also hold their raw signal (``signal=True``).

Both packages run the same numpy formulas and the same native library
(the port's ``csrc/signalalign_native.cpp`` is a byte-for-byte copy of
the JAX package's), so event detection, the peak detector, the adaptive
banded alignment and its QC, the scaling and the generated event tables
compare exactly; so do the JAX package's Python peak scan and adaptive
alignment, its fallbacks, as a second oracle. Each package runs on its
own copy of the fast5s, since aligning a raw read writes its generated
event table into the file. The CLI's ``run`` on raw fast5s and with
``--force_kmer_event_alignment`` is held in ``tests/test_torch_embed.py``,
beside ``--embed``, from one run of each CLI."""

import dataclasses
import os
import shutil
import time

import h5py
import numpy as np
import pytest

from signalalign_tpu.io import fast5 as jax_fast5
from signalalign_tpu.io import read as jax_read
from signalalign_tpu.io import reference as jax_reference
from signalalign_tpu.io import sam as jax_sam
from signalalign_tpu.models.pore_model import PoreModel as JaxPoreModel
from signalalign_tpu.ops import event_detect as jax_detect
from signalalign_tpu.ops import scaling as jax_scaling
from signalalign_tpu.pipeline import event_align as jax_align
from signalalign_tpu.pipeline import mea as jax_mea
from signalalign_tpu.utils import native as jax_native
from signalalign_tpu_torch import cli as port_cli
from signalalign_tpu_torch.io import fast5 as port_fast5
from signalalign_tpu_torch.io import read as port_read
from signalalign_tpu_torch.io import reference as port_reference
from signalalign_tpu_torch.io import sam as port_sam
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.ops import event_detect as port_detect
from signalalign_tpu_torch.ops import scaling as port_scaling
from signalalign_tpu_torch.pipeline import event_align as port_align
from signalalign_tpu_torch.pipeline import mea as port_mea
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   raw_signal_read,
                                                   synthetic_complement,
                                                   synthetic_pore_model,
                                                   write_synthetic_run)

THR = 0.01
TOL_POST = 1e-3
FULL_POST_COLS = (12,)
VC_POST_COLS = (3, 7)
GENERATED = "Analyses/SignalAlign_Basecall_1D_000"
# raw samples' scatter in their event's stdv (``synthetic.raw_adc``)
NOISE = 1.0


def jax_native_loaded():
    """The JAX package's native library, loaded. It builds in place
    (build/libsignalalign_native.so) at first use, so another test
    process's build may be under way; a failed load leaves the JAX package
    on its Python fallbacks, so wait for that build and load again."""
    for _ in range(60):
        if jax_native.available():
            return
        jax_native._tried = False
        time.sleep(1)
    pytest.fail("the JAX package's native library did not load")


@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    """(reads, raw fast5 files, basecalled fast5 files with raw signal):
    3 reads of 300-400 events."""
    jax_native_loaded()
    d = tmp_path_factory.mktemp("raw")
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=3, ev_min=300, ev_max=400, seed=5, genome_len=20_000,
        fasta_path=str(d / "genome.fa"))
    raw = write_synthetic_run(rgs, str(d / "raw"), fasta, model=model,
                              raw=True)
    signal = write_synthetic_run(rgs, str(d / "signal"), fasta, model=model,
                                 signal=True)
    return rgs, raw, signal


def _path(files, read):
    return os.path.join(files["fast5_dir"], f"{read.read_label}.fast5")


def _copy(files, tmp, name, labels=None):
    """A copy of the fast5 directory for one package (``labels``: only
    those reads)."""
    out = os.path.join(tmp, name)
    os.makedirs(out)
    for f in sorted(os.listdir(files["fast5_dir"])):
        if labels is None or f[:-len(".fast5")] in labels:
            shutil.copy(os.path.join(files["fast5_dir"], f), out)
    return out


def _raw_of(path, fast5_module):
    with fast5_module.Fast5(path) as f5:
        return f5.raw_signal_pA(), f5.channel_params(), f5.start_time()


def _same_fields(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "params":
            assert vars(va) == vars(vb)
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def _rows_close(jpath, ppath, post_cols):
    """Every column but ``post_cols`` identical, row for row; those within
    TOL_POST. Rows of one file only are threshold-edge cells (the
    comparison of ``tests/test_torch_run_signal_align.py``). The CLI
    tests of ``test_torch_embed.py`` and ``test_torch_twod.py`` use it."""
    def key(cols):
        return tuple(c for i, c in enumerate(cols) if i not in post_cols)
    want = {key(r): r for r in _rows(jpath)}
    got = {key(r): r for r in _rows(ppath)}
    for k in set(want) ^ set(got):
        r = want.get(k, got.get(k))
        assert abs(float(r[post_cols[0]]) - THR) <= TOL_POST, r
    common = [k for k in want if k in got]
    assert common == [k for k in got if k in want]
    for k in common:
        for c in post_cols:
            assert abs(float(want[k][c]) - float(got[k][c])) <= TOL_POST, k
    return len(common)


# ------------------------------------------------------------ detection

def test_raw_fast5s_hold_the_in_memory_signal(raw_files):
    """Each raw fast5 has no Analyses group; both packages' readers give
    the in-memory twin's current, channel parameters and start time, and
    NanoporeReadData.from_fast5 finds no basecall events in either."""
    rgs, raw, _ = raw_files
    for i, (read, _) in enumerate(rgs):
        path = _path(raw, read)
        with h5py.File(path) as fh:
            assert "Analyses" not in fh
        pa, cp, start = raw_signal_read(read, i)
        for module in (port_fast5, jax_fast5):
            got = _raw_of(path, module)
            assert got[0].dtype == np.float32
            assert np.array_equal(got[0], pa) and got[1:] == (cp, start)
        for module in (port_read, jax_read):
            with pytest.raises(ValueError, match="no basecall events"):
                module.NanoporeReadData.from_fast5(path)


@pytest.mark.parametrize("rna", [False, True], ids=["dna", "rna"])
def test_event_detection_matches_jax(raw_files, rna):
    """trim_and_segment_raw, both t-statistic tracks, the peak detector
    (the port's native call against the JAX package's and against its
    Python scan) and detect_events, with the DNA and the RNA parameters:
    exact. On the DNA parameters the detector finds each read's events
    within 20%."""
    rgs, raw, _ = raw_files
    params = port_detect.RNA_PARAMS if rna else port_detect.DNA_PARAMS
    assert params == (jax_detect.RNA_PARAMS if rna else jax_detect.DNA_PARAMS)
    w1, w2 = params["window_length1"], params["window_length2"]
    for read, _ in rgs:
        pa, _, _ = _raw_of(_path(raw, read), port_fast5)
        tr, off = port_detect.trim_and_segment_raw(pa, 200, 10, 100, 0.0)
        jtr, joff = jax_detect.trim_and_segment_raw(pa, 200, 10, 100, 0.0)
        assert off == joff == 200 and np.array_equal(tr, jtr)
        t1 = port_detect.compute_tstat(tr, w1)
        t2 = port_detect.compute_tstat(tr, w2)
        assert np.array_equal(t1, jax_detect.compute_tstat(tr, w1))
        assert np.array_equal(t2, jax_detect.compute_tstat(tr, w2))
        args = (w1, w2, params["threshold1"], params["threshold2"],
                params["peak_height"])
        peaks = port_detect._peak_detector(t1, t2, *args)
        assert np.array_equal(peaks, jax_detect._peak_detector(t1, t2, *args))
        assert np.array_equal(peaks,
                              jax_detect._peak_detector_py(t1, t2, *args))
        et = port_detect.detect_events(tr, rna=rna, start_sample=off)
        assert np.array_equal(
            et, jax_detect.detect_events(tr, rna=rna, start_sample=off))
        if not rna:
            assert abs(len(et) - read.n_events) <= 0.2 * read.n_events


def test_adaptive_alignment_matches_jax_and_its_python_scan(raw_files):
    """read_kmer_ids, estimate_scalings_using_mom, the adaptive banded
    alignment's pairs and QC (the port's native call, the JAX package's and
    its Python scan) and qc_passes: exact; every read passes QC."""
    rgs, raw, _ = raw_files
    model = PoreModel.from_file(raw["model"])
    jmodel = JaxPoreModel.from_file(raw["model"])
    for read, _ in rgs:
        pa, _, _ = _raw_of(_path(raw, read), port_fast5)
        tr, off = port_detect.trim_and_segment_raw(pa, 200, 10, 100, 0.0)
        means = port_detect.detect_events(tr, start_sample=off)[:, 0]
        for rna in (False, True):
            ids = port_align.read_kmer_ids(read.template_read, model, rna)
            assert np.array_equal(
                ids, jax_align.read_kmer_ids(read.template_read, jmodel, rna))
        params = port_scaling.estimate_scalings_using_mom(ids, model, means)
        jparams = jax_scaling.estimate_scalings_using_mom(ids, jmodel, means)
        assert vars(params) == vars(jparams)
        ids = port_align.read_kmer_ids(read.template_read, model, False)
        params = port_scaling.estimate_scalings_using_mom(ids, model, means)
        got = port_align.adaptive_event_align(means, ids, model, params)
        want = jax_align.adaptive_event_align(means, ids, jmodel, params)
        py = jax_align._adaptive_align_py(
            means, *jax_align._emission_params(ids, jmodel, params))
        for a, b, c in zip(got, want, py):
            assert np.array_equal(a, b) and np.array_equal(a, c)
        assert port_align.qc_passes(got[2]) == jax_align.qc_passes(got[2])
        assert port_align.qc_passes(got[2])[0], port_align.qc_passes(got[2])
    bad = np.array([-6.0, 0.0, 51.0, 5.5])
    assert port_align.qc_passes(bad) == jax_align.qc_passes(bad)
    assert not port_align.qc_passes(bad)[0]


@pytest.mark.parametrize("rna", [False, True], ids=["dna", "rna"])
def test_align_raw_read_matches_jax(raw_files, tmp_path, rna):
    """align_raw_read on each raw fast5 (for RNA a copy whose context tags
    say RNA: events and map reversed) equals the JAX package's field for
    field, and align_raw_signal on the in-memory twin equals it."""
    rgs, raw, _ = raw_files
    model = PoreModel.from_file(raw["model"])
    jmodel = JaxPoreModel.from_file(raw["model"])
    for i, (read, _) in enumerate(rgs):
        path = _path(raw, read)
        if rna:
            path = str(tmp_path / f"{read.read_label}.fast5")
            shutil.copyfile(_path(raw, read), path)
            with h5py.File(path, "r+") as fh:
                fh["UniqueGlobalKey/context_tags"].attrs[
                    "experiment_type"] = np.bytes_("rna")
        got = port_align.align_raw_read(path, model, read.template_read, rna)
        want = jax_align.align_raw_read(path, jmodel, read.template_read, rna)
        _same_fields(got, want)
        if not rna:
            assert got.qc_ok
            twin = port_align.align_raw_signal(
                *raw_signal_read(read, i), model, read.template_read)
            _same_fields(twin, got)


def test_noisy_raw_signal_matches_jax(tmp_path):
    """Raw fast5s whose samples scatter by their event's stdv (``noise``
    1.0, what a real event's stdv says): the in-memory twin reads as the
    file; trimming, both t-statistic tracks, the peak detector (the
    port's native call, the JAX package's and its Python scan) and
    detect_events exact; align_raw_read equals the JAX package's field for
    field, its adaptive alignment the JAX Python scan's, and every read
    passes QC. The detector splits these events: it finds more than the
    drawn count, as the JAX package's does on the same signal."""
    jax_native_loaded()
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=2, ev_min=300, ev_max=400, seed=6, genome_len=20_000,
        fasta_path=str(tmp_path / "genome.fa"))
    files = write_synthetic_run(rgs, str(tmp_path / "noisy"), fasta,
                                model=model, raw=True, noise=NOISE)
    jmodel = JaxPoreModel.from_file(files["model"])
    params = port_detect.DNA_PARAMS
    w1, w2 = params["window_length1"], params["window_length2"]
    args = (w1, w2, params["threshold1"], params["threshold2"],
            params["peak_height"])
    for i, (read, _) in enumerate(rgs):
        path = _path(files, read)
        pa, cp, start = _raw_of(path, port_fast5)
        twin = raw_signal_read(read, i, noise=NOISE)
        assert np.array_equal(pa, twin[0]) and (cp, start) == twin[1:]
        assert not np.array_equal(pa, raw_signal_read(read, i)[0])
        tr, off = port_detect.trim_and_segment_raw(pa, 200, 10, 100, 0.0)
        jtr, joff = jax_detect.trim_and_segment_raw(pa, 200, 10, 100, 0.0)
        assert off == joff and np.array_equal(tr, jtr)
        t1 = port_detect.compute_tstat(tr, w1)
        t2 = port_detect.compute_tstat(tr, w2)
        assert np.array_equal(t1, jax_detect.compute_tstat(tr, w1))
        assert np.array_equal(t2, jax_detect.compute_tstat(tr, w2))
        peaks = port_detect._peak_detector(t1, t2, *args)
        assert np.array_equal(peaks, jax_detect._peak_detector(t1, t2, *args))
        assert np.array_equal(peaks,
                              jax_detect._peak_detector_py(t1, t2, *args))
        et = port_detect.detect_events(tr, start_sample=off)
        assert np.array_equal(et, jax_detect.detect_events(
            tr, start_sample=off))
        assert len(et) > read.n_events
        got = port_align.align_raw_read(path, model, read.template_read)
        want = jax_align.align_raw_read(path, jmodel, read.template_read)
        _same_fields(got, want)
        assert got.qc_ok, got.qc_msg
        _same_fields(port_align.align_raw_signal(
            *twin, model, read.template_read), got)
        ids = port_align.read_kmer_ids(read.template_read, model, False)
        py = jax_align._adaptive_align_py(
            et[:, 0], *jax_align._emission_params(ids, jmodel, got.params))
        for a, b in zip(port_align.adaptive_event_align(
                et[:, 0], ids, model, got.params), py):
            assert np.array_equal(a, b)


def test_nanopore_read_from_raw_matches_jax(raw_files, tmp_path):
    """nanopore_read_from_raw on each package's copy of the raw fast5s:
    the reads equal field for field, each file gains the same generated
    table (SignalAlign_Basecall_1D_000, every column and the Fastq equal),
    and a second call numbers its analysis 001 in both."""
    rgs, raw, _ = raw_files
    model = PoreModel.from_file(raw["model"])
    jmodel = JaxPoreModel.from_file(raw["model"])
    records = {r.qname: r for r in port_sam.read_sam(raw["sam"])[1]}
    jrecords = {r.qname: r for r in jax_sam.read_sam(raw["sam"])[1]}
    pdir = _copy(raw, tmp_path, "port")
    jdir = _copy(raw, tmp_path, "jax")
    for read, _ in rgs:
        name = f"{read.read_label}.fast5"
        pp, jp = os.path.join(pdir, name), os.path.join(jdir, name)
        got = port_align.nanopore_read_from_raw(
            pp, model, records[read.read_label])
        want = jax_align.nanopore_read_from_raw(
            jp, jmodel, jrecords[read.read_label])
        _same_fields(got, want, skip=("fast5_path",))
        assert got.analysis_path == GENERATED
        assert got.template_read == read.template_read
        with h5py.File(pp) as a, h5py.File(jp) as b:
            ta = a[f"{GENERATED}/BaseCalled_template/Events"][()]
            tb = b[f"{GENERATED}/BaseCalled_template/Events"][()]
            assert ta.dtype == tb.dtype
            for col in ta.dtype.names:
                assert np.array_equal(ta[col], tb[col]), col
            fq = f"{GENERATED}/BaseCalled_template/Fastq"
            assert a[fq][()] == b[fq][()]
            assert dict(a[GENERATED].attrs) == dict(b[GENERATED].attrs)
        again = port_align.nanopore_read_from_raw(
            pp, model, records[read.read_label])
        assert again.analysis_path == \
            jax_align.nanopore_read_from_raw(
                jp, jmodel, jrecords[read.read_label]).analysis_path \
            == "Analyses/SignalAlign_Basecall_1D_001"


def test_raw_alignment_failing_qc_raises_as_jax(raw_files, tmp_path):
    """Under a pore model the signal was not drawn from, the raw alignment
    fails QC: both packages raise ValueError with the same message and
    write nothing into the fast5."""
    rgs, raw, _ = raw_files
    wrong = synthetic_pore_model(3)
    path = str(tmp_path / "wrong.model")
    wrong.write(path)
    rec = next(iter(port_sam.read_sam(raw["sam"])[1]))
    jrec = next(iter(jax_sam.read_sam(raw["sam"])[1]))
    read = rgs[0][0]
    msgs = []
    for name, module, model, r in (
            ("port", port_align, PoreModel.from_file(path), rec),
            ("jax", jax_align, JaxPoreModel.from_file(path), jrec)):
        f5 = str(tmp_path / f"{name}.fast5")
        shutil.copyfile(_path(raw, read), f5)
        with pytest.raises(ValueError, match="QC failed") as exc:
            module.nanopore_read_from_raw(f5, model, r)
        msgs.append(str(exc.value).replace(f5, "F"))
        with h5py.File(f5) as fh:
            assert "Analyses" not in fh
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("entry", ["run", "train", "run_2d"])
def test_a_failed_native_build_raises_through_the_read_skip(
        raw_files, tmp_path, monkeypatch, entry):
    """Where the native library cannot be built or loaded, `run` on raw
    fast5s, and `train --2d` and `run --2d` on 2D fast5s (whose guides
    the native aligner makes) raise NativeLibraryError: the fault is the
    host's, so the per-read skip passes it on rather than skip every
    read, and nothing is written."""
    from signalalign_tpu_torch.utils import native

    def broken():
        raise native.NativeLibraryError("building the library failed")
    monkeypatch.setattr(native, "load", broken)
    _, raw, _ = raw_files
    out = tmp_path / "out"
    f5 = _copy(raw, str(tmp_path), "fast5")
    common = ["--fast5_dir", f5, "--ref", raw["fasta"], "--model",
              raw["model"], "--output_dir", str(out), "--device", "cpu"]
    args = {"run": ["run", "--alignment_file", raw["sam"], "--readdb",
                    raw["readdb"], *common],
            "train": ["train", "--2d", "--complement_model", raw["model"],
                      "--iterations", "1", *common],
            "run_2d": ["run", "--2d", "--complement_model", raw["model"],
                       *common]}[entry]
    if entry != "run":          # the guide aligner needs the library
        rgs = raw_files[0][:1]
        comp = synthetic_complement(np.random.default_rng(0), rgs[0][0],
                                    synthetic_pore_model(1))
        twod = write_synthetic_run(rgs, str(tmp_path / "twod"), raw["fasta"],
                                   complements=[comp])
        args[args.index("--fast5_dir") + 1] = twod["fast5_dir"]
        if entry == "train":
            args += ["--alignment_file", twod["sam"], "--readdb",
                     twod["readdb"]]
    with pytest.raises(native.NativeLibraryError, match="building"):
        port_cli.main(args)
    assert not out.exists()


# ----------------------------------------------- readers and writers

def test_fast5_writers_match_jax(raw_files, tmp_path):
    """write_event_table numbers analyses from what a file holds
    (next_analysis_path), start_time reads the read group's attribute, and
    remove_analyses deletes by name, as in the JAX package."""
    rgs, _, signal = raw_files
    src = _path(signal, rgs[0][0])
    table = np.zeros(3, dtype=port_fast5.BASECALL_EVENT_COLUMNS)
    table["mean"] = [80.0, 90.0, 100.0]
    layouts = []
    for name, module in (("port", port_fast5), ("jax", jax_fast5)):
        path = str(tmp_path / f"{name}.fast5")
        shutil.copyfile(src, path)
        with module.Fast5(path, "r+") as f5:
            paths = [f5.write_event_table(table, "@r\nACGT\n+\n!!!!\n")
                     for _ in range(2)]
            paths.append(f5.next_analysis_path("Basecall_1D"))
            paths.append(f5.start_time())
        removed = module.remove_analyses(path, "SignalAlign")
        with h5py.File(path) as fh:
            names = sorted(fh["Analyses"])
        layouts.append((paths, removed, names, module.remove_analyses(path),
                        module.remove_analyses(path)))
        with h5py.File(path) as fh:
            assert "Analyses" not in fh
    assert layouts[0] == layouts[1]
    assert layouts[0][0][:3] == ["Analyses/SignalAlign_Basecall_1D_000",
                                 "Analyses/SignalAlign_Basecall_1D_001",
                                 "Analyses/Basecall_1D_001"]
    assert layouts[0][0][3] == 4000.0 and layouts[0][1] == 2


def test_make_event_map_not_strict_matches_jax():
    """make_event_map(strict=False) pads a short map with its last event
    and cuts a long one, as the JAX package's; strict raises in both."""
    moves = np.array([0, 1, 1, 0, 2, 1])
    pms = np.array([1.0, 1.0, 0.5, 0.9, 1.0, 1.0])
    for n_bases in (6, 9, 11, 14):
        for strict in (True, False):
            try:
                want = jax_read.make_event_map(moves, pms, n_bases, 3,
                                               strict=strict)
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)):
                    port_read.make_event_map(moves, pms, n_bases, 3,
                                             strict=strict)
                continue
            got = port_read.make_event_map(moves, pms, n_bases, 3,
                                           strict=strict)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert len(got) == n_bases


def test_positions_edit_mismatch_raises_as_jax(tmp_path):
    """A positions row whose base does not match the sequence raises in
    both packages with the same message; the rows that match edit both
    strands as the JAX package does."""
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">c\nACGTACGTCGAT\n")
    bad = tmp_path / "bad.tsv"
    bad.write_text("c\t1\t+\tC\tY\nc\t2\t+\tC\tY\nc\t5\t-\tC\tY\n")
    with pytest.raises(ValueError) as want:
        jax_reference.ProcessedReference(
            str(fasta),
            positions=jax_reference.AmbiguityPositions.from_file(str(bad)))
    with pytest.raises(ValueError, match=str(want.value)):
        port_reference.ProcessedReference(
            str(fasta),
            positions=port_reference.AmbiguityPositions.from_file(str(bad)))
    good = tmp_path / "good.tsv"
    good.write_text("c\t1\t+\tC\tY\nc\t2\t-\tC\tY\n")
    a = port_reference.ProcessedReference(
        str(fasta),
        positions=port_reference.AmbiguityPositions.from_file(str(good)))
    b = jax_reference.ProcessedReference(
        str(fasta),
        positions=jax_reference.AmbiguityPositions.from_file(str(good)))
    assert a.forward == b.forward and a.backward == b.backward
    assert a.forward["c"][1] == "Y" and a.backward["c"][2] == "Y"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mea_align_matches_its_slow_spec_and_jax(seed):
    """mea_align on seeded pair sets (repeated events and reference
    positions, ties): its path's posterior sum equals mea_slow_spec's
    maximum, and the path equals the JAX package's."""
    rng = np.random.default_rng(seed)
    n = 60
    pairs = [(int(r), int(e), float(p)) for r, e, p in zip(
        rng.integers(0, 25, n), rng.integers(0, 30, n),
        np.round(rng.random(n), 2))]
    path = port_mea.mea_align(pairs)
    assert path == jax_mea.mea_align(pairs)
    assert abs(sum(p for _, _, p in path)
               - port_mea.mea_slow_spec(pairs)) < 1e-9
    assert port_mea.mea_slow_spec(pairs) == jax_mea.mea_slow_spec(pairs)
    refs = [r for r, _, _ in path]
    events = [e for _, e, _ in path]
    assert events == sorted(events) and refs == sorted(refs)
    assert port_mea.mea_align([]) == []
