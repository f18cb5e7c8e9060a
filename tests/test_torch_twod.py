"""2D reads in the port against the JAX package on the CPU: seeded
synthetic 2D reads (``build_synthetic_2d_batch``: a template strand under
``synthetic_pore_model(0)`` and a complement strand drawn from the
reverse complement under ``synthetic_pore_model(1)``) written as 2D fast5s
(``write_synthetic_run(..., complements=)``: both strands' basecall tables
and Fastqs, the Basecall_2D alignment table).

The 2D reader, its table helpers and the guide aligner (the native
Smith-Waterman and minimizer index, the same source in both packages)
compare exactly; so does the JAX package's Python Smith-Waterman on a
query without gaps, where its linear gaps do not matter. The CLI's
``run --2d`` writes the JAX CLI's TSVs (posteriors within TOL_POST,
``tests/test_torch_run_signal_align.py``'s), and ``train --2d`` its
template and complement models (transitions within TOL_TRANS,
``tests/test_torch_train_cli.py``'s)."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from signalalign_tpu import cli as jax_cli
from signalalign_tpu.io import minialign as jax_minialign
from signalalign_tpu.io import read as jax_read
from signalalign_tpu.io import reference as jax_reference
from signalalign_tpu_torch import cli as port_cli
from signalalign_tpu_torch.io import minialign as port_minialign
from signalalign_tpu_torch.io import read as port_read
from signalalign_tpu_torch.io.output import write_full_tsv
from signalalign_tpu_torch.io.reference import ProcessedReference
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.pipeline.signal_align import align_read_2d
from signalalign_tpu_torch.utils.alphabet import reverse_complement
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_2d_batch,
                                                   build_synthetic_batch,
                                                   synthetic_pore_model,
                                                   twod_read,
                                                   write_synthetic_run)
from test_torch_raw_signal import (FULL_POST_COLS, VC_POST_COLS,
                                   _rows_close, _same_fields,
                                   jax_native_loaded)

CPU = torch.device("cpu")
TOL_TRANS = 1e-5
# the drawn window and the guide aligner's may differ at a read's ends,
# where its first or last bases are read errors
TOL_WINDOW = 10


@pytest.fixture(scope="module")
def twod_files(tmp_path_factory):
    """(reads, complement strands, written files, a fast5 directory of
    the two reads alone, complement model path)."""
    jax_native_loaded()
    d = tmp_path_factory.mktemp("twod")
    model = synthetic_pore_model(0)
    cmodel = synthetic_pore_model(1)
    rgs, comps, _, fasta = build_synthetic_2d_batch(
        model, cmodel, n_reads=2, ev_min=150, ev_max=200, seed=5,
        genome_len=20_000, fasta_path=str(d / "genome.fa"))
    files = write_synthetic_run(rgs, str(d / "in"), fasta, model=model,
                                complements=comps)
    reads = d / "reads"
    reads.mkdir()
    for read, _ in rgs:
        shutil.copy(os.path.join(files["fast5_dir"],
                                 f"{read.read_label}.fast5"), reads)
    cpath = str(d / "complement.model")
    cmodel.write(cpath)
    return rgs, comps, files, str(reads), cpath


def test_twod_reader_matches_jax_and_the_in_memory_twin(twod_files):
    """NanoporeRead2DData.from_fast5 on each 2D fast5 equals the JAX
    reader's, both strands field for field, and the in-memory twin
    (twod_read) equals it; the 2D sequence is the read (less a base of
    each homopolymer run longer than a k-mer), the complement's map is
    stored reversed."""
    rgs, comps, files, reads, _ = twod_files
    for (read, _), comp in zip(rgs, comps):
        path = os.path.join(reads, f"{read.read_label}.fast5")
        got = port_read.NanoporeRead2DData.from_fast5(path)
        want = jax_read.NanoporeRead2DData.from_fast5(path)
        assert (got.read_label, got.twod_sequence, got.kmer_length) == \
            (want.read_label, want.twod_sequence, want.kmer_length)
        for strand in ("template", "complement"):
            _same_fields(getattr(got, strand), getattr(want, strand))
        twin = twod_read(read, comp)
        for strand in ("template", "complement"):
            _same_fields(getattr(twin, strand), getattr(got, strand),
                         skip=("fast5_path",))
        # the 2D sequence is the read but for one base of each homopolymer
        # run longer than a k-mer: assemble_2d_sequence skips a k-mer equal
        # to the one before it (a stay, in a basecaller's table)
        k = read.kmer_length
        seq = read.template_read
        repeats = sum(seq[i:i + k] == seq[i + 1:i + 1 + k]
                      for i in range(len(seq) - k))
        assert len(got.twod_sequence) == len(seq) - repeats
        if not repeats:
            assert got.twod_sequence == seq
        assert got.complement.assign_read == comp.template_read
        assert np.all(np.diff(got.complement.event_map) >= 0)


@pytest.mark.parametrize("case", ["plain", "gaps", "off_table"])
def test_twod_table_helpers_match_jax(case):
    """assemble_2d_sequence and make_twod_event_maps on alignment tables
    with repeated k-mers, template and complement gaps (-1) and a k-mer
    that does not continue the sequence: the JAX helpers' results."""
    kmers = ["ACGTA", "CGTAC", "CGTAC", "GTACC", "TACCG", "ACCGT", "CCGTT"]
    t = np.array([0, 1, 2, 3, 5, 6, 8])
    c = np.array([9, 8, 8, 6, 5, 3, 1])
    if case == "gaps":
        t[[1, 4]] = -1
        c[[3]] = -1
    if case == "off_table":
        kmers[4] = "TTTTT"
    seq = port_read.assemble_2d_sequence(kmers)
    assert seq == jax_read.assemble_2d_sequence(kmers)
    got = port_read.make_twod_event_maps(t, c, kmers, seq, 5)
    want = jax_read.make_twod_event_maps(t, c, kmers, seq, 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(a) == len(seq)


def _guide_fields(g):
    return dataclasses.astuple(g)


def test_guide_alignment_sw_matches_jax(twod_files):
    """generate_guide_alignment on a contig below SEEDED_MIN_REF (full
    Smith-Waterman) for each 2D sequence and its reverse complement: the
    JAX package's guide, near the drawn window, on the right strand; and
    the native Smith-Waterman equals the JAX package's Python one on a
    query with substitutions only."""
    rgs, _, files, _, _ = twod_files
    ref = ProcessedReference(files["fasta"])
    jref = jax_reference.ProcessedReference(files["fasta"])
    assert len(ref.forward["synth"]) < port_minialign.SEEDED_MIN_REF
    for read, drawn in rgs:
        for seq, forward in ((read.template_read, True),
                             (reverse_complement(read.template_read), False)):
            got = port_minialign.generate_guide_alignment(seq, ref)
            want = jax_minialign.generate_guide_alignment(seq, jref)
            assert _guide_fields(got) == _guide_fields(want)
            assert got.forward == forward and got.validate(len(seq))
            assert abs(got.window_start - drawn.window_start) <= TOL_WINDOW
            assert abs(got.window_end - drawn.window_end) <= TOL_WINDOW
    genome = ref.forward["synth"][:1000]
    query = list(genome[400:560])
    for i in range(5, len(query), 23):
        query[i] = "A" if query[i] != "A" else "C"
    query = "".join(query)
    got = port_minialign._sw(query, genome)
    assert got == jax_minialign._sw(query, genome) == \
        jax_minialign._sw_py(query, genome)
    assert got[3:5] == (400, 560) and got[5] == [(160, "M")]


def test_guide_alignment_seeded_matches_jax(tmp_path):
    """generate_guide_alignment on a contig above SEEDED_MIN_REF (the
    minimizer index, chaining and banded extension) for two reads and
    their reverse complements: the JAX package's guide, near the drawn
    window; the index is built once per contig and kept on the reference
    object."""
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=2, ev_min=300, ev_max=400, seed=9,
        genome_len=150_000, fasta_path=str(tmp_path / "genome.fa"))
    ref = ProcessedReference(fasta)
    jref = jax_reference.ProcessedReference(fasta)
    assert len(ref.forward["synth"]) > port_minialign.SEEDED_MIN_REF
    for read, drawn in rgs:
        for seq in (read.template_read, reverse_complement(read.template_read)):
            got = port_minialign.generate_guide_alignment(seq, ref)
            want = jax_minialign.generate_guide_alignment(seq, jref)
            assert _guide_fields(got) == _guide_fields(want)
            assert got.validate(len(seq)) and got.mapq > 0
            assert abs(got.window_start - drawn.window_start) <= TOL_WINDOW
    assert list(ref.__dict__["_minidx_cache"]) == [("synth", 15, 10)]


def test_align_read_2d_matches_the_batch_runner(run_2d, twod_files,
                                                tmp_path):
    """align_read_2d on the first read gives both strands' rows of the
    port's `run --2d` (run_alignment_batch with the template and the
    complement model, the complement with strand_template=False): this
    read makes one segment a strand, where the two entry points agree."""
    rgs, _, files, reads, cpath = twod_files
    _, pdir = run_2d
    model = PoreModel.from_file(files["model"])
    cmodel = PoreModel.from_file(cpath)
    ref = ProcessedReference(files["fasta"])
    label = rgs[0][0].read_label
    read2d = port_read.NanoporeRead2DData.from_fast5(
        os.path.join(reads, f"{label}.fast5"))
    guide = port_minialign.generate_guide_alignment(read2d.twod_sequence, ref)
    t, c = align_read_2d(read2d, guide, ref, model, cmodel, device=CPU)
    assert t.strand_template and not c.strand_template
    assert c.forward == guide.forward
    path = str(tmp_path / "one.tsv")
    write_full_tsv(path, t.full_rows(model), append=False)
    write_full_tsv(path, c.full_rows(cmodel), append=True)
    with open(path) as a, open(os.path.join(
            pdir, f"{label}.sm.forward.tsv")) as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def run_2d(twod_files, tmp_path_factory):
    """Both CLIs' `run --2d --complement_model --output_format both
    --max_reads 1` (the first read): (JAX output dir, port output
    dir)."""
    _, _, files, reads, cpath = twod_files
    tmp = tmp_path_factory.mktemp("run2d")
    out = {}
    for name in ("jax", "port"):
        out[name] = str(tmp / name)
        args = ["run", "--2d", "--fast5_dir", reads, "--ref", files["fasta"],
                "--model", files["model"], "--complement_model", cpath,
                "--output_dir", out[name], "--output_format", "both",
                "--max_reads", "1"]
        if name == "jax":
            assert jax_cli.main(args) == 0
        else:
            assert port_cli.main(args + ["--device", "cpu"]) == 0
    return out["jax"], out["port"]


def test_cli_run_2d_matches_jax(run_2d, twod_files):
    """`run --2d`: one full file per read holding the template strand's
    rows, then the complement's, and a variantCaller file, as the JAX
    CLI writes them: every column but the posterior equal, posteriors
    within TOL_POST."""
    rgs, _, _, _, _ = twod_files
    jdir, pdir = run_2d
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) == sorted(
        f"{rgs[0][0].read_label}.sm.{s}.tsv" for s in ("forward", "vc"))
    for name in names:
        _rows_close(os.path.join(jdir, name), os.path.join(pdir, name),
                    VC_POST_COLS if name.endswith(".vc.tsv")
                    else FULL_POST_COLS)
        if name.endswith(".forward.tsv"):
            with open(os.path.join(pdir, name)) as fh:
                strands = [line.split("\t")[4] for line in fh]
            n_t = strands.count("t")
            assert n_t > 100 and strands == ["t"] * n_t + ["c"] * (
                len(strands) - n_t) and len(strands) - n_t > 100


def _train_config(tmp, files, reads, cpath, **training):
    path = tmp / f"train_{len(list(tmp.iterdir()))}.json"
    cfg = {"samples": [{"alignment_file": files["sam"],
                        "readdb": files["readdb"], "fast5_dirs": [reads]}],
           "reference": files["fasta"],
           "template_hmm_model": files["model"],
           "complement_hmm_model": cpath,
           "training": dict({"transitions": True, "em_iterations": 1},
                            **training)}
    path.write_text(json.dumps(cfg))
    return str(path)


def _train(cli, config, out, *extra):
    args = ["train", "--config", config, "--output_dir", out,
            "--max_reads", "1", *extra]
    if cli is port_cli:
        args += ["--device", "cpu"]
    assert cli.main(args) == 0
    return sorted(os.listdir(out))


@pytest.fixture(scope="module")
def train_2d(twod_files, tmp_path_factory):
    """Both CLIs' `train --2d` with the template's transitions off (its
    EM is held in ``tests/test_torch_train_cli.py``) and `--max_reads 1`:
    one iteration of transitions EM over the first 2D fast5's complement
    strand, mapped by its 2D sequence: ({package: output dir}, a scratch
    dir)."""
    _, _, files, reads, cpath = twod_files
    tmp = tmp_path_factory.mktemp("train2d")
    config = _train_config(tmp, files, reads, cpath, transitions=False)
    out = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out[name] = str(tmp / name)
        _train(cli, config, out[name], "--2d")
    return out, tmp


def _transitions(path):
    return PoreModel.from_file(path).transitions


@pytest.mark.parametrize("option", ["complement_model", "2d",
                                    "training_complement"])
def test_train_complement_options(train_2d, twod_files, option):
    """The three ways of asking `train` for the complement strand, as the
    JAX CLI reads them (the template's transitions off): `--2d` with a
    complement model trains it (its checkpoint, expectations file and
    complement_trained.model, its transitions within TOL_TRANS of the
    JAX CLI's); `--complement_model` alone trains no complement, in both
    CLIs; `training.complement` in the config trains the complement as
    `--2d` does (the port's complement model equals its `--2d` one)."""
    out, tmp = train_2d
    _, _, files, reads, cpath = twod_files
    comp_files = ["complement_trained.model", "complement_trained_0.model",
                  "complement_trained_0.template.expectations.tsv"]
    if option == "2d":
        names = sorted(os.listdir(out["port"]))
        assert names == sorted(os.listdir(out["jax"]))
        assert names == sorted(comp_files + ["template_trained.model"])
        got = _transitions(os.path.join(out["port"], comp_files[0]))
        want = _transitions(os.path.join(out["jax"], comp_files[0]))
        np.testing.assert_allclose(got, want, atol=TOL_TRANS, rtol=0)
        assert not np.allclose(
            _transitions(os.path.join(out["port"], "complement_trained.model")),
            _transitions(cpath))
    elif option == "complement_model":
        config = _train_config(tmp, files, reads, cpath, transitions=False)
        for cli, name in ((port_cli, "port_cm"), (jax_cli, "jax_cm")):
            assert _train(cli, config, str(tmp / name), "--complement_model",
                          cpath) == ["template_trained.model"]
    else:
        config = _train_config(tmp, files, reads, cpath, transitions=False,
                               complement=True)
        names = _train(port_cli, config, str(tmp / "port_tc"))
        assert names == sorted(comp_files + ["template_trained.model"])
        with open(tmp / "port_tc" / "complement_trained.model") as a, \
                open(os.path.join(out["port"],
                                  "complement_trained.model")) as b:
            assert a.read() == b.read()
