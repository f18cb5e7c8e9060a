"""The port's main path from files against the JAX package's on the CPU:
seeded synthetic reads written as fast5 files, a readdb, a SAM file (and
a BAM encoded here), the FASTA, a positions file and the pore model
(``utils.synthetic.write_synthetic_run``), read by both packages' SAM/BAM
readers, ``filter_reads``, ``NanoporeReadData.from_fast5`` and
``guide_from_sam_record``, then run through both CLIs' ``run``: pair
output (``both``), and site calling over the positions file's CpG
edition (``variants``). Several GPUs (``--distributed``) are not ported
yet and raise; raw-signal reads, ``--embed`` and 2D reads are held in
``tests/test_torch_raw_signal.py``, ``test_torch_embed.py`` and
``test_torch_twod.py``."""

import dataclasses
import gzip
import json
import os
import shutil
import struct

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from signalalign_tpu import cli as jax_cli
from signalalign_tpu.io import fast5 as jax_fast5
from signalalign_tpu.io import guide as jax_guide
from signalalign_tpu.io import read as jax_read
from signalalign_tpu.io import reference as jax_reference
from signalalign_tpu.io import sam as jax_sam
from signalalign_tpu.utils import alphabet as jax_alphabet
from signalalign_tpu_torch import cli as port_cli
from signalalign_tpu_torch.io import fast5 as port_fast5
from signalalign_tpu_torch.io import guide as port_guide
from signalalign_tpu_torch.io import read as port_read
from signalalign_tpu_torch.io import reference as port_reference
from signalalign_tpu_torch.io import sam as port_sam
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.pipeline.runner import run_signal_align
from signalalign_tpu_torch.utils import alphabet as port_alphabet
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_pore_model,
                                                   write_synthetic_run)

CPU = torch.device("cpu")
THR = 0.01
# posteriors: two f32 implementations at ~2^10-nat log terms (see
# tests/test_torch_runner.py); variants probabilities are marginals of
# such posteriors summed over a site's cells (tests/test_torch_site_calling.py)
TOL_POST = 1e-3
TOL_VARIANTS = 1e-2
# the posterior column of the full TSV, and those of the variantCaller TSV
# (the pair's posterior and the read's posterior score)
FULL_POST_COLS = (12,)
VC_POST_COLS = (3, 7)
MOTIFS = [("CG", "YG")]
# reads of the site-calling run: the JAX runner compiles its site-mode
# sweeps once per shape bucket and runs them in XLA on the CPU (~9 s for
# one read alone, ~21 s for four, several times that beside tier-1's
# other workers), so that run takes the first of the four reads
VARIANT_READS = 1
# the read written as a reverse-mapped record, and its soft clip
REVERSE_READ = 3
CLIP = 3


def _reverse_mapped(guide, contig_len):
    """``guide`` on the reverse strand of its contig's reverse complement
    (``<contig>_rc``), with the read's first CLIP bases soft-clipped: the
    reverse-mapped window's reverse complement is the forward window less
    CLIP bases, so the read aligns as well as it did forward."""
    (n, op), *rest = guide.ops
    assert op == "M" and n > CLIP
    return dataclasses.replace(
        guide, contig=guide.contig + "_rc", forward=False,
        window_start=contig_len - guide.window_end,
        window_end=contig_len - guide.window_start - CLIP,
        query_start=CLIP, ops=[(n - CLIP, "M"), *rest])


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """(in-memory reads, written files): 4 reads of test_torch_runner.py's
    batch, the last one mapped to the reverse strand of the genome's
    reverse complement (a contig of its own) with a soft clip, and the
    files write_synthetic_run makes of them."""
    d = tmp_path_factory.mktemp("run")
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=4, ev_min=300, ev_max=900, seed=5, genome_len=20_000,
        fasta_path=str(d / "genome.fa"))
    (name, seq), = port_reference.iter_fasta(fasta)
    with open(fasta, "a") as fh:
        fh.write(f">{name}_rc\n{port_alphabet.reverse_complement(seq)}\n")
    read, guide = rgs[REVERSE_READ]
    rgs[REVERSE_READ] = (read, _reverse_mapped(guide, len(seq)))
    return rgs, write_synthetic_run(rgs, str(d / "inputs"), fasta,
                                    model=model, motifs=MOTIFS)


def _cli_args(files, out_dir, *extra):
    return ["run", "--alignment_file", files["sam"], "--readdb",
            files["readdb"], "--fast5_dir", files["fast5_dir"], "--ref",
            files["fasta"], "--model", files["model"], "--output_dir",
            out_dir, *extra]


def _config_args(files, out_dir, tmp, *extra):
    """The same run through a --config JSON (the reference's sample
    keys) with the positions file among them."""
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as fh:
        json.dump({"samples": [{"alignment_file": files["sam"],
                                "readdb": files["readdb"],
                                "fast5_dirs": [files["fast5_dir"]],
                                "positions_file": files["positions"]}],
                   "reference": files["fasta"],
                   "template_hmm_model": files["model"],
                   "output_dir": out_dir}, fh)
    return ["run", "--config", path, *extra]


def _both_clis(tmp, make_args):
    """Each package's CLI run on the same files: the JAX one with its
    defaults on the CPU, the port's with --device cpu; their output
    directories."""
    jdir, pdir = os.path.join(tmp, "jax"), os.path.join(tmp, "port")
    assert jax_cli.main(make_args(jdir)) == 0
    assert port_cli.main(make_args(pdir) + ["--device", "cpu"]) == 0
    return jdir, pdir


@pytest.fixture(scope="module")
def both_outputs(run_files, tmp_path_factory):
    _, files = run_files
    tmp = str(tmp_path_factory.mktemp("both"))
    return _both_clis(tmp, lambda out: _cli_args(
        files, out, "--output_format", "both"))


@pytest.fixture(scope="module")
def variants_outputs(run_files, tmp_path_factory):
    _, files = run_files
    tmp = str(tmp_path_factory.mktemp("variants"))
    return _both_clis(tmp, lambda out: _config_args(
        files, out, tmp, "--output_format", "variants", "--variants", "CT",
        "--max_reads", str(VARIANT_READS)))


# ------------------------------------------------------------------ readers

def _same_record(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


# hand-made records besides the written ones: a reverse-mapped read with
# clips on both ends, and a forward one with a hard clip and a deletion
_EXTRA_SAM = [
    "rev1\t16\tsynth\t101\t37\t3S10M2I5M1D6M4S\t*\t0\t0\t"
    + "ACGT" * 7 + "AC\t" + "I" * 30 + "\n",
    "fwd1\t0\tsynth\t51\t60\t2H8M1D9M\t*\t0\t0\t" + "TTGCA" * 3 + "GG\t*\n",
]
_BAM_TAGS = (b"NMi" + struct.pack("<i", 3) + b"MDZ10A5^C8\x00"
             + b"XAAx" + b"ZBBc" + struct.pack("<I", 2) + b"\x01\x02")


def _encode_bam(path, refs, records):
    """A BAM of ``records`` (BAM record layout, one plain gzip stream,
    which gzip.open reads as BGZF's members), each with _BAM_TAGS."""
    codes = {c: i for i, c in enumerate(port_sam.SEQ_CODES)}
    ops = {c: i for i, c in enumerate(port_sam.CIGAR_OPS)}
    text = b"@HD\tVN:1.6\n"
    out = [b"BAM\x01", struct.pack("<i", len(text)), text,
           struct.pack("<i", len(refs))]
    for name, length in refs:
        out += [struct.pack("<i", len(name) + 1), name.encode() + b"\x00",
                struct.pack("<i", length)]
    for r in records:
        name = r.qname.encode() + b"\x00"
        seq = [codes[c] for c in r.seq]
        packed = bytes((seq[i] << 4) | (seq[i + 1] if i + 1 < len(seq) else 0)
                       for i in range(0, len(seq), 2))
        qual = bytes(r.qual) if r.qual is not None else b"\xff" * len(seq)
        ref_id = [n for n, _ in refs].index(r.rname) if r.rname else -1
        body = (struct.pack("<iiBBHHHiiii", ref_id, r.pos, len(name),
                            r.mapq, 0, len(r.cigar), r.flag, len(seq), -1,
                            -1, 0) + name
                + b"".join(struct.pack("<I", (n << 4) | ops[op])
                           for n, op in r.cigar)
                + packed + qual + _BAM_TAGS)
        out += [struct.pack("<i", len(body)), body]
    with gzip.open(path, "wb") as fh:
        fh.write(b"".join(out))


def _window(sam_module, rec):
    """reconstruct_reference_window's result, or the type of the error it
    raises (the MD tag is longer than an unmapped record's span)."""
    try:
        return sam_module.reconstruct_reference_window(rec)
    except IndexError as exc:
        return type(exc)


def test_sam_and_bam_records_match_jax(run_files, tmp_path):
    """read_sam on the written SAM (plus a reverse-mapped clipped record
    and a hard-clipped one) and read_bam on the same records encoded as
    BAM with tags: references and every record field equal the JAX
    readers', and the BAM's MD tag rebuilds the same reference window."""
    _, files = run_files
    sam = str(tmp_path / "x.sam")
    shutil.copyfile(files["sam"], sam)
    with open(sam, "a") as fh:
        fh.writelines(_EXTRA_SAM)
    for reader in ("read_sam", "read_alignment_file"):
        jrefs, jrecs = getattr(jax_sam, reader)(sam)
        prefs, precs = getattr(port_sam, reader)(sam)
        jrecs, precs = list(jrecs), list(precs)
        assert prefs == jrefs == ["synth", "synth_rc"]
        assert len(precs) == len(jrecs) == 9
        for a, b in zip(precs, jrecs):
            _same_record(a, b)
    bam = str(tmp_path / "x.bam")
    _encode_bam(bam, [("synth", 20_000), ("synth_rc", 20_000)], precs)
    jrefs, jrecs = jax_sam.read_alignment_file(bam)
    prefs, precs_b = port_sam.read_alignment_file(bam)
    jrecs, precs_b = list(jrecs), list(precs_b)
    assert prefs == jrefs == ["synth", "synth_rc"]
    assert len(precs_b) == len(precs)
    for a, b, s in zip(precs_b, jrecs, precs):
        _same_record(a, b)
        assert (a.qname, a.flag, a.pos, a.cigar, a.seq) == \
            (s.qname, s.flag, s.pos, s.cigar, s.seq)
        assert a.tags == {"NM": 3, "MD": "10A5^C8", "XA": "x"}
        assert _window(port_sam, a) == _window(jax_sam, b)
        assert a.cigar_string() == b.cigar_string()
        assert a.reference_span() == b.reference_span()


def test_filter_reads_drops_the_decoys_as_jax_does(run_files):
    """filter_reads (readdb, and without it by scanning the fast5s) keeps
    the four reads' primary records and drops the secondary, unmapped and
    low-quality records, as the JAX filter_reads does."""
    rgs, files = run_files
    for readdb in (files["readdb"], None):
        want = jax_sam.filter_reads(files["sam"], readdb, [files["fast5_dir"]])
        got = port_sam.filter_reads(files["sam"], readdb, [files["fast5_dir"]])
        assert [(f, r.qname) for f, r in got] == \
            [(f, r.qname) for f, r in want]
        assert [r.qname for _, r in got] == [r.read_label for r, _ in rgs]
        assert [r.flag for _, r in got] == [0 if g.forward else 16
                                            for _, g in rgs]
    names = [r.qname for r in port_sam.read_sam(files["sam"])[1]]
    assert len(names) == len(rgs) + 3
    assert port_sam.load_readdb(files["readdb"], []) == \
        jax_sam.load_readdb(files["readdb"], [])
    assert port_sam.build_readdb([files["fast5_dir"]]) == \
        jax_sam.build_readdb([files["fast5_dir"]])


def test_from_fast5_matches_jax_and_the_written_reads(run_files):
    """NanoporeReadData.from_fast5 on every written file equals the JAX
    from_fast5 field for field, and gives back the in-memory read: its
    events, sequence and event map (make_event_map pads the trailing k - 1
    bases with the last k-mer's first event, synthetic_read with the last
    event)."""
    rgs, files = run_files
    for read, _ in rgs:
        path = os.path.join(files["fast5_dir"], f"{read.read_label}.fast5")
        got = port_read.NanoporeReadData.from_fast5(path)
        want = jax_read.NanoporeReadData.from_fast5(path)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "params":
                assert vars(a) == vars(b)
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
        assert got.read_label == read.read_label and not got.rna
        assert got.template_read == read.template_read
        assert np.array_equal(got.events, read.events)
        n_kmers = read.read_length - read.kmer_length + 1
        assert np.array_equal(got.event_map[:n_kmers],
                              read.event_map[:n_kmers])
        assert (got.event_map[n_kmers:] == got.event_map[n_kmers - 1]).all()


def test_fast5_branches_match_jax(run_files, tmp_path):
    """The fast5 reader's other branches against the JAX one, on edited
    copies of a written file: raw signal and channel scaling, a pre-Raw
    read group under EventDetection, basecaller Model attributes into
    ScalingParams, and an RNA read (U -> T, reversed) whose index-scale
    Basecall_1D table gives way to a ReSegmentBasecall one."""
    rgs, files = run_files
    src = os.path.join(files["fast5_dir"], f"{rgs[0][0].read_label}.fast5")
    raw, legacy, rna = (str(tmp_path / f"{n}.fast5")
                        for n in ("raw", "legacy", "rna"))
    for path in (raw, legacy, rna):
        shutil.copyfile(src, path)
    with h5py.File(raw, "r+") as fh:
        fh["Raw/Reads/Read_0/Signal"] = np.arange(-50, 950, dtype=np.int16)
        a = fh.create_group("UniqueGlobalKey/channel_id").attrs
        a.update({"digitisation": 8192.0, "offset": 10.0,
                  "range": 1402.882, "sampling_rate": 4000.0})
        a = fh.create_group(
            "Analyses/Basecall_1D_000/BaseCalled_template/Model").attrs
        a.update({"scale": 1.1, "shift": -3.0, "drift": 1e-4, "var": 1.2})
    with h5py.File(legacy, "r+") as fh:
        fh.move("Raw/Reads/Read_0", "Analyses/EventDetection_000/Reads/Read_7")
        del fh["Raw"]
    with h5py.File(rna, "r+") as fh:
        fh["UniqueGlobalKey/context_tags"].attrs["experiment_kit"] = \
            np.bytes_("internal_rna_kit")
        base = "Analyses/Basecall_1D_000/BaseCalled_template"
        ev = fh[f"{base}/Events"][()]
        fq = fh[f"{base}/Fastq"][()].decode().split("\n")
        fq[1] = fq[1].replace("T", "U")
        fh.move("Analyses/Basecall_1D_000", "Analyses/ReSegmentBasecall_000")
        idx = np.zeros(len(ev), dtype=[
            (n, "<i8" if n == "start" else t)
            for n, t in port_fast5.BASECALL_EVENT_COLUMNS])
        for n in ev.dtype.names:
            idx[n] = ev[n] if n != "start" else np.arange(len(ev))
        fh[f"{base}/Events"] = idx
        fh[f"{base}/Fastq"] = np.bytes_("\n".join(fq))
        resegment = "Analyses/ReSegmentBasecall_000/BaseCalled_template"
        del fh[f"{resegment}/Fastq"]
        fh[f"{resegment}/Fastq"] = np.bytes_("\n".join(fq))
    for path in (raw, legacy, rna):
        with port_fast5.Fast5(path) as p, jax_fast5.Fast5(path) as j:
            assert (p.read_group, p.read_id, p.is_rna(),
                    p.latest_analysis(), p.latest_analysis("ReSegmentBasecall"),
                    p.template_model_attrs()) == \
                (j.read_group, j.read_id, j.is_rna(), j.latest_analysis(),
                 j.latest_analysis("ReSegmentBasecall"),
                 j.template_model_attrs())
            if path == raw:
                assert p.channel_params() == j.channel_params()
                assert np.array_equal(p.raw_signal_pA(), j.raw_signal_pA())
        got = port_read.NanoporeReadData.from_fast5(path)
        want = jax_read.NanoporeReadData.from_fast5(path)
        assert (got.read_label, got.template_read, got.rna,
                got.analysis_path, vars(got.params)) == \
            (want.read_label, want.template_read, want.rna,
             want.analysis_path, vars(want.params))
        assert np.array_equal(got.events, want.events)
        assert np.array_equal(got.event_map, want.event_map)
    assert port_read.NanoporeReadData.from_fast5(raw).params.scale == 1.1
    got = port_read.NanoporeReadData.from_fast5(rna)
    assert got.rna and got.template_read == rgs[0][0].template_read[::-1]
    assert got.analysis_path == "Analyses/ReSegmentBasecall_000"


def test_guides_match_jax_and_the_written_guides(run_files):
    """guide_from_sam_record on every record: equal to the JAX guide
    (reverse-mapped and clipped records among them), valid, equal to the
    in-memory guide for the written reads, and TargetRegions and
    find_guide_alignment agree with the JAX ones."""
    rgs, files = run_files
    recs = list(port_sam.read_sam(files["sam"])[1])
    jrecs = list(jax_sam.read_sam(files["sam"])[1])
    extra = [port_sam.SamRecord(
        qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]) - 1,
        mapq=int(f[4]), cigar=port_sam.parse_cigar_string(f[5]), seq=f[9],
        qual=None) for f in (line.rstrip("\n").split("\t")
                             for line in _EXTRA_SAM)]
    jextra = [jax_sam.SamRecord(**dataclasses.asdict(r)) for r in extra]
    guides = [port_guide.guide_from_sam_record(r) for r in recs + extra]
    jguides = [jax_guide.guide_from_sam_record(r) for r in jrecs + jextra]
    assert [g and dataclasses.asdict(g) for g in guides] == \
        [g and dataclasses.asdict(g) for g in jguides]
    rev = guides[-2]
    assert not rev.forward and rev.query_start == 4 and \
        rev.ops == [(6, "M"), (1, "D"), (5, "M"), (2, "I"), (10, "M")]
    by_label = {r.read_label: g for r, g in rgs}
    for rec, g in zip(recs, guides):
        if rec.qname in by_label and rec.is_primary:
            assert g == by_label[rec.qname]
            assert g.validate(len(rec.seq))
    read0, guide0 = rgs[0]
    assert port_guide.find_guide_alignment(files["sam"], read0.read_label) \
        == guide0
    tsv = os.path.join(os.path.dirname(files["sam"]), "regions.tsv")
    with open(tsv, "w") as fh:
        fh.write(f"{guide0.window_end - 20}\t{guide0.window_start + 10}\n")
    pr, jr = port_guide.TargetRegions(tsv), jax_guide.TargetRegions(tsv)
    assert [pr.accepts(g) for g in guides[:len(rgs)]] == \
        [jr.accepts(g) for g in jguides[:len(rgs)]]
    assert pr.accepts(guide0)


def test_positions_edition_matches_jax_and_the_motif_edition(run_files):
    """The positions file (make_positions_file of the CpG motif, both
    strands): the same rows as the JAX make_positions_file, and
    ProcessedReference(positions=) gives the JAX package's edition, which
    is the motifs=[("CG", "YG")] edition sequence for sequence."""
    _, files = run_files
    jpath = files["positions"] + ".jax"
    jax_reference.make_positions_file(files["fasta"], jpath, MOTIFS)
    with open(files["positions"]) as a, open(jpath) as b:
        assert a.read() == b.read()
    pos = port_reference.AmbiguityPositions.from_file(files["positions"])
    assert pos.data == jax_reference.AmbiguityPositions.from_file(
        files["positions"]).data
    assert {r[2] for r in pos.data} == {"+", "-"}
    got = port_reference.ProcessedReference(files["fasta"], positions=pos)
    want = jax_reference.ProcessedReference(
        files["fasta"],
        positions=jax_reference.AmbiguityPositions(list(pos.data)))
    motif = port_reference.ProcessedReference(files["fasta"], motifs=MOTIFS)
    assert got.forward == want.forward == motif.forward
    assert got.backward == want.backward == motif.backward
    assert port_reference.load_fasta(files["fasta"]) == \
        jax_reference.load_fasta(files["fasta"])
    with pytest.raises(ValueError, match="expected"):
        bad = port_reference.AmbiguityPositions([("synth", 0, "+", "Q", "Y")])
        port_reference.ProcessedReference(files["fasta"], positions=bad)


def test_ambiguity_tables_match_jax(tmp_path):
    """load_ambig_map and load_ambig_model (--ambig_model) read a table
    as the JAX ones do."""
    path = tmp_path / "ambig.tsv"
    path.write_text("Y\tCT\nP\tCE\nJ\tCTJ\nbad\n")
    assert port_alphabet.load_ambig_map(str(path)) == \
        jax_alphabet.load_ambig_map(str(path))
    assert port_alphabet.load_ambig_map(None) == \
        jax_alphabet.load_ambig_map(None)
    assert port_alphabet.load_ambig_model(str(path)) == \
        jax_alphabet.load_ambig_model(str(path))


# --------------------------------------------------------------- CLI run

def _rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def _rows_close(jpath, ppath, post_cols):
    """Every column but ``post_cols`` identical, row for row; those within
    TOL_POST. Rows of one file only are threshold-edge cells."""
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


def test_cli_run_both_matches_jax_cli(both_outputs, run_files):
    """`run --output_format both`: the same file names as the JAX CLI's
    (a backward full TSV for the reverse-mapped read), every column of the
    full and variantCaller TSVs but the posterior identical, posteriors
    within TOL_POST."""
    jdir, pdir = both_outputs
    rgs, _ = run_files
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    assert names == sorted(
        f"{r.read_label}.sm.{s}.tsv" for r, g in rgs
        for s in ("forward" if g.forward else "backward", "vc"))
    assert f"{rgs[REVERSE_READ][0].read_label}.sm.backward.tsv" in names
    n_rows = 0
    for name in names:
        cols = VC_POST_COLS if name.endswith(".vc.tsv") else FULL_POST_COLS
        n_rows += _rows_close(os.path.join(jdir, name),
                              os.path.join(pdir, name), cols)
    assert n_rows > sum(r.n_events for r, _ in rgs) // 2


def test_cli_run_variants_matches_jax_cli(variants_outputs, run_files):
    """`run --config` (the positions file among the sample keys)
    `--output_format variants --variants CT --max_reads 1`: the same file
    names as the JAX CLI's (the first read's and the two across-read
    tables), every column but the C and T probabilities identical, those
    within TOL_VARIANTS."""
    jdir, pdir = variants_outputs
    rgs, _ = run_files
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    assert names == sorted([f"{r.read_label}.sm.variants.tsv"
                            for r, _ in rgs[:VARIANT_READS]]
                           + ["variants_aggregate.tsv",
                              "variants_per_read.tsv"])
    for name in names:
        g = pd.read_csv(os.path.join(pdir, name), sep="\t")
        w = pd.read_csv(os.path.join(jdir, name), sep="\t")
        assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
        for c in g.columns:
            if c in ("C", "T"):
                assert np.abs(g[c] - w[c]).max() <= TOL_VARIANTS, (name, c)
            else:
                assert g[c].tolist() == w[c].tolist(), (name, c)


def test_max_reads_and_resume_skip_reads(run_files, tmp_path):
    """max_reads keeps the first reads; overwrite=False skips a read whose
    output exists; a read outside target_regions is skipped: the port
    aligns and writes the one read left."""
    rgs, files = run_files
    out = tmp_path / "out"
    out.mkdir()
    labels = [r.read_label for r, _ in rgs]
    (out / f"{labels[0]}.sm.forward.tsv").write_text("")
    regions = tmp_path / "regions.tsv"
    g1, g2 = rgs[1][1], rgs[2][1]
    regions.write_text(f"{g1.window_start}\t{g1.window_start + 50}\n")
    assert not (g2.window_start <= g1.window_start
                and g1.window_start + 50 <= g2.window_end)
    written = run_signal_align(
        files["sam"], files["readdb"], [files["fast5_dir"]], files["fasta"],
        PoreModel.from_file(files["model"]), str(out), max_reads=3, overwrite=False,
        target_regions=port_guide.TargetRegions(str(regions)),
        verbose=False, device=CPU)
    assert [os.path.basename(p) for p in written] == \
        [f"{labels[1]}.sm.forward.tsv"]


@pytest.mark.parametrize("option, item", [("--distributed", "item 5")])
def test_unported_cli_options_raise(run_files, tmp_path, option, item):
    """Each option the port does not cover raises NotImplementedError
    naming its ROADMAP item, before any read is aligned."""
    _, files = run_files
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 {item}"):
        port_cli.main(_cli_args(files, str(tmp_path / "out"), option,
                                "--device", "cpu"))
    assert not (tmp_path / "out").exists()


def test_fast5_without_events_aligns_from_its_raw_signal(run_files,
                                                         both_outputs,
                                                         tmp_path):
    """A fast5 with raw signal and no basecall events among good reads:
    the port aligns its raw signal (kmer-event alignment, the generated
    table written into the file) as the JAX package does, and the other
    read's output is the one its basecall table gives in the CLI run
    (within TOL_POST)."""
    rgs, files = run_files
    raw = write_synthetic_run(rgs, str(tmp_path / "raw"), files["fasta"],
                              raw=True)
    f5dir = tmp_path / "fast5"
    shutil.copytree(files["fast5_dir"], f5dir)
    label = rgs[1][0].read_label
    shutil.copyfile(os.path.join(raw["fast5_dir"], f"{label}.fast5"),
                    f5dir / f"{label}.fast5")
    out = tmp_path / "out"
    written = run_signal_align(
        files["sam"], None, [str(f5dir)], files["fasta"],
        PoreModel.from_file(files["model"]), str(out), max_reads=2,
        verbose=False, device=CPU)
    labels = [r.read_label for r, _ in rgs[:2]]
    assert [os.path.basename(p) for p in written] == \
        [f"{x}.sm.forward.tsv" for x in labels]
    with h5py.File(f5dir / f"{label}.fast5") as fh:
        assert sorted(fh["Analyses"]) == ["SignalAlign_Basecall_1D_000"]
    with open(written[1]) as fh:
        rows = [line.split("\t") for line in fh]
    assert len(rows) > rgs[1][0].n_events // 2
    assert {r[3] for r in rows} == {label}
    _, pdir = both_outputs
    _rows_close(os.path.join(pdir, os.path.basename(written[0])), written[0],
                FULL_POST_COLS)
