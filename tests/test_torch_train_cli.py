"""Both CLIs' ``train`` on the same files on the CPU: two samples of
seeded synthetic reads written by ``write_synthetic_run`` (fast5, readdb,
SAM, FASTA, .model) on a 6-mer ACEGOT model whose 5-mC k-mers sit 3 pA
above their C k-mers (``methylated_pore_model``): a canonical sample and
an mC sample (its events drawn from the CG -> EG edition, its basecalls
and FASTA with C; ``motifs: [["CG", "EG"]]``). One iteration of
transitions EM, then ``hdp_emissions`` on a 120-point grid with the JAX
CLI test's Gibbs sizes (``tests/test_train.py``: 10 samples, burn-in
multiplier 2, thinning 10, 30 assignments a k-mer). The port runs with
``--device cpu`` (the kernels' twins); the JAX CLI runs its XLA path.

Tolerances: the trained transitions within 1e-5 (``tests/
test_torch_train.py``'s). buildAlignment.tsv rows carry a descaled mean
that both packages compute in float64 from the same events and scaling,
so rows compare exactly; a row is kept at posterior >= 0.8 and among a
k-mer's 30 best, and the two f32 DPs' posteriors differ by ~1e-4, so a
row whose posterior sits that close to 0.8 or to the 30th best may be in
one table only: at most 2% of the rows may differ. The .nhdp observed
sets may differ only at the k-mers of such rows."""

import json
import os
import shutil
from collections import Counter

import h5py

import numpy as np
import pytest

from signalalign_tpu import cli as jax_cli
from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu_torch import cli as port_cli
from signalalign_tpu_torch.models import hdp_model
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   methylated_pore_model,
                                                   synthetic_pore_model,
                                                   write_synthetic_run)

TOL_TRANS = 1e-5
MAX_ROW_DIFF = 0.02


def _config(tmp):
    """A training config of the canonical and the mC sample (no output
    directory)."""
    model = methylated_pore_model(synthetic_pore_model(0, "ACEGOT", 6))
    fa = str(tmp / "genome.fa")
    kw = dict(n_reads=4, ev_min=350, ev_max=450, seed=8, genome_len=12_000,
              fasta_path=fa)
    can = build_synthetic_batch(model, **kw)[0]
    mc = build_synthetic_batch(model, event_motif=("CG", "EG"), **kw)[0]
    fc = write_synthetic_run(can[:2], str(tmp / "canonical"), fa, model=model)
    fm = write_synthetic_run(mc[2:], str(tmp / "mc"), fa)

    def sample(files, **extra):
        return dict(alignment_file=files["sam"], readdb=files["readdb"],
                    fast5_dirs=[files["fast5_dir"]],
                    probability_threshold=0.8,
                    number_of_kmer_assignments=30, **extra)

    return {"samples": [sample(fc, name="canonical"),
                        sample(fm, name="mC", motifs=[["CG", "EG"]])],
            "reference": fc["fasta"], "template_hmm_model": fc["model"],
            "training": {"transitions": True, "em_iterations": 1,
                         "hdp_emissions": True,
                         "hdp_type": "singleLevelFixed",
                         "max_assignments": 30, "gibbs_samples": 10},
            "hdp_args": {"grid_start": 30.0, "grid_end": 180.0,
                         "grid_length": 120, "burnin_multiplier": 2,
                         "thinning": 10}}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Both CLIs' train on one config: (port output dir, JAX output dir)."""
    tmp = tmp_path_factory.mktemp("train")
    cfg = _config(tmp)
    dirs = {}
    for name in ("port", "jax"):
        dirs[name] = tmp / f"out_{name}"
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(dict(cfg, output_dir=str(dirs[name]))))
        args = ["train", "--config", str(path)]
        if name == "port":
            assert port_cli.main(args + ["--device", "cpu"]) == 0
        else:
            assert jax_cli.main(args) == 0
    return dirs["port"], dirs["jax"]


def _rows(path):
    with open(path) as fh:
        return [tuple(line.rstrip("\n").split("\t")) for line in fh]


def test_cli_train_models_match_jax(outputs):
    """The trained template model's transitions (one EM iteration over
    both samples, the mC sample on its CG -> EG edition) agree within
    1e-5, its levels are the start model's (no emission training here),
    and both wrote the iteration's checkpoint and expectations file."""
    port, jax = outputs
    got = PoreModel.from_file(str(port / "template_trained.model"))
    want = PoreModel.from_file(str(jax / "template_trained.model"))
    np.testing.assert_allclose(got.transitions, want.transitions,
                               atol=TOL_TRANS, rtol=0)
    assert np.array_equal(got.level_mean, want.level_mean)
    for d in (port, jax):
        assert (d / "template_trained_0.model").exists()
        assert (d / "template_trained_0.template.expectations.tsv").exists()


def test_cli_train_build_alignment_matches_jax(outputs):
    """buildAlignment.tsv: E-labelled rows from the mC sample and canonical
    ones from both; the same k-mer labels in sorted order, and at most 2%
    of the (k-mer, strand, value) rows in one table only."""
    port, jax = outputs
    got = _rows(port / "buildAlignment.tsv")
    want = _rows(jax / "buildAlignment.tsv")
    n_e = sum("E" in r[0] for r in got)
    assert n_e > 10 and len(got) - n_e > 10
    assert [r[0] for r in got] == sorted(r[0] for r in got)
    diff = sum(((Counter(got) - Counter(want))
                + (Counter(want) - Counter(got))).values())
    assert diff <= MAX_ROW_DIFF * max(len(got), len(want))


def test_cli_train_nhdp_observed_sets_match_jax(outputs):
    """template.nhdp: the port's loader reads both files on the trainer's
    grid; their observed k-mer sets (E ones among them) differ only at
    k-mers whose buildAlignment rows differ."""
    port, jax = outputs
    got = hdp_model.load_nhdp(str(port / "template.nhdp"))
    want = jax_hdp_model.load_nhdp(str(jax / "template.nhdp"))
    assert len(got.grid) == len(want.grid) == 120
    a = got.alphabet
    obs_got = {a.index_to_kmer(int(i)) for i in np.flatnonzero(got.observed)}
    obs_want = {a.index_to_kmer(int(i)) for i in np.flatnonzero(want.observed)}
    rows_got = Counter(_rows(port / "buildAlignment.tsv"))
    rows_want = Counter(_rows(jax / "buildAlignment.tsv"))
    differing = {r[0] for r in (rows_got - rows_want) + (rows_want - rows_got)}
    assert obs_got ^ obs_want <= differing
    assert sum("E" in k for k in obs_got) > 5


@pytest.mark.parametrize("extra, config, item", [
    (["--distributed"], {}, "item 5")], ids=["distributed"])
def test_unported_train_options_raise(tmp_path, extra, config, item):
    """The options whose slices are not ported raise NotImplementedError
    naming their ROADMAP item before any file is read."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(["train", "--config", str(path), *extra])


def test_three_state_hdp_needs_its_hdp_model(tmp_path, capsys):
    """stateMachineType threeStateHdp without template_hdp_model ends with
    exit code 2 and says why, as the JAX CLI does."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"training": {
        "stateMachineType": "threeStateHdp"}}))
    assert port_cli.main(["train", "--config", str(path)]) == 2
    assert "template_hdp_model" in capsys.readouterr().err


def _train_files(tmp_path, **kw):
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=2, ev_min=300, ev_max=400, seed=2, genome_len=5000,
        fasta_path=str(tmp_path / "g.fa"))
    return rgs, write_synthetic_run(rgs, str(tmp_path / "in"), fasta,
                                    model=model, **kw)


def _train_args(files, out):
    return ["train", "--alignment_file", files["sam"], "--readdb",
            files["readdb"], "--fast5_dir", files["fast5_dir"], "--ref",
            files["fasta"], "--model", files["model"], "--output_dir",
            str(out), "--iterations", "1", "--device", "cpu"]


@pytest.mark.parametrize("fault", ["no_reads"])
def test_train_stops_on_reads_it_cannot_load(tmp_path, fault):
    """``train`` skips a read it cannot load, as the JAX CLI does, but
    stops where no read loads: ValueError, and no model is written."""
    rgs, files = _train_files(tmp_path)
    for read, _ in rgs:
        path = os.path.join(files["fast5_dir"], f"{read.read_label}.fast5")
        open(path, "w").close()         # not an HDF5 file: skipped
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="none of the 2 listed reads"):
        port_cli.main(_train_args(files, out))
    assert not out.exists()


def test_train_skips_a_fast5_without_events_as_jax(tmp_path, capsys):
    """A fast5 with raw signal and no event table among the reads:
    ``train`` skips it, as the JAX CLI's does, trains on the other read
    and writes nothing into the skipped file; both CLIs' trained
    transitions agree within 1e-5."""
    rgs, files = _train_files(tmp_path)
    raw = write_synthetic_run(rgs, str(tmp_path / "raw"), files["fasta"],
                              raw=True)
    label = rgs[0][0].read_label
    path = os.path.join(files["fast5_dir"], f"{label}.fast5")
    shutil.copyfile(os.path.join(raw["fast5_dir"], f"{label}.fast5"), path)
    out, jout = tmp_path / "out", tmp_path / "jax_out"
    assert port_cli.main(_train_args(files, out)) == 0
    err = capsys.readouterr().err
    assert f"skipping {path}" in err and "(1 reads)" in err
    assert jax_cli.main(_train_args(files, jout)[:-2]) == 0
    assert f"skipping {path}" in capsys.readouterr().err
    with h5py.File(path) as fh:
        assert "Analyses" not in fh
    got = PoreModel.from_file(str(out / "template_trained.model"))
    want = PoreModel.from_file(str(jout / "template_trained.model"))
    np.testing.assert_allclose(got.transitions, want.transitions,
                               atol=TOL_TRANS, rtol=0)
