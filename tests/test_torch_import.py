"""The PyTorch port imports nothing of the JAX package and never imports
jax: with ``signalalign_tpu``, jax and h5py blocked it imports and aligns a
read on the CPU, every module of it imports (the CLI and the fast5, SAM
and runner modules among them) and opening a fast5 raises ImportError
naming h5py, as the CLI's ``run`` and ``train`` and a readdb built from
fast5 files do with h5py blocked; where jax is installed importing the port leaves it out of
sys.modules; and no source file of the port has an import line naming the
JAX package."""

import re

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str):
    env = dict(os.environ)
    env.pop("SIGNALALIGN_TPU_NO_COMPILE_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_aligns_with_jax_and_h5py_blocked(tmp_path):
    """Gaussian and HDP alignment on the CPU with signalalign_tpu, jax and
    h5py blocked."""
    out = _run(f"""
        import sys
        sys.modules["signalalign_tpu"] = None   # importing it raises
        sys.modules["jax"] = None
        sys.modules["h5py"] = None      # not installed on every GPU host
        import torch
        from signalalign_tpu_torch.ops.banded_fb import MODE_HDP
        from signalalign_tpu_torch.pipeline.runner import run_alignment_batch
        from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
        from signalalign_tpu_torch.utils.synthetic import (
            build_synthetic_batch, synthetic_hdp, synthetic_pore_model)
        model = synthetic_pore_model(0)
        rgs, ref, _, _, _ = build_synthetic_batch(
            model, n_reads=1, ev_min=300, ev_max=400, seed=2,
            genome_len=5000, fasta_path={str(tmp_path / "g.fa")!r})
        res = run_alignment_batch(rgs, ref, model,
                                  device=torch.device("cpu"))
        assert len(res) == 1 and len(res[0].aligned_pairs) > 100
        hdp = synthetic_hdp(model, 1, grid_length=61)
        res_hdp = run_alignment_batch(rgs, ref, model,
                                      AlignmentConfig(emission_mode=MODE_HDP),
                                      hdp, device=torch.device("cpu"))
        assert len(res_hdp) == 1 and len(res_hdp[0].aligned_pairs) > 100
        print("pairs", len(res[0].aligned_pairs), len(res_hdp[0].aligned_pairs))
    """)
    assert "pairs" in out


def test_every_module_imports_with_jax_and_h5py_blocked(tmp_path):
    """Every module of the port imports with signalalign_tpu, jax and h5py
    blocked, and Fast5(path) then raises ImportError naming h5py."""
    out = _run(f"""
        import importlib, pkgutil, sys
        sys.modules["signalalign_tpu"] = None
        sys.modules["jax"] = None
        sys.modules["h5py"] = None
        import signalalign_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            signalalign_tpu_torch.__path__, "signalalign_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("cli", "io.fast5", "io.sam", "pipeline.runner",
                     "hdp.train", "utils.native", "ops.event_detect",
                     "pipeline.event_align", "pipeline.mea", "io.embed",
                     "io.minialign"):
            assert "signalalign_tpu_torch." + name in names, name
        from signalalign_tpu_torch.io.fast5 import Fast5
        try:
            Fast5({str(tmp_path / "x.fast5")!r})
        except ImportError as exc:
            assert "h5py" in str(exc), exc
        else:
            raise AssertionError("Fast5 opened a file without h5py")
        print(len(names), "modules")
    """)
    assert "modules" in out


def test_raw_and_2d_reads_align_with_jax_and_h5py_blocked(tmp_path):
    """With signalalign_tpu, jax and h5py blocked, the in-memory twins of
    a raw-signal fast5 and of a 2D fast5 go through the port's arrays
    entry points (align_raw_signal, the guide aligner, both strands'
    alignment, the embed tables and MEA labels) on the CPU, and
    run_signal_align_2d raises ImportError naming h5py."""
    out = _run(f"""
        import sys
        sys.modules["signalalign_tpu"] = None
        sys.modules["jax"] = None
        sys.modules["h5py"] = None
        import numpy as np, torch
        from signalalign_tpu_torch.io import embed
        from signalalign_tpu_torch.io.minialign import generate_guide_alignment
        from signalalign_tpu_torch.pipeline import event_align
        from signalalign_tpu_torch.pipeline.runner import (
            align_2d_and_write, align_and_write, run_signal_align_2d)
        from signalalign_tpu_torch.utils import synthetic as syn
        cpu = torch.device("cpu")
        model, cmodel = syn.synthetic_pore_model(0), syn.synthetic_pore_model(1)
        rgs, comps, ref, _ = syn.build_synthetic_2d_batch(
            model, cmodel, n_reads=1, ev_min=150, ev_max=200, seed=2,
            genome_len=5000, fasta_path={str(tmp_path / "g.fa")!r})
        (read, guide), comp = rgs[0], comps[0]
        res = event_align.align_raw_signal(*syn.raw_signal_read(read, 0),
                                           model, read.template_read)
        assert res.qc_ok, res.qc_msg
        raw_read = event_align.read_from_raw_result(
            res, read.read_label, read.template_read, None, 5)
        results = []
        written = align_and_write([(raw_read, guide)], ref, model,
                                  {str(tmp_path / "raw")!r}, device=cpu,
                                  results_out=results)
        sa = embed.add_raw_fields(
            embed.full_rows_to_table(results[0].full_rows(model)),
            event_align.basecall_event_table(res))
        labels = embed.mea_labels_from_events(sa)
        assert len(labels) > 50 and len(written) == 1
        read2d = syn.twod_read(read, comp)
        g2 = generate_guide_alignment(read2d.twod_sequence, ref)
        w2 = align_2d_and_write([(read2d, g2)], ref, model, cmodel,
                                {str(tmp_path / "twod")!r}, device=cpu)
        strands = [l.split("\\t")[4] for l in open(w2[0])]
        assert set(strands) == {{"t", "c"}}, set(strands)
        try:
            run_signal_align_2d([{str(tmp_path)!r}], "ref.fa", model, cmodel,
                                {str(tmp_path / "x")!r}, device=cpu)
        except ImportError as exc:
            assert "h5py" in str(exc), exc
        else:
            raise AssertionError("run_signal_align_2d ran without h5py")
        print("labels", len(labels), "rows", len(strands))
    """)
    assert "labels" in out


def test_native_bindings_match_the_jax_package():
    """The port's ctypes bindings of the native library's entry points
    have the JAX package's restypes (``sa_minidx_build`` a c_void_p: the
    default c_int would truncate its 64-bit index pointer) and, where the
    JAX package sets them, its argtypes. ``sa_sw_align`` is bound with
    the C declaration's long, where the JAX package leaves ctypes' c_int
    default: both read the function's 0 or -1 alike."""
    import ctypes

    from signalalign_tpu.utils import native as jax_native
    from signalalign_tpu_torch.utils import native
    port = native.load()
    jax_lib = jax_native._load()
    assert jax_lib is not None
    for name in ("sa_peak_detector", "sa_adaptive_banded_align",
                 "sa_minidx_build", "sa_minidx_free", "sa_minidx_map",
                 "sa_sw_align_banded"):
        assert getattr(port, name).restype == getattr(jax_lib, name).restype, \
            name
    for name in ("sa_peak_detector", "sa_adaptive_banded_align",
                 "sa_minidx_build", "sa_minidx_free"):
        assert getattr(port, name).argtypes == \
            getattr(jax_lib, name).argtypes, name
    assert port.sa_minidx_build.restype is ctypes.c_void_p
    assert port.sa_sw_align.restype is ctypes.c_long
    assert jax_lib.sa_sw_align.restype is ctypes.c_int
    for name in ("sa_minidx_map", "sa_sw_align", "sa_sw_align_banded"):
        assert len(getattr(port, name).argtypes) == {
            "sa_minidx_map": 13, "sa_sw_align": 17,
            "sa_sw_align_banded": 19}[name]


def test_run_raises_naming_h5py_when_it_is_blocked(tmp_path, monkeypatch):
    """With h5py blocked, the CLI's ``run`` on written SAM, readdb, FASTA
    and model files raises ImportError naming h5py before it writes
    anything (no read is skipped as bad), and so does ``filter_reads``
    where it builds the readdb from the fast5 files."""
    from signalalign_tpu_torch import cli
    from signalalign_tpu_torch.io.sam import filter_reads
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       synthetic_pore_model,
                                                       write_synthetic_run)
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=1, ev_min=300, ev_max=400, seed=2, genome_len=5000,
        fasta_path=str(tmp_path / "g.fa"))
    files = write_synthetic_run(rgs, str(tmp_path / "in"), fasta,
                                model=model, fast5=False)
    label = rgs[0][0].read_label
    open(os.path.join(files["fast5_dir"], f"{label}.fast5"), "w").close()
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tmp_path / "out"
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["run", "--alignment_file", files["sam"], "--readdb",
                  files["readdb"], "--fast5_dir", files["fast5_dir"],
                  "--ref", files["fasta"], "--model", files["model"],
                  "--output_dir", str(out), "--device", "cpu"])
    assert not out.exists()
    with pytest.raises(ImportError, match="h5py"):
        filter_reads(files["sam"], None, [files["fast5_dir"]])


def test_train_raises_naming_h5py_when_it_is_blocked(tmp_path, monkeypatch):
    """With h5py blocked, the CLI's ``train`` on written SAM, readdb,
    FASTA and model files raises ImportError naming h5py before it reads a
    read, and writes no model (no read is skipped as bad, and no model is
    trained on zero reads)."""
    from signalalign_tpu_torch import cli
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       synthetic_pore_model,
                                                       write_synthetic_run)
    model = synthetic_pore_model(0)
    rgs, _, _, _, fasta = build_synthetic_batch(
        model, n_reads=1, ev_min=300, ev_max=400, seed=2, genome_len=5000,
        fasta_path=str(tmp_path / "g.fa"))
    files = write_synthetic_run(rgs, str(tmp_path / "in"), fasta,
                                model=model, fast5=False)
    label = rgs[0][0].read_label
    open(os.path.join(files["fast5_dir"], f"{label}.fast5"), "w").close()
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tmp_path / "out"
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["train", "--alignment_file", files["sam"], "--readdb",
                  files["readdb"], "--fast5_dir", files["fast5_dir"],
                  "--ref", files["fasta"], "--model", files["model"],
                  "--output_dir", str(out), "--iterations", "1",
                  "--device", "cpu"])
    assert not out.exists()


def test_importing_the_port_leaves_jax_out():
    out = _run("""
        import sys
        import signalalign_tpu_torch.pipeline.runner
        import signalalign_tpu_torch.pipeline.train
        import signalalign_tpu_torch.ops.banded_fb_hopper
        import signalalign_tpu_torch.ops.batch
        import signalalign_tpu_torch.convert
        import signalalign_tpu_torch.utils.synthetic
        print("jax" in sys.modules, "signalalign_tpu" in sys.modules)
    """)
    assert out.strip() == "False False"


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(import\s+signalalign_tpu\b(?!_)|from\s+signalalign_tpu(\.|\s+import\b))")


def test_no_source_file_imports_the_jax_package():
    """Every .py under signalalign_tpu_torch/ and chip_smoke.py: no
    ``import signalalign_tpu``, ``from signalalign_tpu.`` or
    ``from signalalign_tpu import`` line."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "signalalign_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for name in ("cli.py", "io/fast5.py", "io/sam.py", "pipeline/runner.py",
                 "hdp/train.py", "utils/native.py", "ops/event_detect.py",
                 "pipeline/event_align.py", "pipeline/mea.py", "io/embed.py",
                 "io/minialign.py"):
        assert os.path.join(ROOT, "signalalign_tpu_torch", name) in files
    bad = []
    for path in files:
        with open(path) as fh:
            bad += [f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}"
                    for i, line in enumerate(fh, 1)
                    if _JAX_PACKAGE_IMPORT.match(line)]
    assert not bad, bad
    assert _JAX_PACKAGE_IMPORT.match("from signalalign_tpu.io import read")
    assert _JAX_PACKAGE_IMPORT.match("    import signalalign_tpu.ops")
    assert _JAX_PACKAGE_IMPORT.match("from signalalign_tpu import cli")
    assert not _JAX_PACKAGE_IMPORT.match("from signalalign_tpu_torch import x")
    assert not _JAX_PACKAGE_IMPORT.match("import signalalign_tpu_torch.ops")
