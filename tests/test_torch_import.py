"""The PyTorch port imports nothing of the JAX package and never imports
jax: with ``signalalign_tpu``, jax and h5py blocked it imports and aligns a
read on the CPU; where jax is installed importing the port leaves it out of
sys.modules; and no source file of the port has an import line naming the
JAX package."""

import re

import os
import subprocess
import sys
import textwrap

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
