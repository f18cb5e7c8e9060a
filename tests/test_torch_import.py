"""The PyTorch port never imports jax: with jax blocked it imports and
aligns a read on the CPU, and where jax is installed importing the port
leaves it out of sys.modules."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str):
    env = dict(os.environ)
    # the test process sets this for the JAX package; the port must set it
    # itself
    env.pop("SIGNALALIGN_TPU_NO_COMPILE_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_aligns_with_jax_and_h5py_blocked(tmp_path):
    out = _run(f"""
        import sys
        sys.modules["jax"] = None      # import jax raises ImportError
        sys.modules["h5py"] = None     # not installed on every GPU host
        import torch
        from signalalign_tpu_torch.pipeline.runner import run_alignment_batch
        from signalalign_tpu_torch.utils.synthetic import (
            build_synthetic_batch, synthetic_pore_model)
        model = synthetic_pore_model(0)
        rgs, ref, _, _, _ = build_synthetic_batch(
            model, n_reads=1, ev_min=300, ev_max=400, seed=2,
            genome_len=5000, fasta_path={str(tmp_path / "g.fa")!r})
        res = run_alignment_batch(rgs, ref, model,
                                  device=torch.device("cpu"))
        assert len(res) == 1 and len(res[0].aligned_pairs) > 100
        print("pairs", len(res[0].aligned_pairs))
    """)
    assert "pairs" in out


def test_importing_the_port_leaves_jax_out():
    out = _run("""
        import sys
        import signalalign_tpu_torch.pipeline.runner
        import signalalign_tpu_torch.ops.banded_fb_hopper
        import signalalign_tpu_torch.ops.batch
        import signalalign_tpu_torch.convert
        import signalalign_tpu_torch.utils.synthetic
        print("jax" in sys.modules)
    """)
    assert out.strip() == "False"
