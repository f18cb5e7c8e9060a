"""The port's EM expectation pass at P > 1 paths per cell against the JAX
package's XLA expectation core (``expectations_batched``, where the JAX
runner sends such buckets) on the CPU: P = 2 and 4 with Gaussian and with
HDP emissions, and one P = 8 case at a small width. The port runs it
twice: its plain core (``bfb.expectations``) and the bucket aligner's
expectation pass (``HopperAligner.expect``: the kernels' twins on CPU
tensors, with ``kexp_by_kmer`` keying each (path, position) by its
k-mer). Problems are seeded synthetic segments whose sequence carries
the ambiguity code every 12 positions and a cluster of one, two or three
codes inside one k-mer (P = 2, 4, 8).

Tolerances are those of ``tests/test_torch_expectations.py`` (the JAX
package's own Pallas-vs-XLA expectation tests): texp rtol 2e-4 / atol
5e-3, kexp rtol 2e-3 / atol 5e-3. Under HDP the aligner returns zero
kexp (the TPU kernel's contract) and is held on texp only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.batch import stack_kmer_ids as jax_stack_kmer_ids
from signalalign_tpu.ops.batch import stack_problems as jax_stack_problems
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.convert import (hdp_tables, pore_model_from_numpy,
                                           problem_from_numpy, problem_tensors)
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops import banded_fb_hopper as hk
from signalalign_tpu_torch.utils.synthetic import (synthetic_hdp,
                                                   synthetic_pore_model,
                                                   write_nhdp_text)

CPU = torch.device("cpu")
THR = 0.01
TEXP_TOL = dict(rtol=2e-4, atol=5e-3)
KEXP_TOL = dict(rtol=2e-3, atol=5e-3)
# (emission mode, P, W, bases per segment)
CASES = [("gauss", 2, 64, 80), ("gauss", 4, 64, 80), ("hdp", 2, 64, 80),
         ("hdp", 4, 64, 80), ("gauss", 8, 32, 60)]


def _jax_model(alphabet):
    jm = JPoreModel(alphabet, 5)
    src = synthetic_pore_model(0, alphabet, 5)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm


def _pad(x, D, fill):
    """(B, D1, ...) tensor -> (B, D, ...) numpy, rows past D1 ``fill``."""
    x = x.numpy()
    out = np.full((x.shape[0], D) + x.shape[2:], fill, x.dtype)
    out[:, :x.shape[1]] = x
    return out


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}_p{P}" for m, P, _, _ in CASES])
def case(request, tmp_path_factory):
    """(mode, the JAX XLA core's (texp, kexp) per problem, the port's core's
    (texp, kexp), the aligner's results, the twins' totals) for two
    segments. The ambiguity code is Y (C/T) under Gaussian emissions and
    P (C/E) under HDP, on a 5-mer ACGT or ACEGT model; events follow the C
    reading. Both cores get the same inputs: the twins' three-state
    stacks (padded to the JAX Dpad + 1 rows with NEG) and normalisers, so
    only the expectation cores are compared; the JAX package's P > 1
    sweeps, which ``tests/test_torch_paths.py`` holds against the twins,
    would add a compilation per case and nothing to what is held here."""
    mode, P, W, L = request.param
    hdp = mode == "hdp"
    jm = _jax_model("ACEGT" if hdp else "ACGT")
    code = "P" if hdp else "Y"
    jh = tables = None
    if hdp:
        path = str(tmp_path_factory.mktemp("hdp") / "m.nhdp")
        write_nhdp_text(synthetic_hdp(pore_model_from_numpy(jm), 1,
                                      grid_length=121), path)
        jh = jax_hdp_model.load_nhdp(path)
    rng = np.random.default_rng(20 + P + 10 * hdp)
    jp = []
    for i in range(2):
        seq = list(rng.choice(list("ACGT"), size=L))
        for j in range(6 + i, L - 6, 12):
            if not 24 <= j <= 40:     # clear of the cluster's k-mers
                seq[j] = code
        cluster = {2: "Y", 4: "YGY", 8: "YGYGY"}[P].replace("Y", code)
        seq[30:30 + len(cluster)] = cluster
        seq = "".join(seq)
        ids = jm.alphabet.seq_to_kmer_ids(seq.replace(code, "C"))
        ev = np.stack([jm.level_mean[ids] + rng.normal(0, 1.5, len(ids)),
                       np.ones(len(ids)), np.full(len(ids), .005),
                       np.arange(len(ids)) * .005], 1)
        jp.append(jbfb.prepare_problem(
            seq, ev, jm, ScalingParams(shift=0.2 * i, var=1.0 + 0.05 * i),
            DEFAULT_AMBIG_BASES, W=W, Dpad=3 * L, P=P,
            anchor_pairs=[(j, j) for j in range(8, len(ids) - 8, 15)],
            expansion=8, mode=bfb.MODE_HDP if hdp else bfb.MODE_MEAN_ONLY,
            hdp=jh))
    assert max(int(p.n_paths.max()) for p in jp) == P
    tp = [problem_from_numpy(p) for p in jp]
    if hdp:
        tables = hdp_tables(tp[0].hdp_dens, tp[0].hdp_slopes,
                            *tp[0].hdp_grid, CPU)
    pt = problem_tensors(tp, W, CPU, tables, kmer_ids=True)
    f, fi, lf = bfb.sweep_forward(pt, store_full=True)
    b, bi, lb = bfb.sweep_backward(pt, store_full=True)
    fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
    bo, _ = bfb.backward_offsets(bi, lb)
    c1, c2 = bfb.expect_cvecs(fo - tf[:, None], bo)
    K = jp[0].num_kmers
    D = jp[0].x0.shape[0]
    args = jax_stack_problems(jp)
    eargs = [jnp.asarray(_pad(f, D, bfb.NEG)), jnp.asarray(_pad(b, D, bfb.NEG)),
             jnp.asarray(_pad(c1, D, 0.0).astype(np.float32)),
             jnp.asarray(_pad(c2, D, 0.0).astype(np.float32)),
             *(args[i] for i in (0, 1, 2, 3, 4, 5, 8, 10, 11, 12)),
             jax_stack_kmer_ids(jp)]
    if hdp:
        eargs += [jnp.asarray(jp[0].hdp_dens), jnp.asarray(jp[0].hdp_slopes),
                  jnp.asarray(jp[0].hdp_grid)]
    texp, _, kexp = jbfb.expectations_batched(*eargs, W=W, P=P, mode=jp[0].mode,
                                              num_kmers=K)
    want = (np.asarray(texp, np.float64), np.asarray(kexp, np.float64))
    # the port's core with the moments asked for in both modes (as the XLA
    # core computes them)
    got = bfb.expectations(pt, f, b, c1, c2, K)
    aligner = hk.HopperAligner(tp, W, CPU, tables, expect=True).expect(THR)
    return mode, want, (got[0].numpy(), got[1].numpy()), aligner, \
        tf.numpy()


def test_expectations_match_jax_xla_core(case):
    """The plain expectation core at P > 1 against the JAX XLA core on the
    same stacks: texp (summed over the legal (source, target) path pairs)
    and kexp keyed by each path's k-mer, in both emission modes (the XLA
    core forms Gaussian moments under HDP too)."""
    _, (jt, jk), (pt_, pk), _, _ = case
    np.testing.assert_allclose(pt_, jt, **TEXP_TOL)
    np.testing.assert_allclose(pk, jk, **KEXP_TOL)
    assert pt_.sum(axis=(1, 2)).min() > 50 and np.abs(jk).max() > 1.0


def test_aligner_expect_matches_jax_xla_core(case):
    """HopperAligner.expect on CPU tensors (the kernels' twins, kexp by
    ``kexp_by_kmer`` over the (path, position) k-mer ids) against the JAX
    XLA core: texp and, under Gaussian emissions, kexp; zero kexp under
    HDP (the TPU kernel's contract); the twins' totals."""
    mode, (jt, jk), _, aligner, tf = case
    for i, r in enumerate(aligner):
        assert r["total_f"] == pytest.approx(float(tf[i]), abs=1e-9)
        np.testing.assert_allclose(r["texp"], jt[i], **TEXP_TOL)
        if mode == "gauss":
            np.testing.assert_allclose(r["kexp"], jk[i], **KEXP_TOL)
        else:
            assert not np.any(r["kexp"])


def test_expectation_sums_keep_the_path_axis():
    """``expectation_sums`` returns kx (B, 3, P, LX): its Σp over every
    path and position is the into-match transitions' sum, and
    ``kexp_by_kmer`` over (B, P, LX) ids equals numpy's add.at."""
    jm = _jax_model("ACGT")
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), size=60))
    seq = seq[:20] + "Y" + seq[21:40] + "Y" + seq[41:]
    ids = jm.alphabet.seq_to_kmer_ids(seq.replace("Y", "C"))
    ev = np.stack([jm.level_mean[ids] + rng.normal(0, 1.5, len(ids)),
                   np.ones(len(ids)), np.full(len(ids), .005),
                   np.arange(len(ids)) * .005], 1)
    p = problem_from_numpy(jbfb.prepare_problem(
        seq, ev, jm, ScalingParams(), DEFAULT_AMBIG_BASES, W=32, Dpad=160,
        P=2, anchor_pairs=[(j, j) for j in range(8, 50, 12)], expansion=8))
    pt = problem_tensors([p], 32, CPU, kmer_ids=True)
    f = bfb.sweep_forward(pt, store_full=True)
    b = bfb.sweep_backward(pt, store_full=True)
    fo, tf = bfb.forward_offsets(f[1], f[2], pt.meta[:, bfb.M_NDIAG])
    bo, _ = bfb.backward_offsets(b[1], b[2])
    texp, kx = bfb.expectation_sums(pt, f[0], b[0],
                                    *bfb.expect_cvecs(fo - tf[:, None], bo))
    assert kx.shape == (1, 3, 2, pt.ref.shape[-1])
    assert torch.allclose(kx[:, 0].sum((1, 2)), texp[:, 2:5].sum(1),
                          rtol=1e-6)
    assert kx[0, 0, 1].sum() > 0
    K = jm.alphabet.num_kmers
    want = np.zeros((3, K))
    for r in range(3):
        np.add.at(want[r], pt.kid[0].numpy().reshape(-1),
                  kx[0, r].numpy().reshape(-1))
    np.testing.assert_allclose(bfb.kexp_by_kmer(kx, pt.kid, K)[0].numpy(),
                               want, rtol=1e-12)
