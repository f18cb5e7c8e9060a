"""The port's plain sweeps past 8,192 cells a diagonal (the twins of the
Hopper kernels' wide instance) against the JAX package's sweep core on
the CPU, on a seeded P = 16 segment at W = 520. Kept in a file of its own
so that the test runner can give it a worker of its own: it takes minutes
on the CPU."""

import numpy as np
import torch

from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.models.pore_model import ScalingParams
from signalalign_tpu.ops import banded_fb as jbfb
from signalalign_tpu.ops.batch import stack_problems
from signalalign_tpu.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_tpu_torch.convert import (pore_model_from_numpy,
                                           problem_from_numpy, problem_tensors)
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.utils.synthetic import synthetic_pore_model

CPU = torch.device("cpu")


def _models(seed=0, alphabet="ACGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = JPoreModel(alphabet, k)
    src = synthetic_pore_model(seed, alphabet, k)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm, pore_model_from_numpy(jm)


MODEL = _models()[0]


def _wide_args(seed=500):
    """(args, kwargs) of prepare_problem for a P = 16 segment at W = 520
    (8,320 cells a diagonal, past the 8,192 the kernels hold in
    registers): 180 bases with a Y every 25 positions and one YYGYY
    cluster, events drawn from a resolved sequence, anchors every 15
    events but for events 30-140, over which the band bulges (as
    chip_smoke.py's wide_p1_problems widens its bands)."""
    rng = np.random.default_rng(seed)
    seq = list(rng.choice(list("ACGT"), size=180))
    for j in range(8, 172, 25):
        seq[j] = "Y"
    seq[88:93] = "YYGYY"
    seq = "".join(seq)
    resolved = "".join(rng.choice(["C", "T"]) if c == "Y" else c for c in seq)
    ids = MODEL.alphabet.seq_to_kmer_ids(resolved)
    ev = np.stack([MODEL.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                   np.ones(len(ids)), np.full(len(ids), .005),
                   np.arange(len(ids)) * .005], 1)
    anchors = [(j, j) for j in range(8, len(ids) - 8, 15)
               if not 30 < j < 140]
    return ((seq, ev, MODEL, ScalingParams(), DEFAULT_AMBIG_BASES),
            dict(W=520, Dpad=384, P=16, mode=bfb.MODE_MEAN_ONLY,
                 anchor_pairs=anchors, expansion=8))


def test_sweeps_past_8192_cells_match_jax_core():
    """The plain sweeps (the wide instance's twins) on a P = 16 segment
    at W = 520 with a widened band, against the JAX _banded_sweeps_core,
    with test_sweeps_match_jax_core's tolerances: normalised rows within
    1e-4 on the probability scale, offsets within 1e-3 nats, totals
    within 5e-3 nats."""
    args, kw = _wide_args()
    jp = jbfb.prepare_problem(*args, **kw)
    assert int(jp.n_paths.max()) == 16 and int(jp.width.max()) > 100
    fj, fij, lfj, bj, bij, lbj = (np.asarray(a) for a in
                                  jbfb.banded_sweeps_batched(
                                      *stack_problems([jp]), W=520, P=16,
                                      mode=bfb.MODE_MEAN_ONLY,
                                      store_full=False))
    pt = problem_tensors([problem_from_numpy(jp)], 520, CPU)
    assert pt.P * pt.W > 8192
    ft, fit, lft = bfb.sweep_forward(pt)
    bt, bit, lbt = bfb.sweep_backward(pt)
    _, tf = bfb.forward_offsets(fit, lft, pt.meta[:, bfb.M_NDIAG])
    _, tb = bfb.backward_offsets(bit, lbt)
    n = jp.n_diag + 1
    assert np.abs(np.exp(fj[0, :n]) - np.exp(ft[0, :n].numpy())).max() < 1e-4
    assert np.abs(np.exp(bj[0, :n]) - np.exp(bt[0, :n].numpy())).max() < 1e-4
    assert np.abs(fij[0, :n] - fit[0, :n].numpy()).max() < 1e-3
    assert np.abs(bij[0, :n] - bit[0, :n].numpy()).max() < 1e-3
    jtf = float(lfj[0]) + np.cumsum(fij[0].astype(np.float64))[jp.n_diag]
    jtb = float(lbj[0]) + np.sum(bij[0].astype(np.float64))
    assert abs(jtf - float(tf[0])) < 5e-3 and abs(jtb - float(tb[0])) < 5e-3
