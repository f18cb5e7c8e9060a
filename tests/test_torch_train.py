"""The port's EM trainer against the JAX package's on the CPU: two
iterations of unified Gaussian EM (transitions and emissions) on both
packages' ``build_synthetic_batch`` from one seed, the ``.model``
checkpoint and expectations-file round trip, threeStateHdp transition
EM, and the refusals (``cross_host``).

On the CPU the JAX ``em_train`` runs its XLA expectation path (the lane
kernels need a TPU); it sums emission moments in f32 per diagonal where
the port sums in f64, and the two DPs differ by f32 round-off. Measured
on these reads: transitions 1.7e-6 apart, log-likelihoods 0.03 nats of
9,413, level means 8.4e-4 pA, sds 1.1e-3 pA after two iterations (the
second iteration starts from the first's slightly different model). The
tolerances below are a few times those."""

import copy

import numpy as np
import pytest
import torch

from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.pipeline.signal_align import \
    AlignmentConfig as JaxAlignmentConfig
from signalalign_tpu.pipeline.train import em_train as jax_em_train
from signalalign_tpu.utils.synthetic import \
    build_synthetic_batch as jax_build_synthetic_batch
from signalalign_tpu_torch.convert import hdp_from_numpy, pore_model_from_numpy
from signalalign_tpu_torch.models.expectations import ExpectationsAccumulator
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.ops.banded_fb import MODE_HDP
from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
from signalalign_tpu_torch.pipeline.train import (em_train,
                                                  em_train_transitions,
                                                  normalize_transitions_expectations)
from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                   synthetic_hdp,
                                                   synthetic_pore_model,
                                                   write_nhdp_text)

CPU = torch.device("cpu")
TOL_TRANS = 1e-5        # transition probabilities, absolute
TOL_LL = 0.2            # log-likelihood, nats
TOL_LEVEL = 5e-3        # level means and sds, pA
EM_KW = dict(iterations=2, update_transitions=True, update_emissions=True,
             emission_prior_weight=5.0)


def _models(alphabet="ACGT", k=5):
    """The JAX package's PoreModel with synthetic_pore_model's tables, and
    the port's copy of it (convert.pore_model_from_numpy)."""
    jm = JPoreModel(alphabet, k)
    src = synthetic_pore_model(0, alphabet, k)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm, pore_model_from_numpy(jm)


def _reads(jm, pm, fasta):
    """Both packages' build_synthetic_batch from one seed (4 reads of
    300-900 events): (JAX reads, reference), (the port's)."""
    kw = dict(n_reads=4, ev_min=300, ev_max=900, seed=5, genome_len=20_000,
              fasta_path=fasta)
    j = jax_build_synthetic_batch(jm, **kw)
    p = build_synthetic_batch(pm, **kw)
    for (jr, _), (pr, _) in zip(j[0], p[0]):
        assert np.array_equal(jr.events, pr.events)
    return (j[0], j[1]), (p[0], p[1])


@pytest.fixture(scope="module")
def gaussian(tmp_path_factory):
    """Reads generated from the true model; the model both trainers start
    from has its level means moved by zero-mean N(0, 1.5 pA) noise
    (default_rng(99)), the JAX package's own EM test construction. Runs
    both em_train's for two iterations. Returns (true JAX model, start
    port model, JAX result, port result, port reads, port reference)."""
    jm, pm = _models()
    jr, pr = _reads(jm, pm, str(tmp_path_factory.mktemp("g") / "genome.fa"))
    start = copy.deepcopy(jm)
    start.level_mean = start.level_mean + np.random.default_rng(99).normal(
        0.0, 1.5, size=start.level_mean.shape)
    start_p = pore_model_from_numpy(start)
    want = jax_em_train(*jr, start, config=JaxAlignmentConfig(), **EM_KW)
    got = em_train(*pr, start_p, config=AlignmentConfig(), device=CPU,
                   **EM_KW)
    return jm, start_p, want, got, pr[0], pr[1]


def test_em_train_matches_jax(gaussian):
    """Two iterations of unified EM: the transitions, log-likelihoods,
    reference-style likelihoods, level means and sds of every iteration
    agree with the JAX em_train within the module's tolerances."""
    _, _, want, got, _, _ = gaussian
    assert len(got.log_likelihoods) == len(want.log_likelihoods) == 2
    for a, b in zip(got.transitions_history, want.transitions_history):
        np.testing.assert_allclose(a, b, atol=TOL_TRANS, rtol=0)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                               atol=TOL_LL, rtol=0)
    np.testing.assert_allclose(got.likelihoods, want.likelihoods, rtol=1e-5)
    for a, b in zip(got.kexp_history, want.kexp_history):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=0.2)
    np.testing.assert_allclose(got.model.level_mean, want.model.level_mean,
                               atol=TOL_LEVEL, rtol=0)
    np.testing.assert_allclose(got.model.level_sd, want.model.level_sd,
                               atol=TOL_LEVEL, rtol=0)
    np.testing.assert_allclose(got.model.transitions, want.model.transitions,
                               atol=TOL_TRANS, rtol=0)


def test_em_train_learns(gaussian):
    """The likelihood rises, every transition row sums to 1, and the level
    means of k-mers observed with Σp > 3 that started more than 0.75 pA
    off move toward the generating model on average."""
    jm, start, _, got, _, _ = gaussian
    assert got.log_likelihoods[-1] > got.log_likelihoods[0]
    for probs in got.transitions_history:
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-9)
    err0 = np.abs(start.level_mean - jm.level_mean)
    heavy = np.flatnonzero((got.kexp_history[0][0] > 3.0) & (err0 > 0.75))
    assert len(heavy) >= 10
    after = np.abs(got.model.level_mean[heavy] - jm.level_mean[heavy])
    assert after.mean() < err0[heavy].mean()


def test_checkpoint_and_expectations_round_trip(gaussian, tmp_path):
    """One pure-normalize iteration with checkpoints: the expectations
    file reproduces the checkpoint through ExpectationsAccumulator (atol
    1e-4) at every k-mer with Σp >= 1e-3; the file's 9 decimals cannot
    carry the mean of a k-mer observed with Σp near the 1e-6 cut (Σp
    1.2e-6 is written to 4e-4 relative), so those may differ more. The
    .model file reads back exactly, and the port writes the same .model
    bytes as the JAX package."""
    _, start, _, _, rgs, ref = gaussian
    res = em_train(rgs, ref, start, iterations=1, config=AlignmentConfig(),
                   update_transitions=True, update_emissions=True,
                   checkpoint_dir=str(tmp_path), checkpoint_prefix="pure",
                   write_expectations=True, device=CPU)
    assert len(res.expectations_files) == len(res.checkpoint_files) == 1
    acc = ExpectationsAccumulator(copy.deepcopy(start))
    assert acc.add_file(res.expectations_files[0])
    m2 = acc.apply(update_transitions=True, update_emissions=True)
    ck = PoreModel.from_file(res.checkpoint_files[0])
    sp = res.kexp_history[0][0]
    well = sp >= 1e-3
    assert well.sum() > 500
    np.testing.assert_allclose(m2.level_mean[well], ck.level_mean[well],
                               atol=1e-4)
    np.testing.assert_allclose(m2.level_sd[well], ck.level_sd[well],
                               atol=1e-4)
    off = (np.abs(m2.level_mean - ck.level_mean) > 1e-4) \
        | (np.abs(m2.level_sd - ck.level_sd) > 1e-4)
    assert (sp[off] < 1e-3).all()
    np.testing.assert_allclose(m2.transitions, ck.transitions, atol=1e-6)
    for name in ("transitions", "level_mean", "level_sd", "noise_mean",
                 "noise_sd", "noise_lambda"):
        assert np.array_equal(getattr(ck, name), getattr(res.model, name))
    assert ck.likelihood == res.model.likelihood
    jax_copy = JPoreModel.from_file(res.checkpoint_files[0])
    jax_copy.write(str(tmp_path / "jax.model"))
    with open(res.checkpoint_files[0]) as a, open(tmp_path / "jax.model") as b:
        assert a.read() == b.read()


def test_hdp_transition_em(tmp_path):
    """threeStateHdp transition EM (MODE_HDP, one iteration) on the port
    and the JAX package: finite likelihoods, rows summing to 1, the port's
    kexp zero (the JAX CPU path's XLA core computes moments there too,
    see test_torch_expectations), totals above log 0, and the transitions
    within TOL_TRANS of the JAX ones."""
    jm, pm = _models("ACEGT")
    path = write_nhdp_text(synthetic_hdp(pm, 1, grid_length=121),
                           str(tmp_path / "m.nhdp"))
    jh = jax_hdp_model.load_nhdp(path)
    jr, pr = _reads(jm, pm, str(tmp_path / "g.fa"))
    kw = dict(iterations=1, update_transitions=True)
    want = jax_em_train(jr[0][:2], jr[1], jm, hdp=jh,
                        config=JaxAlignmentConfig(emission_mode=MODE_HDP),
                        **kw)
    got = em_train(pr[0][:2], pr[1], pm, hdp=hdp_from_numpy(jh),
                   config=AlignmentConfig(emission_mode=MODE_HDP),
                   device=CPU, **kw)
    assert np.isfinite(got.log_likelihoods[0])
    assert got.log_likelihoods[0] > -1e29
    assert not got.kexp_history[0].any()
    np.testing.assert_allclose(got.transitions_history[0].sum(axis=1), 1.0,
                               rtol=1e-9)
    np.testing.assert_allclose(got.transitions_history[0],
                               want.transitions_history[0], atol=TOL_TRANS,
                               rtol=0)
    np.testing.assert_allclose(got.log_likelihoods, want.log_likelihoods,
                               atol=TOL_LL, rtol=0)


def test_refusals_and_transition_wrapper(gaussian):
    """cross_host raises naming its ROADMAP slice; em_train_transitions
    is em_train with the emissions left alone; the M-step of an empty
    row leaves it zero."""
    _, start, _, _, rgs, ref = gaussian
    with pytest.raises(NotImplementedError, match="slice 4"):
        em_train(rgs, ref, start, iterations=1, cross_host=True, device=CPU)
    res = em_train_transitions(rgs[:1], ref, start, iterations=1,
                               device=CPU)
    assert np.array_equal(res.model.level_mean, start.level_mean)
    np.testing.assert_allclose(res.transitions_history[0].sum(axis=1), 1.0)
    t = normalize_transitions_expectations(np.array(
        [[2.0, 1.0, 1.0], [0.0, 0.0, 0.0], [1.0, 0.0, 3.0]]))
    np.testing.assert_allclose(t, [[0.5, 0.25, 0.25], [0, 0, 0],
                                   [0.25, 0, 0.75]])
