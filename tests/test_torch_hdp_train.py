"""The port's HDP trainer and training-data helpers against the JAX
package's on the CPU: ``build_topology`` for every registered HDP type,
the native Gibbs sampler (the same C++ source, built by each package's
``utils.native``) on the same data and seed, ``train_hdp_from_alignment``
writing the same ``.nhdp`` bytes, the port's ``load_nhdp`` reading it
back, the four helpers of ``pipeline.train`` on the same inputs, and a
failed native build raising with the compiler's message. Every
comparison here is exact: the two sides run the same formulas in
float64 and the same compiled sampler."""

import os
import types

import numpy as np
import pytest

from signalalign_tpu.hdp import train as jax_hdp_train
from signalalign_tpu.models import hdp_model as jax_hdp_model
from signalalign_tpu.models.pore_model import PoreModel as JPoreModel
from signalalign_tpu.pipeline import train as jax_train
from signalalign_tpu_torch.convert import pore_model_from_numpy
from signalalign_tpu_torch.hdp import train as hdp_train
from signalalign_tpu_torch.models import hdp_model
from signalalign_tpu_torch.models.pore_model import ScalingParams
from signalalign_tpu_torch.pipeline import train as port_train
from signalalign_tpu_torch.utils import native
from signalalign_tpu_torch.utils.alphabet import Alphabet
from signalalign_tpu_torch.utils.synthetic import synthetic_pore_model

# k-mer length of the topology cases: small enough for the 21-letter
# alphabets (21^3 = 9,261 leaves)
TOPO_K = 3


@pytest.mark.parametrize("hdp_type", sorted(hdp_train.HDP_TYPE_REGISTRY))
def test_build_topology_matches_jax(hdp_type):
    """The DP tree of every registered type (leaf parents, gammas, the
    per-depth gamma vector) equals the JAX package's, on the type's own
    alphabet."""
    assert hdp_train.HDP_TYPE_REGISTRY == jax_hdp_train.HDP_TYPE_REGISTRY
    got = hdp_train.build_topology(
        hdp_train.hdp_type_alphabet(hdp_type, TOPO_K), hdp_type, 5.0, 2.0, 0.5)
    want = jax_hdp_train.build_topology(
        jax_hdp_train.hdp_type_alphabet(hdp_type, TOPO_K), hdp_type, 5.0,
        2.0, 0.5)
    assert got.num_leaves == want.num_leaves
    assert np.array_equal(got.parent, want.parent)
    assert np.array_equal(got.gamma, want.gamma)
    assert np.array_equal(hdp_train.depth_gamma_vector(got),
                          jax_hdp_train.depth_gamma_vector(want))


def _assignments(alphabet_letters="ACGT", k=3, n=400, seed=3):
    """n (k-mer, value) observations over the first 20 k-mers of the
    alphabet, each k-mer's values around its own mean."""
    rng = np.random.default_rng(seed)
    a = Alphabet(alphabet_letters, k)
    kid = rng.integers(0, 20, size=n)
    return a, kid, 60.0 + 2.0 * kid + rng.normal(0.0, 1.5, size=n)


@pytest.mark.parametrize("prior", [False, True], ids=["fixed", "prior"])
def test_gibbs_train_matches_jax_bit_for_bit(prior):
    """The native sampler on the same data, tree, grid and seed gives the
    same densities, observed flags, gammas, auxiliary variables and final
    seating in both packages (Prior: per-depth gamma resampling)."""
    a, kid, data = _assignments()
    topo = hdp_train.build_topology(a, "multisetPrior" if prior
                                    else "multisetFixed", 5.0, 2.0, 0.5)
    grid = np.linspace(40.0, 120.0, 80)
    nig = hdp_train.nig_params_from_data(data)
    assert nig == jax_hdp_train.nig_params_from_data(data)
    kw = dict(burn_in=3000, num_samples=8, thinning=20, seed=7,
              sample_gamma=prior)
    if prior:
        kw.update(gamma_alpha=np.ones(3), gamma_beta=np.full(3, 2.0))
    got = hdp_train.gibbs_train(data, kid, topo, grid, nig, **kw)
    want = jax_hdp_train.gibbs_train(data, kid, topo, grid, nig, **kw)
    assert got.observed.sum() > 20
    for name in ("densities", "observed", "gamma", "w_aux", "s_aux",
                 "data_table", "table_dp", "table_parent"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A buildAlignment.tsv of 6-mer ACEGOT observations (canonical and
    E-labelled k-mers, another strand's rows among them), trained by both
    packages into .nhdp files: (port path, JAX path, table path)."""
    d = tmp_path_factory.mktemp("hdp")
    rng = np.random.default_rng(11)
    a = Alphabet("ACEGOT", 6)
    kmers = [a.index_to_kmer(int(i)) for i in rng.integers(0, a.num_kmers,
                                                           size=40)]
    kmers += [k[:2] + "EG" + k[4:] for k in kmers[:10]]
    table = d / "buildAlignment.tsv"
    with open(table, "w") as fh:
        for i, k in enumerate(kmers):
            for v in 70.0 + i + rng.normal(0.0, 1.5, size=6):
                fh.write(f"{k}\t{'tc'[i % 7 == 6]}\t{v:f}\n")
    pm = synthetic_pore_model(0, "ACEGOT", 6)
    jm = JPoreModel("ACEGOT", 6)
    kw = dict(hdp_type="singleLevelFixed", grid_length=120, gibbs_samples=10,
              burn_in=2, thinning=10)
    got = hdp_train.train_hdp_from_alignment(str(table), pm,
                                             out_path=str(d / "port.nhdp"),
                                             **kw)
    want = jax_hdp_train.train_hdp_from_alignment(
        str(table), jm, out_path=str(d / "jax.nhdp"), **kw)
    return got, want, table


def test_train_hdp_from_alignment_writes_the_jax_file(trained):
    """The whole trainer (topology, base, burn-in from the multiplier,
    Gibbs, slopes, the reference layout with its factor tree) writes the
    JAX package's .nhdp byte for byte."""
    got, want, _ = trained
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_port_load_nhdp_reads_the_trained_file(trained):
    """The port's load_nhdp reads the trained file as the JAX loader does:
    alphabet, grid, observed k-mers (E ones among them) and the resolved
    density and slope tables."""
    got, want, _ = trained
    p = hdp_model.load_nhdp(got)
    j = jax_hdp_model.load_nhdp(want)
    assert p.alphabet.letters == "ACEGOT" and p.alphabet.kmer_length == 6
    assert np.array_equal(p.grid, j.grid) and len(p.grid) == 120
    assert np.array_equal(p.observed, j.observed)
    assert np.array_equal(p.densities, j.densities)
    assert np.array_equal(p.slopes, j.slopes)
    e_obs = [k for k in np.flatnonzero(p.observed)
             if "E" in p.alphabet.index_to_kmer(int(k))]
    assert len(e_obs) >= 5


def _results(model, seed=4):
    """Alignment results as the helpers read them: a read's pairs
    (posterior x 1e7, x, y, k-mer), its events, event offset and scaling."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        n = 60
        kmers = [model.alphabet.index_to_kmer(int(k))
                 for k in rng.integers(0, 16, size=n)]
        pairs = [(int(p), x, y, km) for p, x, y, km in zip(
            rng.integers(0, 10_000_001, size=n), range(n), range(n), kmers)]
        events = np.stack([rng.uniform(60, 120, n + 5), np.ones(n + 5)], 1)
        out.append(types.SimpleNamespace(
            aligned_pairs=pairs, events=events, event_offset=5 if i else 0,
            params=ScalingParams(shift=0.5 * i, scale=1.0 + 0.01 * i,
                                 var=1.0 + 0.1 * i)))
    return out


def test_training_data_helpers_match_jax(tmp_path):
    """collect_kmer_observations (threshold, top-N), train_gaussian_emissions
    (mean and median estimators, min sd, mod_only), write_hdp_training_file
    and build_alignment_from_tsvs (full and assignments tables) give the
    JAX package's results on the same inputs."""
    jm = JPoreModel("ACEGT", 5)
    src = synthetic_pore_model(0, "ACEGT", 5)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    pm = pore_model_from_numpy(jm)
    res = _results(pm)
    for kw in ({}, {"threshold": 0.4, "max_per_kmer": 3}):
        got = port_train.collect_kmer_observations(res, pm, **kw)
        want = jax_train.collect_kmer_observations(res, jm, **kw)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in got)
    obs = port_train.collect_kmer_observations(res, pm)
    obs["AACEG"] = np.array([90.0, 91.5, 88.0])
    for kw in ({}, {"use_median": True, "min_sd": 1.2},
               {"prior_weight": 5.0, "mod_only": True}):
        got = port_train.train_gaussian_emissions(obs, pm, **kw)
        want = jax_train.train_gaussian_emissions(obs, jm, **kw)
        assert np.array_equal(got.level_mean, want.level_mean)
        assert np.array_equal(got.level_sd, want.level_sd)
    paths = [port_train.write_hdp_training_file(obs, str(tmp_path / "p.tsv")),
             jax_train.write_hdp_training_file(obs, str(tmp_path / "j.tsv"))]
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1] and len(texts[0].splitlines()) > 100
    # a full-format table (16 columns: strand 4, posterior 12, descaled
    # mean 13, k-mer 15) and an assignments table (k-mer, strand,
    # descaled mean, posterior)
    rng = np.random.default_rng(8)
    full, assign = tmp_path / "a.sm.forward.tsv", tmp_path / "a.assign.tsv"
    with open(full, "w") as fh, open(assign, "w") as fa:
        for i in range(300):
            k = pm.alphabet.index_to_kmer(int(rng.integers(0, 30)))
            s, p, v = "tc"[i % 5 == 4], rng.uniform(0.5, 1.0), rng.normal(90, 5)
            cols = ["0"] * 16
            cols[4], cols[12], cols[13], cols[15] = s, f"{p:f}", f"{v:f}", k
            fh.write("\t".join(cols) + "\n")
            fa.write(f"{k}\t{s}\t{v:f}\t{p:f}\n")
    for tsv, kw in ((full, {}), (assign, {"full": False, "strands": ("t", "c"),
                                          "max_per_kmer": 4})):
        outs = [f(tsv_paths=[str(tsv)], model=m, out_path=str(tmp_path / n),
                  **kw)
                for f, m, n in ((port_train.build_alignment_from_tsvs, pm, "p"),
                                (jax_train.build_alignment_from_tsvs, jm, "j"))]
        texts = [open(p).read() for p in outs]
        assert texts[0] == texts[1] and texts[0]


def test_failed_native_build_raises_with_the_compiler_message(
        tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError carrying g++'s
    message from the loader; nothing falls back and no library is left
    behind. The real library then builds and loads."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.load()
    assert not os.path.exists(native.library_path())
    monkeypatch.undo()
    assert native.load().sa_hdp_gibbs is not None
