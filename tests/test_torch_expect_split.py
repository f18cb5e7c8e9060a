"""The split expectation route of the P > 2 register instances' buckets
against the JAX package's XLA expectation core on the CPU.

On such a bucket (``banded_fb_hopper.expect_split``: past the per-pair
instances, up to 8,192 cells a diagonal) the backward's expectation pass
stores its three-state stack (``backward_sweep_stack``) and
``expect_sums`` sums texp and kx from both stacks; on CPU tensors each is
its plain twin (the backward with ``store_full``, then
``bfb.expectation_sums``). Both are held here against the JAX
``_expectations_core`` (``expectations_batched``) on the same stacks,
Gaussian and HDP at P = 3 (32 % P != 0: the backward's ``__syncthreads``
branch on the card) and P = 8, and Gaussian at P = 64 (two legality
words a mask). kx is
compared position by position: the JAX core gets one k-mer id per (path,
position), so its kexp is kx. Under HDP the split route returns zero kx
(the TPU kernel's contract) and the moments are held through
``bfb.expectation_sums(moments=True)``, keyed by the real k-mers as the
XLA core keys them. The JAX core runs once per emission mode, on every
case of that mode at once, shape-padded to its largest P. Then the
runner's chunks: an expectation bucket of the split route keeps as many
problems a chunk, and two stacks.

Tolerances are those of ``tests/test_torch_expect_paths.py`` (the JAX
package's own Pallas-vs-XLA expectation tests): texp rtol 2e-4 / atol
5e-3, kx and kexp rtol 2e-3 / atol 5e-3; the JAX core sums in float32,
the port in float64."""

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
from signalalign_tpu_torch.pipeline import runner
from signalalign_tpu_torch.utils.synthetic import (synthetic_hdp,
                                                   synthetic_pore_model,
                                                   write_nhdp_text)

CPU = torch.device("cpu")
THR = 0.01
TEXP_TOL = dict(rtol=2e-4, atol=5e-3)
KX_TOL = dict(rtol=2e-3, atol=5e-3)
W, DPAD = 32, 240
# (emission mode, P, bases per segment); the code (its reading in the
# events) and the cluster of codes in one 5-mer that gives P paths
CASES = [("gauss", 3, 80), ("hdp", 3, 80), ("gauss", 8, 60), ("hdp", 8, 60),
         ("gauss", 64, 40)]
CLUSTERS = {3: ("B", "B"), 8: ("P", "PGPGP"), 64: ("X", "XGXGX")}


def _jax_model(alphabet):
    jm = JPoreModel(alphabet, 5)
    src = synthetic_pore_model(0, alphabet, 5)
    for name in ("level_mean", "level_sd", "noise_mean", "noise_sd",
                 "noise_lambda"):
        setattr(jm, name, getattr(src, name))
    return jm


def _pad(x, D, fill, P=None):
    """(B, D1, ...) tensor -> (B, D, ...) numpy, rows past D1 ``fill``;
    with ``P`` a (B, D1, 3, p, W) stack's paths padded to P with
    ``fill`` too."""
    x = x.numpy()
    shape = (x.shape[0], D) + x.shape[2:]
    if P is not None:
        shape = shape[:3] + (P,) + shape[4:]
    out = np.full(shape, fill, x.dtype)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _segments(jm, P, L, hdp):
    """Two seeded segments of L bases and their events: the code every
    12 positions (a lone code gives 2 or 3 paths) and one cluster of
    codes inside a 5-mer (P paths); events follow the code's first
    reading."""
    code, cluster = CLUSTERS[P]
    read_as = DEFAULT_AMBIG_BASES[code][0]
    rng = np.random.default_rng(40 + P + 10 * hdp)
    out = []
    for i in range(2):
        seq = list(rng.choice(list("ACGT"), size=L))
        for j in range(6 + i, L - 6, 12):
            if not 20 <= j <= 38:     # clear of the cluster's k-mers
                seq[j] = code
        seq[26:26 + len(cluster)] = cluster
        seq = "".join(seq)
        ids = jm.alphabet.seq_to_kmer_ids(seq.replace(code, read_as))
        ev = np.stack([jm.level_mean[ids] + rng.normal(0, 1.5, len(ids)),
                       np.ones(len(ids)), np.full(len(ids), .005),
                       np.arange(len(ids)) * .005], 1)
        out.append((seq, ev, i))
    return out


def _run_mode(mode, tmp_path_factory):
    """{P: (the port's tensors, the split route's (texp, kx), the JAX
    core's (texp, kexp by (path, position)) and, keyed by k-mer, the
    port's and the JAX core's moments)} for every case of one emission
    mode, on a 5-mer ACEGT model. The port runs each case at its own P;
    the JAX core runs all of them in one call, their problems prepared at
    the mode's largest P and the port's stacks padded to it (the padded
    paths illegal and NEG, so they add nothing)."""
    hdp = mode == "hdp"
    jm = _jax_model("ACEGT")
    jh = tables = None
    if hdp:
        path = str(tmp_path_factory.mktemp("hdp") / "m.nhdp")
        write_nhdp_text(synthetic_hdp(pore_model_from_numpy(jm), 1,
                                      grid_length=121), path)
        jh = jax_hdp_model.load_nhdp(path)
    cases = [(P, L) for m, P, L in CASES if m == mode]
    Ppad = max(P for P, _ in cases)

    def prep(seq, ev, i, P):
        return jbfb.prepare_problem(
            seq, ev, jm, ScalingParams(shift=0.2 * i, var=1.0 + 0.05 * i),
            DEFAULT_AMBIG_BASES, W=W, Dpad=DPAD, P=P,
            anchor_pairs=[(j, j) for j in range(8, len(ev) - 8, 15)],
            expansion=8, mode=bfb.MODE_HDP if hdp else bfb.MODE_MEAN_ONLY,
            hdp=jh)

    ports, jpad, stacks = {}, [], []
    for P, L in cases:
        segs = _segments(jm, P, L, hdp)
        jp = [prep(*sg, P) for sg in segs]
        jpad += [prep(*sg, Ppad) for sg in segs]
        assert max(int(p.n_paths.max()) for p in jp) == P
        tp = [problem_from_numpy(p) for p in jp]
        if hdp:
            tables = hdp_tables(tp[0].hdp_dens, tp[0].hdp_slopes,
                                *tp[0].hdp_grid, CPU)
        pt = problem_tensors(tp, W, CPU, tables, kmer_ids=True)
        nds = pt.meta[:, bfb.M_NDIAG]
        # the split route: the backward keeping its stack, then the sums
        f, fi, lf = hk.forward_sweep(pt, expect=True)
        fo, tf = bfb.forward_offsets(fi, lf, nds)
        cvecf = fo - tf[:, None]
        R = hk.survivor_slots(THR)
        out = hk.backward_sweep_stack(pt, f, cvecf, THR, R)
        b = out[5]
        bo, _ = bfb.backward_offsets(out[0], out[1])
        split = hk.expect_sums(pt, f, b, cvecf, bo)
        c1, c2 = bfb.expect_cvecs(cvecf, bo)
        stacks.append([_pad(f, DPAD, bfb.NEG, Ppad),
                       _pad(b, DPAD, bfb.NEG, Ppad),
                       _pad(c1, DPAD, 0.0).astype(np.float32),
                       _pad(c2, DPAD, 0.0).astype(np.float32)])
        moments = None
        if hdp:
            _, kx_all = bfb.expectation_sums(pt, f, b, c1, c2, moments=True)
            moments = bfb.kexp_by_kmer(kx_all, pt.kid,
                                       jp[0].num_kmers).numpy()
        ports[P] = (pt, (split[0].numpy(), split[1].numpy()), moments)

    args = jax_stack_problems(jpad)
    eargs = [jnp.asarray(np.concatenate(z)) for z in zip(*stacks)]
    eargs += [args[i] for i in (0, 1, 2, 3, 4, 5, 8, 10, 11, 12)]
    kid = np.asarray(jax_stack_kmer_ids(jpad))
    B, _, LX = kid.shape
    if hdp:
        # the k-mer ids key the HDP emissions too: kexp by k-mer
        K = jpad[0].num_kmers
        eargs += [jnp.asarray(kid), jnp.asarray(jpad[0].hdp_dens),
                  jnp.asarray(jpad[0].hdp_slopes),
                  jnp.asarray(jpad[0].hdp_grid)]
    else:
        # one id per (path, position): kexp is kx
        K = Ppad * LX
        cells = np.arange(K, dtype=np.int32).reshape(1, Ppad, LX)
        eargs.append(jnp.asarray(np.repeat(cells, B, axis=0)))
    texp, _, kexp = jbfb.expectations_batched(*eargs, W=W, P=Ppad,
                                              mode=jpad[0].mode, num_kmers=K)
    texp = np.asarray(texp, np.float64)
    kexp = np.asarray(kexp, np.float64)
    if not hdp:
        kexp = kexp.reshape(B, 3, Ppad, LX)
    runs = {}
    for n, (P, _) in enumerate(cases):
        pt, split, moments = ports[P]
        rows = slice(2 * n, 2 * n + 2)
        jk = kexp[rows]
        if not hdp:
            jk = jk[:, :, :P, :pt.ref.shape[-1]]
        runs[P] = (pt, split, (texp[rows], jk), moments)
    return runs


@pytest.fixture(scope="module")
def one_thread():
    """Torch on one thread: these tensors are too small for more to help,
    and the spare threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """``_run_mode`` of each emission mode, made on first use."""
    done = {}

    def get(mode):
        if mode not in done:
            done[mode] = _run_mode(mode, tmp_path_factory)
        return done[mode]
    return get


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}_p{P}" for m, P, _ in CASES])
def case(request, runs):
    """(mode, the port's tensors, the split route's (texp, kx), the JAX
    core's (texp, kexp by (path, position)) and, under HDP, the port's
    moments by k-mer) of one case."""
    mode, P, _ = request.param
    return (mode,) + runs(mode)[P]


def test_split_route_matches_jax_xla_core(case):
    """texp of the split route against the JAX XLA core (summed over every
    legal (source, target) path pair there too); kx position by position
    under Gaussian emissions; under HDP kx zero and the moments of
    ``expectation_sums`` by k-mer against the XLA core's."""
    mode, pt, (texp7, kx), (jt, jk), moments = case
    np.testing.assert_allclose(bfb.texp_matrix(torch.from_numpy(texp7))
                               .numpy(), jt, **TEXP_TOL)
    assert texp7.sum(axis=1).min() > 30
    if mode == "gauss":
        np.testing.assert_allclose(kx, jk, **KX_TOL)
        # the moments reach more than one path
        assert np.abs(kx).max() > 1.0
        assert (kx[:, 0].sum(axis=(0, 2)) > 0).sum() > 1
    else:
        assert not kx.any()
        np.testing.assert_allclose(moments, jk, **KX_TOL)
        assert np.abs(jk).max() > 1.0


@pytest.mark.parametrize("W,P,split", [
    (256, 4, True), (256, 8, True), (2304, 1, True), (4096, 2, True),
    (256, 3, True), (128, 64, True), (256, 2, False), (1280, 1, False),
    (256, 64, False), (768, 16, False)])
def test_stack_chunks_count_both_stacks(monkeypatch, W, P, split):
    """An expectation bucket's chunks hold as many problems whether its
    backward keeps its three-state stack too (``split``: a P > 2 register
    instance's bucket, ``banded_fb_hopper.expect_split`` on the card) or
    not: with STACK_BYTES set to three problems' forward stacks, chunks of
    three, as in the pass without expectations at a third of the rows. So
    a chunk of a split bucket holds STACK_BYTES of forward stack and as
    much again of backward stack: at most 16 GiB of the two at the
    default STACK_BYTES."""
    stacks = 2 if split else 1
    assert stacks * runner.STACK_BYTES <= 16 << 30
    Dpad = 2047
    one = (Dpad + 1) * 3 * P * W * 4
    monkeypatch.setattr(runner, "STACK_BYTES", 3 * one)
    chunks = runner._stack_chunks(list(range(8)), W, Dpad, P, 3)
    assert [len(c) for c in chunks] == [3, 3, 2]
    plain = runner._stack_chunks(list(range(24)), W, Dpad, P)
    assert [len(c) for c in plain] == [9, 9, 6]
