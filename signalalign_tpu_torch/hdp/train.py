"""HDP training in the port: topology construction + native Gibbs +
.nhdp output, a copy of ``signalalign_tpu.hdp.train`` (same formulas, the
same seed use, the same file layout, so ``models.hdp_model.load_nhdp``
reads what it writes).

reference: impl/buildHdpUtil.c (CLI), impl/nanopore_hdp.c (topology
factories 506-930, update_nhdp_from_alignment_with_filter:205,
serialize_nhdp:1077), impl/hdp.c (Gibbs + finalization). The sampler runs
in native C++ (the port's copy of csrc/signalalign_native.cpp,
sa_hdp_gibbs, built by ``utils.native``: a Chinese
restaurant franchise over an arbitrary DP tree with NIG base); this module
builds the DP tree for the supported topologies, feeds the assignment
table, and writes a .nhdp loadable by models/hdp_model.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.utils.alphabet import Alphabet
from signalalign_tpu_torch.utils import native


@dataclasses.dataclass
class HdpTopology:
    parent: np.ndarray          # (num_dps,), -1 for the base dp
    gamma: np.ndarray           # (num_dps,)
    num_leaves: int


# The reference's 21 named HDP build types (trainModels.py:574-604 name->id,
# nanopore_hdp.c:1160-1420 id->factory). Each pins an alphabet
# (stateMachine.h:15-33) and a tree shape; "Prior" variants resample the
# per-depth concentration parameters from Gamma(alpha, beta) priors during
# Gibbs (sa_hdp_gibbs sample_gamma path; hdp.c:2165-2291).
HDP_TYPE_REGISTRY: Dict[str, Tuple[str, str]] = {
    "singleLevelFixed": ("ACEGOT", "single"),
    "singleLevelPrior": ("ACEGOT", "single"),
    "multisetFixed": ("ACEGOT", "multiset"),
    "multisetPrior": ("ACEGOT", "multiset"),
    "compFixed": ("ACEGOT", "comp"),
    "compPrior": ("ACEGOT", "comp"),
    "middleNtsFixed": ("ACEGOT", "middleNts"),
    "middleNtsPrior": ("ACEGOT", "middleNts"),
    "groupMultisetFixed": ("ACEGOT", "groupMultiset"),
    "groupMultisetPrior": ("ACEGOT", "groupMultiset"),
    "singleLevelPrior2": ("ACEGT", "single"),
    "multisetPrior2": ("ACEGT", "multiset"),
    "multisetPriorEcoli": ("ACEGIT", "multiset"),
    "singleLevelPriorEcoli": ("ACEGIT", "single"),
    "singleLevelFixedCanonical": ("ACGT", "single"),
    "singleLevelFixedM6A": ("ACFGT", "single"),
    "singleLevelFixedrRNA": ("ACGTbp", "single"),
    "singleLevelAll16SrRNA": ("ACEGTbdehip", "single"),
    "singleLevelYeast": ("ACGTabcdefghijklm", "single"),
    "singleLevelYeastAltC": ("ACGTabcdefghijklmnopq", "single"),
    "singleLevelYeastSmall5mer": ("ACGTabc", "single"),
}

# purine/pyrimidine split for comp* (stateMachine.h:32-33) and the ACEGOT
# character grouping for groupMultiset* (nanopore_hdp.c:1378-1380)
PURINES = "AG"
GROUPS_ACEGOT = {"A": 0, "C": 1, "E": 1, "O": 1, "G": 2, "T": 3}


def hdp_type_alphabet(hdp_type: str, kmer_length: int) -> Alphabet:
    letters, _ = HDP_TYPE_REGISTRY[hdp_type]
    return Alphabet(letters, kmer_length)


def build_topology(alphabet: Alphabet, hdp_type: str,
                   base_gamma: float = 1.0, middle_gamma: float = 1.0,
                   leaf_gamma: float = 1.0) -> HdpTopology:
    """DP tree for a named topology (leaf dp id == k-mer rank).

    Tree shapes (reference factories, nanopore_hdp.c:498-1010):
    single: leaves -> base; multiset: leaves -> sorted-multiset dps -> base;
    middleNts: leaves -> middle-2-nt dps -> base; comp: leaves ->
    purine-count dps (k+1) -> base; groupMultiset: leaves -> multiset of
    character-group ids -> base.
    """
    K = alphabet.num_kmers
    kind = HDP_TYPE_REGISTRY.get(hdp_type, (None, None))[1]
    t = hdp_type.lower() if kind is None else kind.lower()
    if "groupmultiset" in t:
        k = alphabet.kmer_length
        msets: Dict[Tuple[int, ...], int] = {}
        leaf_parent = np.zeros(K, dtype=np.int64)
        for kid in range(K):
            key = tuple(sorted(GROUPS_ACEGOT.get(ch, 0)
                               for ch in alphabet.index_to_kmer(kid)))
            if key not in msets:
                msets[key] = len(msets)
            leaf_parent[kid] = K + msets[key]
        n_mid = len(msets)
        num_dps = K + n_mid + 1
        parent = np.full(num_dps, -1, dtype=np.int64)
        parent[:K] = leaf_parent
        parent[K:K + n_mid] = num_dps - 1
        gamma = np.concatenate([
            np.full(K, leaf_gamma), np.full(n_mid, middle_gamma),
            [base_gamma]])
    elif "comp" in t:
        k = alphabet.kmer_length
        n_mid = k + 1
        num_dps = K + n_mid + 1
        parent = np.full(num_dps, -1, dtype=np.int64)
        for kid in range(K):
            n_pur = sum(ch in PURINES for ch in alphabet.index_to_kmer(kid))
            parent[kid] = K + n_pur
        parent[K:K + n_mid] = num_dps - 1
        gamma = np.concatenate([
            np.full(K, leaf_gamma), np.full(n_mid, middle_gamma),
            [base_gamma]])
    elif "multiset" in t:
        msets: Dict[Tuple[str, ...], int] = {}
        leaf_parent = np.zeros(K, dtype=np.int64)
        for kid in range(K):
            key = tuple(sorted(alphabet.index_to_kmer(kid)))
            if key not in msets:
                msets[key] = len(msets)
            leaf_parent[kid] = K + msets[key]
        n_mid = len(msets)
        num_dps = K + n_mid + 1
        parent = np.full(num_dps, -1, dtype=np.int64)
        parent[:K] = leaf_parent
        parent[K:K + n_mid] = num_dps - 1
        gamma = np.concatenate([
            np.full(K, leaf_gamma), np.full(n_mid, middle_gamma),
            [base_gamma]])
    elif "middlents" in t:
        k = alphabet.kmer_length
        a, b = k // 2 - 1, k // 2
        n_mid = alphabet.size ** 2
        num_dps = K + n_mid + 1
        parent = np.full(num_dps, -1, dtype=np.int64)
        for kid in range(K):
            kmer = alphabet.index_to_kmer(kid)
            mid = (alphabet.letters.index(kmer[a]) * alphabet.size
                   + alphabet.letters.index(kmer[b]))
            parent[kid] = K + mid
        parent[K:K + n_mid] = num_dps - 1
        gamma = np.concatenate([
            np.full(K, leaf_gamma), np.full(n_mid, middle_gamma),
            [base_gamma]])
    else:  # singleLevel and anything else
        num_dps = K + 1
        parent = np.full(num_dps, -1, dtype=np.int64)
        parent[:K] = K
        gamma = np.concatenate([np.full(K, leaf_gamma), [base_gamma]])
    return HdpTopology(parent=parent, gamma=gamma.astype(np.float64),
                       num_leaves=K)


def dp_depths(topo: HdpTopology) -> np.ndarray:
    """Depth of each dp (base = 0) from the parent array."""
    n = len(topo.parent)
    depth = np.zeros(n, dtype=np.int64)
    for i in range(n):
        d, p = 0, int(topo.parent[i])
        while p >= 0:
            d += 1
            p = int(topo.parent[p])
        depth[i] = d
    return depth


def depth_gamma_vector(topo: HdpTopology) -> np.ndarray:
    """Per-depth gamma vector in base-to-leaf order.

    All dps at one depth share a gamma in every supported topology
    (reference hdp.c stores gamma indexed by depth); pick the first dp at
    each depth."""
    depth = dp_depths(topo)
    n_levels = int(depth.max()) + 1
    out = np.zeros(n_levels)
    for lvl in range(n_levels):
        out[lvl] = topo.gamma[np.argmax(depth == lvl)]
    return out


def nig_params_from_data(data: np.ndarray) -> Tuple[float, float, float, float]:
    """Empirical normal-inverse-gamma base hyperparameters.

    Mirrors the spirit of buildHdpUtil's data-derived base (mu at the data
    mean, broad variance prior)."""
    mu0 = float(np.mean(data))
    nu = 1.0 / 68.0 * len(data) if len(data) else 1.0
    var = float(np.var(data)) if len(data) > 1 else 4.0
    alpha = 2.0
    beta = var
    return mu0, nu, alpha, beta


@dataclasses.dataclass
class GibbsResult:
    densities: np.ndarray       # (num_dps, grid)
    observed: np.ndarray        # (num_dps,) bool
    gamma: np.ndarray           # (tree_depth,) final per-depth gammas
    w_aux: np.ndarray           # (num_dps,) final auxiliary w
    s_aux: np.ndarray           # (num_dps,) final auxiliary s
    # final CRF seating (for reference-layout factor-tree serialization)
    data_table: Optional[np.ndarray] = None   # (n_data,) leaf table id
    table_dp: Optional[np.ndarray] = None     # (n_tables,) dp of table
    table_parent: Optional[np.ndarray] = None  # (n_tables,) parent, -1 base


def gibbs_train(data: np.ndarray, data_dp: np.ndarray, topo: HdpTopology,
                grid: np.ndarray, nig: Tuple[float, float, float, float],
                burn_in: int = 10000, num_samples: int = 100,
                thinning: int = 10, seed: int = 1,
                sample_gamma: bool = False,
                gamma_alpha: Optional[np.ndarray] = None,
                gamma_beta: Optional[np.ndarray] = None) -> GibbsResult:
    """Run the native sampler. ``burn_in``/``thinning`` count single-factor
    updates (one datum reseat == one iteration, as the reference's
    sample_dp_factors does). ``sample_gamma`` enables per-depth
    concentration resampling from Gamma(gamma_alpha, gamma_beta) priors
    (the *Prior* topology families)."""
    lib = native.load()
    lib.sa_hdp_gibbs.restype = ctypes.c_long
    num_dps = len(topo.parent)
    depths = dp_depths(topo)
    tree_depth = int(depths.max()) + 1
    out_density = np.zeros((num_dps, len(grid)), dtype=np.float64)
    out_observed = np.zeros(num_dps, dtype=np.uint8)
    out_gamma = np.zeros(tree_depth, dtype=np.float64)
    out_w = np.zeros(num_dps, dtype=np.float64)
    out_s = np.zeros(num_dps, dtype=np.uint8)
    max_tables = len(data) * max(tree_depth, 1) + num_dps + 16
    out_data_table = np.full(max(len(data), 1), -1, dtype=np.int64)
    out_table_dp = np.zeros(max_tables, dtype=np.int64)
    out_table_parent = np.full(max_tables, -1, dtype=np.int64)
    out_n_tables = ctypes.c_long(0)
    c = lambda a, t: np.ascontiguousarray(a, dtype=t)
    data = c(data, np.float64)
    data_dp = c(data_dp, np.int64)
    parent = c(topo.parent, np.int64)
    gamma = c(topo.gamma, np.float64)
    gridc = c(grid, np.float64)
    ga = c(gamma_alpha if gamma_alpha is not None
           else np.ones(tree_depth), np.float64)
    gb = c(gamma_beta if gamma_beta is not None
           else np.ones(tree_depth), np.float64)
    dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.sa_hdp_gibbs(
        dp(data),
        data_dp.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.c_long(len(data)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        dp(gamma),
        ctypes.c_long(num_dps),
        ctypes.c_double(nig[0]), ctypes.c_double(nig[1]),
        ctypes.c_double(nig[2]), ctypes.c_double(nig[3]),
        dp(gridc),
        ctypes.c_long(len(grid)),
        ctypes.c_long(burn_in), ctypes.c_long(num_samples),
        ctypes.c_long(thinning), ctypes.c_ulong(seed),
        ctypes.c_int(1 if sample_gamma else 0),
        dp(ga), dp(gb), ctypes.c_long(tree_depth),
        out_density.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_observed.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        dp(out_gamma), dp(out_w),
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_data_table.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        out_table_dp.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        out_table_parent.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.byref(out_n_tables), ctypes.c_long(max_tables))
    if rc != 0:
        raise RuntimeError(f"sa_hdp_gibbs failed: {rc}")
    nt = out_n_tables.value
    return GibbsResult(out_density, out_observed.astype(bool), out_gamma,
                       out_w, out_s.astype(bool),
                       data_table=out_data_table.copy(),
                       table_dp=out_table_dp[:nt].copy(),
                       table_parent=out_table_parent[:nt].copy())


def spline_slopes(grid: np.ndarray, density: np.ndarray) -> np.ndarray:
    lib = native.load()
    out = np.zeros_like(density)
    g = np.ascontiguousarray(grid, dtype=np.float64)
    for i in range(density.shape[0]):
        y = np.ascontiguousarray(density[i], dtype=np.float64)
        s = np.zeros(len(g), dtype=np.float64)
        lib.sa_spline_slopes(
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_long(len(g)),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        out[i] = s
    return out


def _emit_factor_tree(fh, data: np.ndarray, nig, data_table: np.ndarray,
                      table_dp: np.ndarray, table_parent: np.ndarray):
    """Serialize the final CRF seating in the reference's factor-tree
    layout (serialize_factor_tree_internal, hdp.c:2868-2916): pre-order
    emission, ids assigned in emission order, lines of
    ``type \\t parent_id \\t payload`` where BASE payload is the ';'-joined
    cached NIG posterior params (add_update_base_factor_params,
    hdp.c:430-450 — batch-equivalent computation) and DATA payload is the
    data index."""
    from math import lgamma, log

    nt = len(table_dp)
    tchildren = [[] for _ in range(nt)]
    for t in range(nt):
        p = int(table_parent[t])
        if p >= 0:
            tchildren[p].append(t)
    dchildren = [[] for _ in range(nt)]
    for i, t in enumerate(np.asarray(data_table, dtype=np.int64)):
        dchildren[int(t)].append(i)
    mu0, nu0, alpha0, beta0 = (float(v) for v in nig)
    next_id = [0]

    def subtree_data(t):
        out = list(dchildren[t])
        for c_ in tchildren[t]:
            out.extend(subtree_data(c_))
        return out

    def emit(t, parent_id):
        my_id = next_id[0]
        next_id[0] += 1
        if table_parent[t] < 0:
            members = subtree_data(t)
            xs = data[members]
            n = float(len(members))
            nu_post = nu0 + n
            mu_post = (mu0 * nu0 + xs.sum()) / nu_post
            two_alpha_post = 2.0 * alpha0 + n
            mean = float(xs.mean()) if len(members) else 0.0
            ssd = float(((xs - mean) ** 2).sum())
            beta_post = beta0 + 0.5 * (
                ssd + nu0 * n * (mean - mu0) ** 2 / nu_post)
            lp = lgamma(0.5 * two_alpha_post) \
                - 0.5 * (log(nu_post) + two_alpha_post * log(beta_post))
            params = ";".join(f"{v:.17g}" for v in
                              (mu_post, nu_post, two_alpha_post,
                               beta_post, lp))
            fh.write(f"0\t-\t{params}\n")
        else:
            fh.write(f"1\t{parent_id}\t{int(table_dp[t])}\n")
        for c_ in tchildren[t]:
            emit(c_, my_id)
        for di in dchildren[t]:
            fh.write(f"2\t{my_id}\t{di}\n")
            next_id[0] += 1

    for t in range(nt):
        if table_parent[t] < 0:
            emit(t, -1)


def write_nhdp(path: str, alphabet: Alphabet, grid: np.ndarray,
               topo: HdpTopology, densities: np.ndarray,
               observed: np.ndarray, nig, data: np.ndarray,
               data_dp: np.ndarray,
               gamma_params: Optional[np.ndarray] = None,
               gamma_alpha: Optional[np.ndarray] = None,
               gamma_beta: Optional[np.ndarray] = None,
               w_aux: Optional[np.ndarray] = None,
               s_aux: Optional[np.ndarray] = None,
               seating: Optional[GibbsResult] = None) -> str:
    """Serialize in the reference .nhdp layout (serialize_nhdp,
    nanopore_hdp.c:1077 + serialize_hdp, hdp.c:2919). With ``seating``
    (the sampler's final CRF state) the factor-tree tail is written too,
    making the file consumable by the reference's deserialize_nhdp;
    without it the tail is omitted (inference-side readers stop before
    it).

    With ``gamma_alpha``/``gamma_beta`` given, the sample_gamma flag is set
    and the per-depth prior params + final auxiliary w/s vectors are
    written (serialize_hdp's sample_gamma branch, hdp.c:2946-2972).
    """
    slopes = spline_slopes(grid, densities)
    sample_gamma = gamma_alpha is not None and gamma_beta is not None
    have_tree = (seating is not None and seating.data_table is not None
                 and len(seating.table_dp) > 0)
    num_dps = len(topo.parent)
    # num_factor_children per dp: total customers of the dp's factors
    # (incremented per assigned child factor, hdp.c:1368/1720)
    nfc = np.zeros(num_dps, dtype=np.int64)
    if have_tree:
        for t in range(len(seating.table_dp)):
            p = int(seating.table_parent[t])
            if p >= 0:
                nfc[int(seating.table_dp[p])] += 1
        for t in np.asarray(seating.data_table, dtype=np.int64):
            nfc[int(seating.table_dp[int(t)])] += 1
    else:
        nfc[:] = [1 if observed[i] else 0 for i in range(num_dps)]
    with open(path, "w") as fh:
        fh.write(f"{alphabet.size}\n{alphabet.letters}\n"
                 f"{alphabet.kmer_length}\n")
        # splines, has_data, sample_gamma flags
        fh.write(f"1\n1\n{1 if sample_gamma else 0}\n")
        fh.write(f"{num_dps}\n")
        fh.write("\t".join(f"{v:.17g}" for v in data) + "\n")
        fh.write("\t".join(str(int(v)) for v in data_dp) + "\n")
        fh.write(f"{nig[0]:.17g}\t{nig[1]:.17g}\t{nig[2]:.17g}\t"
                 f"{nig[3]:.17g}\n")
        fh.write(f"{grid[0]:.17g}\t{grid[-1]:.17g}\t{len(grid)}\n")
        # one gamma per tree depth, base-to-leaf order (serialize_hdp writes
        # the depth-indexed gamma array; reference deserialize_hdp expects
        # exactly num_dir_levels values -- no dedup, no magnitude sorting)
        depth_gammas = (gamma_params if gamma_params is not None
                        else depth_gamma_vector(topo))
        fh.write("\t".join(f"{g:.17g}" for g in depth_gammas) + "\n")
        if sample_gamma:
            fh.write("\t".join(f"{g:.17g}" for g in gamma_alpha) + "\n")
            fh.write("\t".join(f"{g:.17g}" for g in gamma_beta) + "\n")
            w = w_aux if w_aux is not None else np.zeros(len(topo.parent))
            s = s_aux if s_aux is not None else np.zeros(len(topo.parent))
            fh.write("\t".join(f"{v:.17g}" for v in w) + "\n")
            fh.write("\t".join(str(int(v)) for v in s) + "\n")
        for i, p in enumerate(topo.parent):
            fh.write(("-" if p < 0 else str(int(p)))
                     + f"\t{int(nfc[i])}\n")
        for i in range(len(topo.parent)):
            if observed[i]:
                fh.write("\t".join(f"{v:.17g}" for v in densities[i]))
            fh.write("\n")
        for i in range(len(topo.parent)):
            if observed[i]:
                fh.write("\t".join(f"{v:.17g}" for v in slopes[i]))
            fh.write("\n")
        if have_tree:
            _emit_factor_tree(fh, np.asarray(data, dtype=np.float64), nig,
                              seating.data_table, seating.table_dp,
                              seating.table_parent)
    return path


def train_hdp_from_alignment(build_alignment_path: str, model: PoreModel,
                             hdp_type: str = "singleLevelFixed",
                             out_path: str = "template.nhdp",
                             grid_start: float = 30.0, grid_stop: float = 180.0,
                             grid_length: int = 1200,
                             base_gamma: float = 5.0, middle_gamma: float = 2.0,
                             leaf_gamma: float = 0.5,
                             base_alpha: float = 1.0, base_beta: float = 1.0,
                             middle_alpha: float = 1.0, middle_beta: float = 1.0,
                             leaf_alpha: float = 1.0, leaf_beta: float = 1.0,
                             gibbs_samples: int = 100, burn_in: int = 32,
                             thinning: int = 10, strand: str = "t",
                             seed: int = 1) -> str:
    """buildHdpUtil equivalent: assignment TSV -> Gibbs -> .nhdp.

    ``burn_in`` follows the reference's multiplier semantics
    (min(30M, burn_in * n_assignments), trainModels.py:882-884); burn-in
    and thinning are counted in single-factor updates like the reference.
    ``*Prior*`` topology types enable per-depth gamma resampling from
    Gamma(alpha, beta) priors (nanopore_hdp.c factories 506-930 pass
    gamma_alpha/gamma_beta; hdp.c:2165-2291 samples them).
    """
    if hdp_type in HDP_TYPE_REGISTRY:
        alphabet = hdp_type_alphabet(hdp_type, model.kmer_length)
    else:
        alphabet = model.alphabet
    kmers, values = [], []
    with open(build_alignment_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 3 and parts[1] == strand and \
                    all(c in alphabet.letters for c in parts[0]):
                kmers.append(parts[0])
                values.append(float(parts[2]))
    data = np.array(values)
    data_dp = np.array([alphabet.kmer_index(k) for k in kmers],
                       dtype=np.int64)

    topo = build_topology(alphabet, hdp_type, base_gamma,
                          middle_gamma, leaf_gamma)
    grid = np.linspace(grid_start, grid_stop, grid_length)
    nig = nig_params_from_data(data)
    # burn-in/thinning count single-factor updates, like the reference
    # (sample_dp_factors, hdp.c:2110; trainModels.py:882-884 multiplies
    # the burn-in by the assignment count)
    burn = min(30_000_000, burn_in * max(len(data), 1))
    sample_gamma = "prior" in hdp_type.lower()
    depths = dp_depths(topo)
    tree_depth = int(depths.max()) + 1
    ga = gb = None
    if sample_gamma:
        # per-depth Gamma(alpha, beta) priors, base-to-leaf order
        # (nanopore_hdp.c factories pass (Ba, Bb), (Ma, Mb), (La, Lb))
        alphas = [base_alpha, middle_alpha, leaf_alpha]
        betas = [base_beta, middle_beta, leaf_beta]
        if tree_depth == 2:     # single-level: base + leaves
            alphas = [base_alpha, leaf_alpha]
            betas = [base_beta, leaf_beta]
        ga = np.array(alphas[:tree_depth], dtype=np.float64)
        gb = np.array(betas[:tree_depth], dtype=np.float64)
    res = gibbs_train(
        data, data_dp, topo, grid, nig,
        burn_in=burn, num_samples=gibbs_samples,
        thinning=thinning, seed=seed,
        sample_gamma=sample_gamma, gamma_alpha=ga, gamma_beta=gb)
    return write_nhdp(out_path, alphabet, grid, topo, res.densities,
                      res.observed, nig, data, data_dp,
                      gamma_params=res.gamma if sample_gamma else None,
                      gamma_alpha=ga, gamma_beta=gb,
                      w_aux=res.w_aux if sample_gamma else None,
                      s_aux=res.s_aux if sample_gamma else None,
                      seating=res)
