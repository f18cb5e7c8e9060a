// Native host-side kernels for signalalign_tpu.
//
// These cover the sequential, data-dependent host work that does not belong
// on the TPU: the raw-signal peak detector (event segmentation) and the
// Suzuki-Kasahara adaptive banded Viterbi used to initialize event<->kmer
// maps. Semantics mirror the reference C implementations:
//   - short_long_peak_detector: /root/reference/impl/event_detection.c:122
//   - adaptive_banded_simple_event_align2: /root/reference/impl/eventAligner.c:902
// but operate on precomputed per-position emission parameters instead of
// model lookups (the Python layer prepares m_hat / inv / const arrays).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsignalalign_native.so
//        signalalign_native.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Two-detector peak scan over the short/long t-statistics.
// Returns the number of peaks written to out (caller allocates n slots).
long sa_peak_detector(const float* t1, const float* t2, long n,
                      long wl1, long wl2, float th1, float th2,
                      float peak_height, long* out) {
    const float DEF_VAL = std::numeric_limits<float>::max();
    const float* sig[2] = {t1, t2};
    const long wl[2] = {wl1, wl2};
    const float th[2] = {th1, th2};
    long masked_to[2] = {0, 0};
    long peak_pos[2] = {-1, -1};
    float peak_val[2] = {DEF_VAL, DEF_VAL};
    bool valid[2] = {false, false};
    long count = 0;

    for (long i = 0; i < n; ++i) {
        for (int k = 0; k < 2; ++k) {
            if (masked_to[k] >= i) continue;
            float cur = sig[k][i];
            if (peak_pos[k] == -1) {
                if (cur < peak_val[k]) {
                    peak_val[k] = cur;
                } else if (cur - peak_val[k] > peak_height) {
                    peak_val[k] = cur;
                    peak_pos[k] = i;
                }
            } else {
                if (cur > peak_val[k]) {
                    peak_val[k] = cur;
                    peak_pos[k] = i;
                }
                if (k == 0 && peak_val[0] > th[0]) {
                    masked_to[1] = peak_pos[0] + wl[0];
                    peak_pos[1] = -1;
                    peak_val[1] = DEF_VAL;
                    valid[1] = false;
                }
                if (peak_val[k] - cur > peak_height && peak_val[k] > th[k]) {
                    valid[k] = true;
                }
                if (valid[k] && (i - peak_pos[k]) > wl[k] / 2) {
                    out[count++] = peak_pos[k];
                    peak_pos[k] = -1;
                    peak_val[k] = cur;
                    valid[k] = false;
                }
            }
        }
    }
    return count;
}

// Adaptive banded Viterbi event<->kmer alignment.
//
// ev_mean:        event means, length n_events
// m_hat/inv/cst:  per-kmer-position gaussian params (expected scaled mean,
//                 1/(var*sd), log-normalization constant), length n_kmers
// out_kmer/out_event: preallocated (n_events + n_kmers) pair buffers
// qc_out[0..3]:   avg_log_emission, spanned, max_gap, events_per_kmer
// Returns the number of aligned pairs (in forward order), or 0.
long sa_adaptive_banded_align(const double* ev_mean, long n_events,
                              const double* m_hat, const double* inv,
                              const double* cst, long n_kmers,
                              long* out_kmer, long* out_event,
                              double* qc_out) {
    const int bandwidth = 100;
    const int half_bandwidth = bandwidth / 2;
    const double NEGINF = -INFINITY;

    double events_per_kmer = (double)n_events / (double)n_kmers;
    double p_stay = 1.0 - (1.0 / (events_per_kmer + 1.0));
    double lp_skip = std::log(1e-10);
    double lp_stay = std::log(p_stay);
    double lp_step = std::log(1.0 - std::exp(lp_skip) - std::exp(lp_stay));
    double lp_trim = std::log(0.01);

    long n_rows = n_events + 1;
    long n_cols = n_kmers + 1;
    long n_bands = n_rows + n_cols;

    std::vector<double> bands((size_t)n_bands * bandwidth, NEGINF);
    std::vector<uint8_t> trace((size_t)n_bands * bandwidth, 0);
    std::vector<long> ll_event(n_bands), ll_kmer(n_bands);

    auto band_at = [&](long bi, long off) -> double& {
        return bands[(size_t)bi * bandwidth + off];
    };
    auto trace_at = [&](long bi, long off) -> uint8_t& {
        return trace[(size_t)bi * bandwidth + off];
    };
    auto event_to_offset = [&](long bi, long ei) { return ll_event[bi] - ei; };
    auto kmer_to_offset = [&](long bi, long ki) { return ki - ll_kmer[bi]; };
    auto offset_valid = [&](long off) { return off >= 0 && off < bandwidth; };
    auto emission = [&](long ki, long ei) {
        double a = (ev_mean[ei] - m_hat[ki]) * inv[ki];
        return cst[ki] - 0.5 * a * a;
    };

    ll_event[0] = half_bandwidth - 1;
    ll_kmer[0] = -1 - half_bandwidth;
    ll_event[1] = ll_event[0] + 1;  // move_down
    ll_kmer[1] = ll_kmer[0];

    long start_off = kmer_to_offset(0, -1);
    band_at(0, start_off) = 0.0;
    long first_trim_off = event_to_offset(1, 0);
    band_at(1, first_trim_off) = lp_trim;
    trace_at(1, first_trim_off) = 1;  // FROM_U

    for (long bi = 2; bi < n_bands; ++bi) {
        double ll = band_at(bi - 1, 0);
        double ur = band_at(bi - 1, bandwidth - 1);
        bool ll_ob = ll == NEGINF;
        bool ur_ob = ur == NEGINF;
        bool right = (ll_ob && ur_ob) ? (bi % 2 == 1) : (ll < ur);
        if (right) {
            ll_event[bi] = ll_event[bi - 1];
            ll_kmer[bi] = ll_kmer[bi - 1] + 1;
        } else {
            ll_event[bi] = ll_event[bi - 1] + 1;
            ll_kmer[bi] = ll_kmer[bi - 1];
        }

        long trim_off = kmer_to_offset(bi, -1);
        if (offset_valid(trim_off)) {
            long ei = ll_event[bi] - trim_off;
            if (ei >= 0 && ei < n_events) {
                band_at(bi, trim_off) = lp_trim * (ei + 1);
                trace_at(bi, trim_off) = 1;
            } else {
                band_at(bi, trim_off) = NEGINF;
            }
        }

        long kmin = kmer_to_offset(bi, 0);
        long kmax = kmer_to_offset(bi, n_kmers);
        long emin = event_to_offset(bi, n_events - 1);
        long emax = event_to_offset(bi, -1);
        long mn = std::max(std::max(kmin, emin), 0L);
        long mx = std::min(std::min(kmax, emax), (long)bandwidth);

        for (long off = mn; off < mx; ++off) {
            long ei = ll_event[bi] - off;
            long ki = ll_kmer[bi] + off;
            long off_up = event_to_offset(bi - 1, ei - 1);
            long off_left = kmer_to_offset(bi - 1, ki - 1);
            long off_diag = kmer_to_offset(bi - 2, ki - 1);

            double up = offset_valid(off_up) ? band_at(bi - 1, off_up) : NEGINF;
            double left = offset_valid(off_left) ? band_at(bi - 1, off_left) : NEGINF;
            double diag = offset_valid(off_diag) ? band_at(bi - 2, off_diag) : NEGINF;

            double lp = emission(ki, ei);
            float sd = (float)(diag + lp_step + lp);
            float su = (float)(up + lp_stay + lp);
            float sl = (float)(left + lp_skip);
            // tie behavior matches the reference max/compare sequence
            // (eventAligner.c:1095-1100)
            float best = sd;
            uint8_t from = 0;
            if (su > best) { best = su; }
            if (best == su) { from = 1; }
            if (sl > best) { best = sl; }
            if (best == sl) { from = 2; }
            band_at(bi, off) = best;
            trace_at(bi, off) = from;
        }
    }

    // backtrack
    double max_score = NEGINF;
    long curr_event = 0;
    long curr_kmer = n_kmers - 1;
    for (long ei = 0; ei < n_events; ++ei) {
        long bi = (ei + 1) + (curr_kmer + 1);
        if (bi >= n_bands) continue;
        long off = event_to_offset(bi, ei);
        if (offset_valid(off)) {
            double s = band_at(bi, off) + (n_events - ei) * lp_trim;
            if (s > max_score) {
                max_score = s;
                curr_event = ei;
            }
        }
    }

    long count = 0;
    double sum_emission = 0.0;
    long n_aligned = 0;
    long curr_gap = 0, max_gap = 0;
    while (curr_kmer >= 0 && curr_event >= 0) {
        out_kmer[count] = curr_kmer;
        out_event[count] = curr_event;
        ++count;
        sum_emission += emission(curr_kmer, curr_event);
        ++n_aligned;
        long bi = (curr_event + 1) + (curr_kmer + 1);
        long off = event_to_offset(bi, curr_event);
        uint8_t from = trace_at(bi, off);
        if (from == 0) { --curr_kmer; --curr_event; curr_gap = 0; }
        else if (from == 1) { --curr_event; curr_gap = 0; }
        else { --curr_kmer; ++curr_gap; if (curr_gap > max_gap) max_gap = curr_gap; }
    }

    // reverse in place to forward order
    for (long i = 0; i < count / 2; ++i) {
        std::swap(out_kmer[i], out_kmer[count - 1 - i]);
        std::swap(out_event[i], out_event[count - 1 - i]);
    }

    qc_out[0] = n_aligned ? sum_emission / n_aligned : NEGINF;
    bool spanned = count > 0 && out_kmer[0] == 0 && out_kmer[count - 1] == n_kmers - 1;
    qc_out[1] = spanned ? 1.0 : 0.0;
    qc_out[2] = (double)max_gap;
    qc_out[3] = events_per_kmer;
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hierarchical Dirichlet process Gibbs sampler (Chinese restaurant franchise)
//
// reference semantics: impl/hdp.c (gibbs_factor_iteration:1994,
// sample_dp_factors:2110, take_distr_sample:2067, execute_gibbs_sampling:2491,
// finalize_distributions:2551, spline_knot_slopes in hdp_math_utils.c:430).
// This is a from-scratch CRF sampler over an arbitrary DP tree with a
// normal-inverse-gamma base measure:
//   * each datum sits at a table of its leaf DP; each table is a customer of
//     a table in the parent DP, recursively to the base DP;
//   * base-DP tables accumulate sufficient statistics; the predictive for a
//     datum under a table is the NIG posterior-predictive (Student-t);
//   * reseating removes a datum (cascading empty tables) and samples an
//     existing table (prob ~ count x predictive) or a new table
//     (prob ~ gamma x parent predictive, recursively);
//   * posterior-predictive densities are averaged over thinned Gibbs
//     samples on a fixed grid; natural-cubic-spline knot slopes finalize.

#include <random>
#include <algorithm>

namespace {

struct Table {
    long dp;            // owning dp
    long parent_table;  // index into tables[] of parent dp table (-1 at base)
    long count;         // customers (data at leaves, child tables otherwise)
    // base sufficient stats (only meaningful for base-dp tables)
    double n = 0.0, sx = 0.0, sxx = 0.0;
    bool alive = false;
};

struct HdpState {
    long num_dps;
    std::vector<long> parent;           // -1 for base
    std::vector<double> gamma;          // per dp
    double mu0, nu, alpha, beta;
    std::vector<Table> tables;
    std::vector<std::vector<long>> dp_tables;   // live table ids per dp
    std::vector<long> free_tables;
    std::mt19937_64 rng;

    long base_of(long tid) {
        while (tables[tid].parent_table >= 0) tid = tables[tid].parent_table;
        return tid;
    }

    long new_table(long dp) {
        long id;
        if (!free_tables.empty()) {
            id = free_tables.back();
            free_tables.pop_back();
            tables[id] = Table();
        } else {
            id = (long)tables.size();
            tables.push_back(Table());
        }
        Table& t = tables[id];
        t.dp = dp;
        t.parent_table = -1;
        t.count = 0;
        t.alive = true;
        dp_tables[dp].push_back(id);
        return id;
    }

    void drop_table(long tid) {
        Table& t = tables[tid];
        t.alive = false;
        auto& v = dp_tables[t.dp];
        for (size_t i = 0; i < v.size(); ++i) {
            if (v[i] == tid) { v[i] = v.back(); v.pop_back(); break; }
        }
        free_tables.push_back(tid);
    }

    double log_predictive_stats(double x, double n, double sx, double sxx) {
        // NIG posterior predictive (Student-t)
        double nun = nu + n;
        double mun = n > 0 ? (nu * mu0 + sx) / nun : mu0;
        double an = alpha + n / 2.0;
        double bn = beta;
        if (n > 0) {
            double xbar = sx / n;
            bn += 0.5 * (sxx - n * xbar * xbar)
                + (n * nu * (xbar - mu0) * (xbar - mu0)) / (2.0 * nun);
        }
        double df = 2.0 * an;
        double scale2 = bn * (nun + 1.0) / (an * nun);
        double z = (x - mun);
        return std::lgamma((df + 1.0) / 2.0) - std::lgamma(df / 2.0)
            - 0.5 * std::log(df * M_PI * scale2)
            - ((df + 1.0) / 2.0) * std::log1p(z * z / (df * scale2));
    }

    double log_predictive_table(double x, long tid) {
        Table& bt = tables[base_of(tid)];
        return log_predictive_stats(x, bt.n, bt.sx, bt.sxx);
    }

    // marginal predictive of x under dp (mixture of tables + new-table mass)
    double log_predictive_dp(double x, long dp) {
        double total = gamma[dp];
        double m = -INFINITY;
        std::vector<double> lps;
        lps.reserve(dp_tables[dp].size() + 1);
        for (long tid : dp_tables[dp]) {
            double lp = std::log((double)tables[tid].count)
                + log_predictive_table(x, tid);
            lps.push_back(lp);
            if (lp > m) m = lp;
            total += tables[tid].count;
        }
        double lp_new = std::log(gamma[dp])
            + (parent[dp] >= 0 ? log_predictive_dp(x, parent[dp])
                               : log_predictive_stats(x, 0, 0, 0));
        lps.push_back(lp_new);
        if (lp_new > m) m = lp_new;
        double s = 0.0;
        for (double lp : lps) s += std::exp(lp - m);
        return m + std::log(s) - std::log(total);
    }

    // seat a customer (datum value x) at dp; returns table id
    long seat(double x, long dp) {
        double total = gamma[dp];
        std::vector<double> w;
        std::vector<long> ids;
        double m = -INFINITY;
        for (long tid : dp_tables[dp]) {
            double lp = std::log((double)tables[tid].count)
                + log_predictive_table(x, tid);
            w.push_back(lp);
            ids.push_back(tid);
            if (lp > m) m = lp;
            total += tables[tid].count;
        }
        double lp_new = std::log(gamma[dp])
            + (parent[dp] >= 0 ? log_predictive_dp(x, parent[dp])
                               : log_predictive_stats(x, 0, 0, 0));
        w.push_back(lp_new);
        if (lp_new > m) m = lp_new;
        double s = 0.0;
        for (double& lw : w) { lw = std::exp(lw - m); s += lw; }
        std::uniform_real_distribution<double> U(0.0, s);
        double r = U(rng);
        size_t pick = w.size() - 1;
        for (size_t i = 0; i < w.size(); ++i) {
            if (r < w[i]) { pick = i; break; }
            r -= w[i];
        }
        long tid;
        if (pick < ids.size()) {
            tid = ids[pick];
        } else {
            tid = new_table(dp);
            if (parent[dp] >= 0) {
                long ptid = seat(x, parent[dp]);
                tables[tid].parent_table = ptid;
            }
        }
        tables[tid].count += 1;
        // accumulate stats at the base table
        Table& bt = tables[base_of(tid)];
        bt.n += 1.0; bt.sx += x; bt.sxx += x * x;
        return tid;
    }

    void unseat(double x, long tid) {
        Table& bt = tables[base_of(tid)];
        bt.n -= 1.0; bt.sx -= x; bt.sxx -= x * x;
        while (tid >= 0) {
            Table& t = tables[tid];
            t.count -= 1;
            long up = t.parent_table;
            if (t.count == 0) {
                drop_table(tid);
                tid = up;          // cascade: remove as customer of parent
            } else {
                break;
            }
        }
    }
};

}  // namespace

extern "C" {

// Gibbs-train an HDP and evaluate averaged posterior predictives.
//
// data[n_data], data_dp[n_data]: observations and their leaf dp ids
// parent[num_dps] (-1 root), gamma[num_dps]
// mu0/nu/alpha/beta: NIG base; grid[grid_len]: sampling grid
// burn_in, num_samples, thinning: Gibbs schedule, counted in SINGLE-FACTOR
//   updates (one datum reseating = one iteration; each per-depth gamma
//   update also counts one), matching the reference's iter accounting
//   (sample_dp_factors / sample_gammas, hdp.c:2110-2291): a distribution
//   sample is taken whenever iter % thinning == 0 && iter > burn_in.
// sample_gamma != 0 enables concentration-parameter resampling from
//   per-depth Gamma(gamma_alpha[d], gamma_beta[d]) priors by the
//   auxiliary-variable scheme (hdp.c:2165-2291): per observed dp,
//   w ~ Beta(gamma+1, #customers), s ~ Bernoulli(n/(n+gamma)); depth 0
//   uses Escobar & West's (1995) weighted two-gamma update, deeper levels
//   Gamma(alpha + #tables_at_depth - sum_s, beta - sum_log_w). All dps at
//   one depth share a gamma (the reference indexes gamma by depth).
// out_density: (num_dps x grid_len) averaged posterior predictive per dp
//              (only for dps with data under them; others zero-filled and
//              flagged 0 in out_observed[num_dps])
// out_gamma[tree_depth], out_w[num_dps], out_s[num_dps]: final sampled
//   concentrations / auxiliary variables (sample_gamma mode; may be null).
// Returns 0 on success.
long sa_hdp_gibbs(const double* data, const long* data_dp, long n_data,
                  const long* parent, const double* gamma_in, long num_dps,
                  double mu0, double nu, double alpha, double beta,
                  const double* grid, long grid_len,
                  long burn_in, long num_samples, long thinning,
                  unsigned long seed,
                  int sample_gamma,
                  const double* gamma_alpha, const double* gamma_beta,
                  long tree_depth,
                  double* out_density, unsigned char* out_observed,
                  double* out_gamma, double* out_w, unsigned char* out_s,
                  // final CRF seating state (nullable): per-datum leaf
                  // table, per-table dp id / parent table (compacted ids;
                  // -1 parent at base). Enables serializing the factor
                  // tree in the reference's .nhdp layout
                  // (serialize_factor_tree_internal, hdp.c:2868-2916).
                  long* out_data_table, long* out_table_dp,
                  long* out_table_parent, long* out_n_tables,
                  long max_tables) {
    HdpState h;
    h.num_dps = num_dps;
    h.parent.assign(parent, parent + num_dps);
    h.gamma.assign(gamma_in, gamma_in + num_dps);
    h.mu0 = mu0; h.nu = nu; h.alpha = alpha; h.beta = beta;
    h.dp_tables.resize(num_dps);
    h.rng.seed(seed);

    std::vector<long> assignment(n_data, -1);

    // initial sequential seating
    for (long i = 0; i < n_data; ++i) {
        assignment[i] = h.seat(data[i], data_dp[i]);
    }

    // which dps have data under them (dp or any descendant observed)
    std::vector<unsigned char> has_data(num_dps, 0);
    for (long i = 0; i < n_data; ++i) {
        long d = data_dp[i];
        while (d >= 0 && !has_data[d]) { has_data[d] = 1; d = parent[d]; }
    }
    for (long d = 0; d < num_dps; ++d) out_observed[d] = has_data[d];

    // dp depth (base = 0) for the per-depth shared gammas
    std::vector<long> depth(num_dps, 0);
    for (long d = 0; d < num_dps; ++d) {
        long p = parent[d], dep = 0;
        while (p >= 0) { ++dep; p = parent[p]; }
        depth[d] = dep;
    }
    std::vector<double> depth_gamma(std::max<long>(tree_depth, 1), 1.0);
    for (long d = 0; d < num_dps; ++d) {
        if (depth[d] < (long)depth_gamma.size())
            depth_gamma[depth[d]] = h.gamma[d];
    }
    std::vector<double> w_aux(num_dps, 0.0);
    std::vector<unsigned char> s_aux(num_dps, 0);

    std::vector<double> acc((size_t)num_dps * grid_len, 0.0);
    long taken = 0;
    long iter = 0;
    std::vector<long> order(n_data);
    for (long i = 0; i < n_data; ++i) order[i] = i;
    if (thinning < 1) thinning = 1;

    auto take_sample = [&]() {
        // bottom-up density pass: parents have larger ids than children
        // in all supported topologies, so iterate ids descending and
        // memoize each dp's grid density for its children.
        std::vector<double> dens((size_t)num_dps * grid_len, 0.0);
        for (long d = num_dps - 1; d >= 0; --d) {
            if (!has_data[d]) continue;
            double total = h.gamma[d];
            for (long tid : h.dp_tables[d]) total += h.tables[tid].count;
            for (long gidx = 0; gidx < grid_len; ++gidx) {
                double x = grid[gidx];
                double sum = 0.0;
                for (long tid : h.dp_tables[d]) {
                    sum += h.tables[tid].count
                        * std::exp(h.log_predictive_table(x, tid));
                }
                double pparent = (parent[d] >= 0)
                    ? dens[(size_t)parent[d] * grid_len + gidx]
                    : std::exp(h.log_predictive_stats(x, 0, 0, 0));
                dens[(size_t)d * grid_len + gidx] =
                    (sum + h.gamma[d] * pparent) / total;
            }
        }
        for (size_t q = 0; q < acc.size(); ++q) acc[q] += dens[q];
        ++taken;
    };

    auto gamma_dist = [&](double shape, double rate) {
        std::gamma_distribution<double> G(std::max(shape, 1e-3), 1.0);
        return G(h.rng) / std::max(rate, 1e-12);
    };

    auto resample_gammas = [&]() {
        // auxiliary variables per observed dp
        for (long d = 0; d < num_dps; ++d) {
            if (!has_data[d]) continue;
            double n_children = 0.0;
            for (long tid : h.dp_tables[d]) n_children += h.tables[tid].count;
            // w ~ Beta(gamma + 1, n_children) via two gamma draws
            double ga = gamma_dist(h.gamma[d] + 1.0, 1.0);
            double gb = gamma_dist(n_children, 1.0);
            w_aux[d] = ga / std::max(ga + gb, 1e-300);
            std::uniform_real_distribution<double> U(0.0, 1.0);
            s_aux[d] = U(h.rng)
                < n_children / (n_children + h.gamma[d]) ? 1 : 0;
        }
        // per-depth sums
        std::vector<double> sum_log_w(tree_depth, 0.0);
        std::vector<long> sum_s(tree_depth, 0), nf(tree_depth, 0);
        double base_children = 0.0;
        for (long d = 0; d < num_dps; ++d) {
            if (!has_data[d] || depth[d] >= tree_depth) continue;
            nf[depth[d]] += (long)h.dp_tables[d].size();
            sum_log_w[depth[d]] += std::log(std::max(w_aux[d], 1e-300));
            if (s_aux[d]) sum_s[depth[d]]++;
            if (parent[d] < 0) {
                for (long tid : h.dp_tables[d])
                    base_children += h.tables[tid].count;
            }
        }
        bool stop = false;
        for (long dep = 0; dep < tree_depth && !stop; ++dep) {
            double a_post, b_post;
            if (dep == 0) {
                // Escobar & West (1995): the reference takes a WEIGHTED SUM
                // of two gamma draws (hdp.c:2203-2210)
                a_post = gamma_alpha[0] + (double)nf[0];
                b_post = gamma_beta[0] - sum_log_w[0];
                double frac = (a_post - 1.0)
                    / (std::max(base_children, 1.0) * b_post);
                double wt = frac / (1.0 + frac);
                depth_gamma[0] = wt * gamma_dist(a_post, b_post)
                    + (1.0 - wt) * gamma_dist(a_post - 1.0, b_post);
            } else {
                a_post = gamma_alpha[dep] + (double)(nf[dep] - sum_s[dep]);
                b_post = gamma_beta[dep] - sum_log_w[dep];
                depth_gamma[dep] = gamma_dist(a_post, b_post);
            }
            for (long d = 0; d < num_dps; ++d) {
                if (depth[d] == dep) h.gamma[d] = depth_gamma[dep];
            }
            ++iter;
            if (iter % thinning == 0 && iter > burn_in) {
                take_sample();
                if (taken >= num_samples) stop = true;
            }
        }
    };

    while (taken < num_samples) {
        std::shuffle(order.begin(), order.end(), h.rng);
        for (long oi = 0; oi < n_data && taken < num_samples; ++oi) {
            long i = order[oi];
            h.unseat(data[i], assignment[i]);
            assignment[i] = h.seat(data[i], data_dp[i]);
            ++iter;
            if (iter % thinning == 0 && iter > burn_in) take_sample();
        }
        if (sample_gamma && taken < num_samples && tree_depth > 0
            && gamma_alpha && gamma_beta) {
            resample_gammas();
        }
    }
    if (taken == 0) taken = 1;
    for (long d = 0; d < num_dps; ++d) {
        for (long gidx = 0; gidx < grid_len; ++gidx) {
            out_density[(size_t)d * grid_len + gidx] =
                has_data[d] ? acc[(size_t)d * grid_len + gidx] / taken : 0.0;
        }
    }
    if (out_gamma) {
        for (long dep = 0; dep < tree_depth; ++dep)
            out_gamma[dep] = depth_gamma[dep];
    }
    if (out_w) for (long d = 0; d < num_dps; ++d) out_w[d] = w_aux[d];
    if (out_s) for (long d = 0; d < num_dps; ++d) out_s[d] = s_aux[d];
    if (out_data_table && out_table_dp && out_table_parent
        && out_n_tables) {
        // export the final seating: compact live table ids
        std::vector<long> remap(h.tables.size(), -1);
        long nt = 0;
        for (long d = 0; d < num_dps; ++d)
            for (long tid : h.dp_tables[d]) {
                if (nt >= max_tables) return -2;
                remap[tid] = nt;
                out_table_dp[nt] = h.tables[tid].dp;
                ++nt;
            }
        for (long d = 0; d < num_dps; ++d)
            for (long tid : h.dp_tables[d]) {
                long p = h.tables[tid].parent_table;
                out_table_parent[remap[tid]] = (p >= 0) ? remap[p] : -1;
            }
        for (long i = 0; i < n_data; ++i)
            out_data_table[i] = remap[assignment[i]];
        *out_n_tables = nt;
    }
    return 0;
}

// Natural cubic spline knot slopes (reference: spline_knot_slopes,
// hdp_math_utils.c:430): tridiagonal solve for a uniform grid.
void sa_spline_slopes(const double* x, const double* y, long n,
                      double* out_slopes) {
    if (n < 2) { if (n == 1) out_slopes[0] = 0.0; return; }
    std::vector<double> a(n), b(n), c(n), r(n);
    double h0 = x[1] - x[0];
    b[0] = 2.0; c[0] = 1.0; r[0] = 3.0 * (y[1] - y[0]) / h0;
    for (long i = 1; i < n - 1; ++i) {
        a[i] = 1.0; b[i] = 4.0; c[i] = 1.0;
        r[i] = 3.0 * (y[i + 1] - y[i - 1]) / h0;
    }
    a[n - 1] = 1.0; b[n - 1] = 2.0;
    r[n - 1] = 3.0 * (y[n - 1] - y[n - 2]) / h0;
    // Thomas algorithm
    for (long i = 1; i < n; ++i) {
        double mfac = a[i] / b[i - 1];
        b[i] -= mfac * c[i - 1];
        r[i] -= mfac * r[i - 1];
    }
    out_slopes[n - 1] = r[n - 1] / b[n - 1];
    for (long i = n - 2; i >= 0; --i) {
        out_slopes[i] = (r[i] - c[i] * out_slopes[i + 1]) / b[i];
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Local (Smith-Waterman) nucleotide alignment with affine gaps + traceback.
//
// Guide-alignment generator for reads without a BAM record: a dependency-free
// stand-in for the reference's external `bwa mem` call
// (src/signalalign/utils/bwaWrapper.py generateGuideAlignment). Produces the
// best local alignment of query vs ref as CIGAR ops; the caller tries both
// reference orientations and picks the higher score.
// ---------------------------------------------------------------------------

extern "C" {

// out_ops: 0=M, 1=I (consumes query), 2=D (consumes ref); runs are RLE
// (out_lens). Returns 0 on success, -1 if max_ops exceeded.
long sa_sw_align(const char* query, long lq, const char* ref, long lr,
                 double match, double mismatch,
                 double gap_open, double gap_extend,
                 long* out_qs, long* out_qe, long* out_rs, long* out_re,
                 int* out_ops, long* out_lens, long max_ops, long* out_nops,
                 double* out_score) {
    if (lq <= 0 || lr <= 0) return -1;
    // H/E/F rows; traceback matrices store 2-bit move codes per cell
    std::vector<double> H(lr + 1, 0.0), E(lr + 1, -1e30);
    std::vector<double> Hprev(lr + 1, 0.0);
    // tb codes: for H: 0=stop, 1=diag, 2=from E (gap in query / D), 3=from F
    // (gap in ref / I); for E: bit set if extend; for F likewise
    std::vector<unsigned char> tbH((size_t)(lq + 1) * (lr + 1), 0);
    std::vector<unsigned char> tbE((size_t)(lq + 1) * (lr + 1), 0);
    std::vector<unsigned char> tbF((size_t)(lq + 1) * (lr + 1), 0);
    double best = 0.0;
    long bi = 0, bj = 0;
    for (long i = 1; i <= lq; ++i) {
        double Fi = -1e30;
        double Hdiag_left = 0.0;  // Hprev[j-1]
        H[0] = 0.0;
        for (long j = 1; j <= lr; ++j) {
            size_t idx = (size_t)i * (lr + 1) + j;
            // E: gap in query (deletion wrt query; consumes ref)
            double e_open = H[j - 1] + gap_open;
            double e_ext = E[j - 1] + gap_extend;
            E[j] = e_open >= e_ext ? e_open : e_ext;
            tbE[idx] = e_open >= e_ext ? 0 : 1;
            // F: gap in ref (insertion; consumes query)
            double f_open = Hprev[j] + gap_open;
            double f_ext = Fi + gap_extend;
            Fi = f_open >= f_ext ? f_open : f_ext;
            tbF[idx] = f_open >= f_ext ? 0 : 1;
            // H
            char qc = query[i - 1], rc = ref[j - 1];
            double sub = (qc == rc && qc != 'N') ? match : mismatch;
            double h = Hprev[j - 1] + sub;
            unsigned char code = 1;
            if (E[j] > h) { h = E[j]; code = 2; }
            if (Fi > h) { h = Fi; code = 3; }
            if (h <= 0.0) { h = 0.0; code = 0; }
            Hdiag_left = Hprev[j];
            (void)Hdiag_left;
            H[j] = h;
            tbH[idx] = code;
            if (h > best) { best = h; bi = i; bj = j; }
        }
        std::swap(H, Hprev);
        std::fill(E.begin(), E.end(), -1e30);
    }
    if (best <= 0.0) return -1;
    // traceback from (bi, bj)
    long i = bi, j = bj;
    long nops = 0;
    int cur_op = -1;
    long cur_len = 0;
    int state = 0;  // 0 = in H, 1 = in E, 2 = in F
    auto push = [&](int op) -> bool {
        if (op == cur_op) { cur_len++; return true; }
        if (cur_op >= 0) {
            if (nops >= max_ops) return false;
            out_ops[nops] = cur_op; out_lens[nops] = cur_len; nops++;
        }
        cur_op = op; cur_len = 1;
        return true;
    };
    while (i > 0 && j > 0) {
        size_t idx = (size_t)i * (lr + 1) + j;
        if (state == 0) {
            unsigned char c = tbH[idx];
            if (c == 0) break;
            if (c == 1) { if (!push(0)) return -1; i--; j--; }
            else if (c == 2) state = 1;
            else state = 2;
        } else if (state == 1) {
            if (!push(2)) return -1;
            unsigned char ext = tbE[idx];
            j--;
            state = ext ? 1 : 0;
        } else {
            if (!push(1)) return -1;
            unsigned char ext = tbF[idx];
            i--;
            state = ext ? 2 : 0;
        }
    }
    if (cur_op >= 0) {
        if (nops >= max_ops) return -1;
        out_ops[nops] = cur_op; out_lens[nops] = cur_len; nops++;
    }
    // ops were collected end->start; reverse
    for (long a = 0, b = nops - 1; a < b; ++a, --b) {
        int to = out_ops[a]; out_ops[a] = out_ops[b]; out_ops[b] = to;
        long tl = out_lens[a]; out_lens[a] = out_lens[b]; out_lens[b] = tl;
    }
    *out_qs = i; *out_qe = bi;
    *out_rs = j; *out_re = bj;
    *out_nops = nops;
    *out_score = best;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seeded guide alignment: minimizer index + anchor chaining + banded SW.
//
// Genome-scale replacement for the full-DP sa_sw_align when mapping reads
// without a BAM record: the reference gets anchors from seed-and-extend
// lastz (impl/pairwiseAligner.c:1660-1703 getBlastPairs) or an indexed
// `bwa mem` (src/signalalign/utils/bwaWrapper.py:14-120). Here: (1) an
// (hash, position)-sorted minimizer index of the forward reference
// (minimap2-style (k, w) minimizers); (2) query minimizers looked up per
// strand, chained with a sparse gap-cost DP; (3) the winning chain's
// diagonal corridor refined by a banded affine-gap Smith-Waterman with
// traceback. O(lr) index build once, O(lq + chain) per read.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cstdlib>

namespace {

struct MinIdx {
    int k = 15, w = 10;
    // minimizers sorted by hash; pos is the kmer start on the fwd strand
    std::vector<uint64_t> hash;
    std::vector<int64_t> pos;
};

static inline uint64_t mix64(uint64_t key, uint64_t mask) {
    // invertible integer hash (Wang), masked to 2k bits
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

static inline int base2(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': case 'U': case 'u': return 3;
    }
    return -1;
}

// (hash, kmer start) minimizers of seq, appended to out_h/out_p.
static void minimizers(const char* seq, long n, int k, int w,
                       std::vector<uint64_t>& out_h,
                       std::vector<int64_t>& out_p) {
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    uint64_t km = 0;
    long run = 0;
    // ring buffer of the last w kmer hashes
    std::vector<uint64_t> rh(w);
    std::vector<int64_t> rp(w);
    long filled = 0;
    int64_t last_emit = -1;
    for (long i = 0; i < n; ++i) {
        int b = base2(seq[i]);
        if (b < 0) { run = 0; filled = 0; continue; }
        km = ((km << 2) | (uint64_t)b) & mask;
        if (++run < k) continue;
        long kstart = i - k + 1;
        uint64_t h = mix64(km, mask);
        rh[(size_t)(filled % w)] = h;
        rp[(size_t)(filled % w)] = kstart;
        ++filled;
        if (filled < w) continue;
        // window minimum (w is small; linear scan)
        uint64_t mh = ~0ULL;
        int64_t mp = -1;
        for (int j = 0; j < w; ++j)
            if (rh[j] < mh || (rh[j] == mh && rp[j] > mp)) {
                mh = rh[j]; mp = rp[j];
            }
        if (mp != last_emit) {
            out_h.push_back(mh);
            out_p.push_back(mp);
            last_emit = mp;
        }
    }
}

struct Anchor { int64_t q, r; };

// best chain over anchors (sorted by r then q): minimap2-style DP with a
// bounded lookback. Returns score; fills [qs, qe), [rs, re) of the chain.
static double chain(std::vector<Anchor>& a, int k,
                    int64_t* qs, int64_t* qe, int64_t* rs, int64_t* re) {
    if (a.empty()) return 0.0;
    std::sort(a.begin(), a.end(), [](const Anchor& x, const Anchor& y) {
        return x.r != y.r ? x.r < y.r : x.q < y.q;
    });
    const long n = (long)a.size();
    const long LOOKBACK = 64;
    const int64_t MAX_GAP = 5000;
    std::vector<double> f(n);
    std::vector<long> pre(n, -1);
    double best = -1.0;
    long bi = 0;
    for (long i = 0; i < n; ++i) {
        f[i] = k;
        for (long j = i - 1; j >= 0 && j >= i - LOOKBACK; --j) {
            int64_t dr = a[i].r - a[j].r;
            int64_t dq = a[i].q - a[j].q;
            if (dq <= 0 || dr <= 0 || dq > MAX_GAP || dr > MAX_GAP)
                continue;
            int64_t dd = dr > dq ? dr - dq : dq - dr;
            double gain = (double)std::min(std::min(dq, dr), (int64_t)k)
                          - 0.05 * (double)dd
                          - 0.01 * (double)std::max(dq, dr);
            if (f[j] + gain > f[i]) { f[i] = f[j] + gain; pre[i] = j; }
        }
        if (f[i] > best) { best = f[i]; bi = i; }
    }
    long i = bi;
    *qe = a[bi].q + k; *re = a[bi].r + k;
    while (pre[i] >= 0) i = pre[i];
    *qs = a[i].q; *rs = a[i].r;
    return best;
}

}  // namespace

extern "C" {

void* sa_minidx_build(const char* ref, long lr, int k, int w) {
    auto* idx = new (std::nothrow) MinIdx();
    if (!idx) return nullptr;
    idx->k = k; idx->w = w;
    std::vector<uint64_t> h;
    std::vector<int64_t> p;
    minimizers(ref, lr, k, w, h, p);
    std::vector<size_t> order(h.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](size_t x, size_t y) {
        return h[x] != h[y] ? h[x] < h[y] : p[x] < p[y];
    });
    idx->hash.resize(h.size());
    idx->pos.resize(h.size());
    for (size_t i = 0; i < order.size(); ++i) {
        idx->hash[i] = h[order[i]];
        idx->pos[i] = p[order[i]];
    }
    return idx;
}

void sa_minidx_free(void* handle) {
    delete static_cast<MinIdx*>(handle);
}

// Map query against the index; tries both strands (caller passes the
// reverse-complemented query as query_rc). Reports the best chain's
// reference window [out_rs, out_re), query window [out_qs, out_qe) (in
// the ORIGINAL read frame for both strands), strand (0 fwd / 1 rc), the
// chain score, and the chain's diagonal spread (for the extension band).
// Returns the number of anchors in the winning chain (0 = no mapping).
long sa_minidx_map(void* handle, const char* query, const char* query_rc,
                   long lq, long max_occ,
                   long* out_rs, long* out_re, long* out_qs, long* out_qe,
                   int* out_strand, double* out_score, long* out_band,
                   double* out_score2) {
    auto* idx = static_cast<MinIdx*>(handle);
    if (!idx || lq < idx->k) return 0;
    double best_score = 0.0;
    long best_n = 0;
    int64_t best_rs = 0, best_re = 0;
    std::vector<Anchor> all_anchors[2];
    for (int strand = 0; strand < 2; ++strand) {
        const char* q = strand ? query_rc : query;
        std::vector<uint64_t> qh;
        std::vector<int64_t> qp;
        minimizers(q, lq, idx->k, idx->w, qh, qp);
        std::vector<Anchor>& anchors = all_anchors[strand];
        for (size_t i = 0; i < qh.size(); ++i) {
            auto lo = std::lower_bound(idx->hash.begin(), idx->hash.end(),
                                       qh[i]);
            auto hi = std::upper_bound(lo, idx->hash.end(), qh[i]);
            if (hi - lo == 0 || hi - lo > max_occ) continue;
            for (auto it = lo; it != hi; ++it)
                anchors.push_back({qp[i],
                                   idx->pos[(size_t)(it - idx->hash.begin())]});
        }
        if (anchors.empty()) continue;
        int64_t qs, qe, rs, re;
        double sc = chain(anchors, idx->k, &qs, &qe, &rs, &re);
        if (sc > best_score) {
            best_score = sc;
            best_n = (long)anchors.size();
            best_rs = rs; best_re = re;
            // diagonal spread of the chain corridor
            int64_t dmin = rs - qs, dmax = re - qe;
            if (dmin > dmax) std::swap(dmin, dmax);
            *out_band = (long)(dmax - dmin);
            if (strand) {  // report query coords in the original frame
                *out_qs = lq - qe; *out_qe = lq - qs;
            } else {
                *out_qs = qs; *out_qe = qe;
            }
            *out_rs = rs; *out_re = re;
            *out_strand = strand;
            *out_score = sc;
        }
    }
    // ambiguity evidence (bwa MAPQ analogue): best chain that lands
    // OUTSIDE the winner's reference span — a repeat copy elsewhere
    // scores close to best and the caller can flag the map as
    // low-confidence (bwaWrapper.py maps inherit bwa's MAPQ; this is
    // the built-in mapper's equivalent signal)
    if (out_score2) {
        double second = 0.0;
        if (best_n > 0) {
            const int64_t margin = 1000;
            for (int strand = 0; strand < 2; ++strand) {
                if (all_anchors[strand].empty()) continue;
                std::vector<Anchor> filt;
                for (const auto& an : all_anchors[strand])
                    if (an.r < best_rs - margin || an.r > best_re + margin)
                        filt.push_back(an);
                if (filt.empty()) continue;
                int64_t q1, q2, r1, r2;
                double sc = chain(filt, idx->k, &q1, &q2, &r1, &r2);
                if (sc > second) second = sc;
            }
        }
        *out_score2 = second;
    }
    return best_n;
}

// Banded local alignment with affine gaps + traceback: same scoring and
// output contract as sa_sw_align, but cells restricted to diagonals
// j - i in [diag_lo, diag_hi] (j on ref, i on query, both 1-based DP
// coords). Memory O(lq * band) instead of O(lq * lr).
long sa_sw_align_banded(const char* query, long lq, const char* ref, long lr,
                        long diag_lo, long diag_hi,
                        double match, double mismatch,
                        double gap_open, double gap_extend,
                        long* out_qs, long* out_qe, long* out_rs,
                        long* out_re, int* out_ops, long* out_lens,
                        long max_ops, long* out_nops, double* out_score) {
    if (lq <= 0 || lr <= 0 || diag_hi < diag_lo) return -1;
    const long B = diag_hi - diag_lo + 1;
    const double NEGV = -1e30;
    // band-local storage: cell (i, j) lives at (i, d = j - i - diag_lo).
    // Neighbor offsets in band coords: (i-1, j-1) -> (i-1, d);
    // (i, j-1) -> (i, d-1); (i-1, j) -> (i-1, d+1).
    std::vector<double> Hrow((size_t)B, NEGV), Hprev((size_t)B, NEGV);
    std::vector<double> Erow((size_t)B, NEGV);
    std::vector<double> Frow((size_t)B, NEGV), Fprev((size_t)B, NEGV);
    std::vector<unsigned char> tbH((size_t)(lq + 1) * B, 0);
    std::vector<unsigned char> tbE((size_t)(lq + 1) * B, 0);
    std::vector<unsigned char> tbF((size_t)(lq + 1) * B, 0);

    double best = 0.0;
    long bi = 0, bd = -1;
    for (long i = 1; i <= lq; ++i) {
        std::fill(Erow.begin(), Erow.end(), NEGV);
        std::fill(Frow.begin(), Frow.end(), NEGV);
        for (long d = 0; d < B; ++d) {
            long j = i + diag_lo + d;
            if (j < 1 || j > lr) { Hrow[(size_t)d] = NEGV; continue; }
            size_t idx = (size_t)i * B + (size_t)d;
            // E: consumes ref -> from (i, j-1), already final this row
            double e_open = (d > 0 ? Hrow[(size_t)(d - 1)] : NEGV)
                            + gap_open;
            double e_ext = (d > 0 ? Erow[(size_t)(d - 1)] : NEGV)
                           + gap_extend;
            double Ev = e_open >= e_ext ? e_open : e_ext;
            Erow[(size_t)d] = Ev;
            tbE[idx] = e_open >= e_ext ? 0 : 1;
            // F: consumes query -> from (i-1, j); row 0 is all zeros
            // (local alignment may start anywhere)
            double hup = (i == 1) ? 0.0
                         : ((d + 1 < B) ? Hprev[(size_t)(d + 1)] : NEGV);
            double fup = (d + 1 < B) ? Fprev[(size_t)(d + 1)] : NEGV;
            double f_open = hup + gap_open;
            double f_ext = fup + gap_extend;
            double Fv = f_open >= f_ext ? f_open : f_ext;
            Frow[(size_t)d] = Fv;
            tbF[idx] = f_open >= f_ext ? 0 : 1;
            double hdiag = (i == 1 || j == 1) ? 0.0 : Hprev[(size_t)d];
            char qc = query[i - 1], rc = ref[j - 1];
            double sub = (qc == rc && qc != 'N' && qc != 'n')
                             ? match : mismatch;
            double h = hdiag + sub;
            unsigned char code = 1;
            if (Ev > h) { h = Ev; code = 2; }
            if (Fv > h) { h = Fv; code = 3; }
            if (h <= 0.0) { h = 0.0; code = 0; }
            Hrow[(size_t)d] = h;
            tbH[idx] = code;
            if (h > best) { best = h; bi = i; bd = d; }
        }
        std::swap(Hrow, Hprev);
        std::swap(Frow, Fprev);
    }
    if (best <= 0.0 || bd < 0) return -1;
    long i = bi, d = bd;
    long nops = 0;
    int cur_op = -1;
    long cur_len = 0;
    int state = 0;
    auto push = [&](int op) -> bool {
        if (op == cur_op) { cur_len++; return true; }
        if (cur_op >= 0) {
            if (nops >= max_ops) return false;
            out_ops[nops] = cur_op; out_lens[nops] = cur_len; nops++;
        }
        cur_op = op; cur_len = 1;
        return true;
    };
    while (i > 0) {
        long j = i + diag_lo + d;
        if (j <= 0) break;
        size_t idx = (size_t)i * B + (size_t)d;
        if (state == 0) {
            unsigned char c = tbH[idx];
            if (c == 0) break;
            if (c == 1) { if (!push(0)) return -1; i--; }          // d same
            else if (c == 2) state = 1;
            else state = 2;
        } else if (state == 1) {       // E: gap consumes ref (D)
            if (!push(2)) return -1;
            unsigned char ext = tbE[idx];
            d--;                        // (i, j-1)
            if (d < 0) break;
            state = ext ? 1 : 0;
        } else {                        // F: gap consumes query (I)
            if (!push(1)) return -1;
            unsigned char ext = tbF[idx];
            i--; d++;                   // (i-1, j)
            if (d >= B) break;
            state = ext ? 2 : 0;
        }
    }
    if (cur_op >= 0) {
        if (nops >= max_ops) return -1;
        out_ops[nops] = cur_op; out_lens[nops] = cur_len; nops++;
    }
    for (long a2 = 0, b2 = nops - 1; a2 < b2; ++a2, --b2) {
        int to = out_ops[a2]; out_ops[a2] = out_ops[b2]; out_ops[b2] = to;
        long tl = out_lens[a2]; out_lens[a2] = out_lens[b2]; out_lens[b2] = tl;
    }
    long j_end = bi + diag_lo + bd;
    long j_start = i + diag_lo + d;
    *out_qs = i; *out_qe = bi;
    *out_rs = j_start; *out_re = j_end;
    *out_nops = nops;
    *out_score = best;
    return 0;
}

}  // extern "C"
