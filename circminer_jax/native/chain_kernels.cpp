// Native host-side batched seed chaining for circminer-jax.
//
// Exact port of the Python oracle ops/chain.py:chain_seeds_host (itself
// modeled on the reference's chain_seeds_sorted_kbest / _kbest2,
// src/chain.cpp:73-539): sparse k-best DP over per-k-mer seed lists with
// annotation-aware upper bounds (gene_annotation.h:123-133,
// gene_annotation.cpp:464-533) and exon-junction gap gating
// (check_junction, chain.cpp:28-64).  One call chains a whole read batch
// across std::thread workers.
//
// Build: g++ -O3 -shared -fPIC -pthread chain_kernels.cpp -o libchain.so

#include <cstdint>
#include <algorithm>
#include <cmath>
#include <map>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

constexpr double REWARD_COEF = 2e4;   // chain.cpp:10
constexpr double PENALTY_COEF = 0.1;  // chain.cpp:11
constexpr int64_t INF64 = 1000000000;
constexpr uint32_t MAXUB32 = 4294967295u;

struct ChainAnno {
    const uint8_t* nb;        // packed near_border bits
    int64_t nb_len;           // genome length in bases covered by nb
    const int32_t* iv_spos;
    const int32_t* iv_epos;
    const int32_t* iv_max_end;
    const int32_t* iv_min_end;
    const int32_t* iv_max_next;
    const int64_t* iv_seg_off;  // [n_iv + 1]
    const int32_t* seg_end;
    const int32_t* seg_next;
    int32_t n_iv;

    bool near_border(int64_t pos) const {
        if (nb == nullptr || nb_len <= 0) return false;
        int64_t p = std::min(std::max(pos, (int64_t)0), nb_len - 1);
        return (nb[p >> 3] >> (p & 7)) & 1;
    }

    // find_ind (interval_tree_impl.h:136-175): (found_iv or -1, raw ind)
    void find_ind(int64_t pos, int32_t* found, int32_t* raw) const {
        if (n_iv == 0 || pos < (int64_t)iv_spos[0]) {
            *found = -1; *raw = -1; return;
        }
        // upper_bound over iv_spos
        int32_t lo = 0, hi = n_iv;
        while (lo < hi) {
            int32_t mid = (lo + hi) >> 1;
            if ((int64_t)iv_spos[mid] <= pos) lo = mid + 1; else hi = mid;
        }
        int32_t ind = lo - 1;
        *raw = ind;
        *found = (ind >= 0 && (int64_t)iv_epos[ind] >= pos) ? ind : -1;
    }

    // get_upper_bound (annotation.py:343-387); returns (ub, max_exon_end,
    // ol_iv or -1)
    void upper_bound(int64_t spos, int32_t mlen, int64_t rlen, int32_t max_ed,
                     int64_t* ub, int64_t* mee, int32_t* ol_iv) const {
        if (!near_border(spos)) {
            *ub = spos + rlen + max_ed; *mee = 0; *ol_iv = -1; return;
        }
        int32_t iv, raw;
        find_ind(spos, &iv, &raw);
        int64_t epos = spos + mlen - 1;
        if (iv >= 0 && iv_seg_off[iv] == iv_seg_off[iv + 1]) iv = -1;
        if (iv < 0) {
            int32_t nxt = raw + 1;
            int64_t max_end = (nxt >= n_iv) ? (int64_t)MAXUB32
                                            : (int64_t)iv_spos[nxt] - 1;
            if (max_end < epos) { *ub = 0; *mee = max_end; *ol_iv = -1;
                                  return; }
            *ub = std::min(spos + rlen + max_ed, max_end - mlen + 1);
            *mee = max_end; *ol_iv = -1;
            return;
        }
        int64_t max_end, min_end, max_next;
        if (epos > (int64_t)iv_epos[iv]) {
            max_end = 0; min_end = INF64; max_next = 0;
            for (int64_t e = iv_seg_off[iv]; e < iv_seg_off[iv + 1]; ++e) {
                if ((int64_t)seg_end[e] >= epos) {
                    max_end = std::max(max_end, (int64_t)seg_end[e]);
                    min_end = std::min(min_end, (int64_t)seg_end[e]);
                    max_next = std::max(max_next, (int64_t)seg_next[e]);
                }
            }
        } else {
            max_end = (int64_t)iv_max_end[iv];
            min_end = (int64_t)iv_min_end[iv];
            max_next = (int64_t)iv_max_next[iv];
        }
        if (max_end > 0 && max_end >= epos) {
            if (min_end < rlen + epos && max_next != 0) {
                *ub = max_next + mlen - 1;
            } else {
                *ub = max_end - mlen + 1;
            }
            *mee = max_end; *ol_iv = iv;
            return;
        }
        *ub = 0; *mee = 0; *ol_iv = -1;
    }

    // check_junction (chain.cpp:28-64); returns ok; *td set on success
    bool check_junction(int64_t s1, int64_t s2, int32_t iv, int32_t k,
                        int64_t read_dist, int32_t max_ed,
                        int64_t* td_out) const {
        if (iv < 0) return false;
        int64_t e1 = s1 + k - 1;
        if (s2 <= e1) return false;
        int64_t trans_dist2intron = -1;
        for (int64_t e = iv_seg_off[iv]; e < iv_seg_off[iv + 1]; ++e) {
            int64_t e12end = (int64_t)seg_end[e] - e1;
            int64_t beg2s2 = s2 - (int64_t)seg_next[e];
            if (e12end >= 0 && e12end < read_dist && beg2s2 + k < 0)
                trans_dist2intron = s2 - e1 - 1;
            if (e12end < 0 || beg2s2 < 0) continue;
            int64_t td = e12end + beg2s2;
            int64_t d = td - read_dist;
            if ((d < 0 ? -d : d) <= max_ed) { *td_out = td; return true; }
        }
        if (trans_dist2intron != -1) { *td_out = trans_dist2intron;
                                       return true; }
        return false;
    }
};

}  // namespace

#ifndef CHAIN_KERNELS_INLINE
extern "C" {
#endif

// Batched k-best chain DP.  pos [R, NL, cap] ascending per list (0-pad),
// cnt/qpos [R, NL], lens [R].  Outputs, per row: up to max_chain chains of
// up to NL fragments — out_rpos/out_qpos [R, max_chain, NL] (includes
// +shift), out_flen implicit (= k), out_clen [R, max_chain] fragment
// counts, out_score [R, max_chain] doubles, out_n [R] chain counts.
void batch_chain(const int32_t* pos, const int32_t* cnt, const int32_t* qpos,
                 const int32_t* lens,
                 int32_t R, int32_t NL, int32_t cap,
                 const uint8_t* nb, int64_t nb_len,
                 const int32_t* iv_spos, const int32_t* iv_epos,
                 const int32_t* iv_max_end, const int32_t* iv_min_end,
                 const int32_t* iv_max_next, const int64_t* iv_seg_off,
                 const int32_t* seg_end, const int32_t* seg_next,
                 int32_t n_iv,
                 int32_t k, int32_t max_ed, int64_t max_intron,
                 int32_t max_chain, int64_t shift,
                 int32_t* out_rpos, int32_t* out_qpos, int32_t* out_clen,
                 double* out_score, int32_t* out_n,
                 int32_t n_threads) {
    ChainAnno anno{nb, nb_len, iv_spos, iv_epos, iv_max_end, iv_min_end,
              iv_max_next, iv_seg_off, seg_end, seg_next, n_iv};

    auto worker = [&](int32_t r0, int32_t r1) {
        std::vector<double> dp_score((size_t)NL * cap);
        std::vector<int32_t> dp_prev_l((size_t)NL * cap);
        std::vector<int32_t> dp_prev_i((size_t)NL * cap);
        std::vector<int32_t> lb_ind(NL);
        for (int32_t r = r0; r < r1; ++r) {
            const int32_t* P = pos + (int64_t)r * NL * cap;
            const int32_t* C = cnt + (int64_t)r * NL;
            const int32_t* Q = qpos + (int64_t)r * NL;
            int32_t* o_rp = out_rpos + (int64_t)r * max_chain * NL;
            int32_t* o_qp = out_qpos + (int64_t)r * max_chain * NL;
            int32_t* o_cl = out_clen + (int64_t)r * max_chain;
            double* o_sc = out_score + (int64_t)r * max_chain;
            out_n[r] = 0;

            // drop empty trailing lists (chain.cpp:112-116)
            int32_t kmer_cnt = NL;
            while (kmer_cnt >= 1 && C[kmer_cnt - 1] <= 0) --kmer_cnt;
            if (kmer_cnt <= 0) continue;

            for (int32_t ii = 0; ii < kmer_cnt; ++ii)
                for (int32_t i = 0; i < std::min(C[ii], cap); ++i) {
                    dp_score[(size_t)ii * cap + i] = (double)k;
                    dp_prev_l[(size_t)ii * cap + i] = -1;
                    dp_prev_i[(size_t)ii * cap + i] = -1;
                }

            // score -> events (ii, i), insertion-ordered, capped
            std::map<double, std::vector<std::pair<int32_t, int32_t>>> ev;

            for (int32_t ii = kmer_cnt - 2; ii >= 0; --ii) {
                const int32_t n_i = std::min(C[ii], cap);
                if (n_i == 0) continue;
                const int64_t read_remain = (int64_t)lens[r] - Q[ii] - k;
                std::fill(lb_ind.begin(), lb_ind.end(), 0);
                for (int32_t i = 0; i < n_i; ++i) {
                    const int64_t seg_start = P[(size_t)ii * cap + i];
                    const int64_t seg_endp = seg_start + k - 1;
                    bool have_ub = false;
                    int64_t ub = 0, mee = 0;
                    int32_t ol_iv = -1;
                    for (int32_t jj = ii + 1; jj < kmer_cnt; ++jj) {
                        const int32_t n_j = std::min(C[jj], cap);
                        const int32_t* nxt = P + (size_t)jj * cap;
                        if (n_j == 0 || lb_ind[jj] >= n_j) continue;
                        if (seg_start + max_intron < (int64_t)nxt[lb_ind[jj]])
                            continue;
                        while (lb_ind[jj] < n_j &&
                               (int64_t)nxt[lb_ind[jj]] <= seg_start)
                            ++lb_ind[jj];
                        if (lb_ind[jj] >= n_j) continue;
                        if (!have_ub) {
                            anno.upper_bound(seg_start, k, read_remain,
                                             max_ed, &ub, &mee, &ol_iv);
                            have_ub = true;
                        }
                        const int64_t distr = (int64_t)Q[jj] - Q[ii] - k;
                        int32_t j = lb_ind[jj];
                        while (j < n_j && (int64_t)nxt[j] <= ub) {
                            const int64_t pj = nxt[j];
                            int64_t genome_dist;
                            if (mee == 0 || pj + k - 1 <= mee)
                                genome_dist = pj - seg_endp - 1;
                            else
                                genome_dist = INF64;
                            int64_t distt;
                            int64_t gd = genome_dist - distr;
                            if ((gd < 0 ? -gd : gd) <= max_ed) {
                                distt = genome_dist;
                            } else {
                                int64_t td;
                                if (anno.check_junction(seg_start, pj, ol_iv,
                                                        k, distr, max_ed,
                                                        &td)) {
                                    distt = td;
                                } else { ++j; continue; }
                            }
                            const double beta = PENALTY_COEF *
                                (double)(std::max(distr, distt) -
                                         std::min(distr, distt));
                            const double temp_score =
                                dp_score[(size_t)jj * cap + j] +
                                REWARD_COEF * k - beta;
                            double& cur = dp_score[(size_t)ii * cap + i];
                            if (temp_score > cur) {
                                cur = temp_score;
                                dp_prev_l[(size_t)ii * cap + i] = jj;
                                dp_prev_i[(size_t)ii * cap + i] = j;
                                auto& lst = ev[temp_score];
                                if ((int32_t)lst.size() < max_chain)
                                    lst.emplace_back(ii, i);
                            }
                            ++j;
                        }
                    }
                }
            }

            // backtrack (chain.cpp:234-281)
            int32_t n_chains = 0;
            std::unordered_set<int64_t> repeats;
            double best_score = ev.empty() ? (double)k : ev.rbegin()->first;
            for (auto it = ev.rbegin(); it != ev.rend(); ++it) {
                const double sc = it->first;
                for (auto& cell : it->second) {
                    if (n_chains >= max_chain) break;
                    int32_t ii = cell.first, i = cell.second;
                    const int64_t spos = P[(size_t)ii * cap + i];
                    if (sc < best_score && repeats.count(spos)) continue;
                    int32_t cl = 0;
                    bool first = true;
                    while (ii != -1 && cl < NL) {
                        const int64_t rp = shift + P[(size_t)ii * cap + i];
                        o_rp[(size_t)n_chains * NL + cl] = (int32_t)rp;
                        o_qp[(size_t)n_chains * NL + cl] = Q[ii];
                        if (!first) repeats.insert(rp);
                        first = false;
                        ++cl;
                        int32_t nl = dp_prev_l[(size_t)ii * cap + i];
                        int32_t ni = dp_prev_i[(size_t)ii * cap + i];
                        ii = nl; i = ni;
                    }
                    o_cl[n_chains] = cl;
                    o_sc[n_chains] = sc;
                    ++n_chains;
                }
                if (n_chains >= max_chain) break;
            }

            // single-fragment fallback (chain.cpp:283-298)
            if (n_chains == 0) {
                for (int32_t ii = kmer_cnt - 1; ii >= 0 && n_chains <
                     max_chain; --ii) {
                    const int32_t n_i = std::min(C[ii], cap);
                    for (int32_t i = 0; i < n_i; ++i) {
                        if (n_chains >= max_chain) break;
                        o_rp[(size_t)n_chains * NL] =
                            (int32_t)(shift + P[(size_t)ii * cap + i]);
                        o_qp[(size_t)n_chains * NL] = Q[ii];
                        o_cl[n_chains] = 1;
                        o_sc[n_chains] = dp_score[(size_t)ii * cap + i];
                        ++n_chains;
                    }
                }
            }
            out_n[r] = n_chains;
        }
    };

    if (n_threads <= 1 || R < 16) {
        worker(0, R);
        return;
    }
    std::vector<std::thread> ts;
    int32_t per = (R + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int32_t b0 = t * per, b1 = std::min(R, b0 + per);
        if (b0 >= b1) break;
        ts.emplace_back(worker, b0, b1);
    }
    for (auto& t : ts) t.join();
}

// Batched k-best extraction from the DEVICE chain DP's results
// (ops/chain.py:chain_batch_device -> extract_kbest).  dp10/back/pos are
// int32 [R, NL, S] (dp10 = 10x score, back = flat backpointer into NL*S or
// -1), qpos/cnt int32 [R, NL].  Output layout identical to batch_chain so
// the native filter consumes either executor's chains unchanged.
void batch_extract_kbest(const int32_t* dp10, const int32_t* back,
                         const int32_t* pos, const int32_t* qpos,
                         const int32_t* cnt,
                         int32_t R, int32_t NL, int32_t S,
                         int32_t k, int32_t max_chain, int64_t shift,
                         int32_t* out_rpos, int32_t* out_qpos,
                         int32_t* out_clen, double* out_score,
                         int32_t* out_n, int32_t n_threads) {
    auto worker = [&](int32_t r0, int32_t r1) {
        struct Cell { int32_t dp; int32_t l; int32_t s; };
        std::vector<Cell> cells;
        std::unordered_set<int64_t> repeats;
        for (int32_t r = r0; r < r1; ++r) {
            const int32_t* DP = dp10 + (int64_t)r * NL * S;
            const int32_t* BK = back + (int64_t)r * NL * S;
            const int32_t* P = pos + (int64_t)r * NL * S;
            const int32_t* Q = qpos + (int64_t)r * NL;
            const int32_t* C = cnt + (int64_t)r * NL;
            int32_t* o_rp = out_rpos + (int64_t)r * max_chain * NL;
            int32_t* o_qp = out_qpos + (int64_t)r * max_chain * NL;
            int32_t* o_cl = out_clen + (int64_t)r * max_chain;
            double* o_sc = out_score + (int64_t)r * max_chain;
            out_n[r] = 0;

            cells.clear();
            for (int32_t l = 0; l < NL; ++l) {
                const int32_t n_l = std::min(C[l], S);
                for (int32_t s = 0; s < n_l; ++s)
                    if (BK[(size_t)l * S + s] >= 0)
                        cells.push_back({DP[(size_t)l * S + s], l, s});
            }
            // order: score desc, list desc, index asc (extract_kbest)
            std::stable_sort(cells.begin(), cells.end(),
                             [](const Cell& a, const Cell& b) {
                if (a.dp != b.dp) return a.dp > b.dp;
                if (a.l != b.l) return a.l > b.l;
                return a.s < b.s;
            });

            int32_t n_chains = 0;
            repeats.clear();
            const int32_t best10 = cells.empty() ? 10 * k : cells[0].dp;
            for (const Cell& c0 : cells) {
                if (n_chains >= max_chain) break;
                // NB: the oracle checks the UNSHIFTED head position against
                // the SHIFTED repeat set (ops/chain.py extract_kbest /
                // chain_seeds_host) — identical when shift == 0 (mapping
                // stage); preserved verbatim for the circ stage.
                const int64_t spos = P[(size_t)c0.l * S + c0.s];
                if (c0.dp < best10 && repeats.count(spos)) continue;
                int32_t cl = 0;
                bool first = true;
                int32_t l = c0.l, s = c0.s;
                while (l != -1 && cl < NL) {
                    const int64_t rp = shift + P[(size_t)l * S + s];
                    o_rp[(size_t)n_chains * NL + cl] = (int32_t)rp;
                    o_qp[(size_t)n_chains * NL + cl] = Q[l];
                    if (!first) repeats.insert(rp);
                    first = false;
                    ++cl;
                    const int32_t b = BK[(size_t)l * S + s];
                    if (b < 0) break;
                    l = b / S; s = b % S;
                }
                o_cl[n_chains] = cl;
                o_sc[n_chains] = (double)c0.dp / 10.0;
                ++n_chains;
            }

            // single-fragment fallback (chain.cpp:283-298), lists descending
            if (n_chains == 0) {
                int32_t last = NL - 1;
                while (last >= 0 && C[last] <= 0) --last;
                for (int32_t l = last; l >= 0 && n_chains < max_chain; --l) {
                    const int32_t n_l = std::min(C[l], S);
                    for (int32_t s = 0; s < n_l; ++s) {
                        if (n_chains >= max_chain) break;
                        o_rp[(size_t)n_chains * NL] =
                            (int32_t)(shift + P[(size_t)l * S + s]);
                        o_qp[(size_t)n_chains * NL] = Q[l];
                        o_cl[n_chains] = 1;
                        o_sc[n_chains] = (double)DP[(size_t)l * S + s] / 10.0;
                        ++n_chains;
                    }
                }
            }
            out_n[r] = n_chains;
        }
    };

    if (n_threads <= 1 || R < 16) {
        worker(0, R);
        return;
    }
    std::vector<std::thread> ts;
    int32_t per = (R + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int32_t b0 = t * per, b1 = std::min(R, b0 + per);
        if (b0 >= b1) break;
        ts.emplace_back(worker, b0, b1);
    }
    for (auto& t : ts) t.join();
}

#ifndef CHAIN_KERNELS_INLINE
}  // extern "C"
#endif
