// Host-side native kernels of kmer_spans_tpu_torch (C ABI, bound with
// ctypes by kmer_spans_tpu_torch/utils/native.py).
//
// The port's own copy of the entry points it calls from
// native/kmerspans_native.cpp: FASTA byte packing (ks_pack), the spectrum
// counts (ks_count, ks_count_mt, ks_count_radix, and the sparse
// ks_count_sparse for wide k), the sequential span caller of the native
// backend (ks_spans), the exact f64 rank chain (ks_rank_chain,
// ks_chain_from_hist), the integer mass of queried codes
// (ks_mass_of_codes) and the reference-exact candidate replays
// (ks_replay_packed, ks_replay_scores).  Same arithmetic, same operation
// order, same f64 folds as the original (ks_pack alone differs: it
// returns the number of bytes it wrote, where the original returns
// nothing; ks_replay_scores adds two optional outputs, the scan counts
// and the candidates, for spans/extract.py, and ks_replay_table is its
// fold reading the scores from a table itself).  ks_replay_tr, the transition-
// score replay, is the C form of the JAX package's spans/tr_pipeline.py
// replay_tr_segment.
//
// Built at first use with the system C++ compiler into
// kmer_spans_tpu_torch/build/ (utils/native.py says how).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Packing: byte -> 2-bit base, with N ('n'/'N') encoded as 4.
// Every non-N byte maps through (c >> 1) & 3 (A=0,C=1,T=2,G=3); see
// SURVEY.md A.1 — IUPAC codes are 2-bit mapped, not skipped.
// ---------------------------------------------------------------------------
int64_t ks_pack(const uint8_t* in, int64_t n, uint8_t* out) {
    static uint8_t table[256];
    static bool init = false;
    if (!init) {
        for (int c = 0; c < 256; ++c) table[c] = (uint8_t)((c >> 1) & 3);
        table[(unsigned char)'n'] = 4;
        table[(unsigned char)'N'] = 4;
        init = true;
    }
    for (int64_t i = 0; i < n; ++i) out[i] = table[in[i]];
    return n;
}

// ---------------------------------------------------------------------------
// Spectrum counting over packed bases (4 == N).  Counts every complete
// k-mer inside each N-free segment; returns the number of words counted.
// ---------------------------------------------------------------------------
int64_t ks_count(const uint8_t* nb, int64_t n, int32_t k, int32_t* counts) {
    const uint64_t mask = (1ull << (2 * k)) - 1;
    int64_t words = 0;
    int64_t i = 0;
    while (i < n) {
        // find segment start
        while (i < n && nb[i] == 4) ++i;
        // build first k-mer
        uint64_t off = 0;
        int32_t have = 0;
        while (i < n && nb[i] != 4) {
            off = ((off << 2) | nb[i]) & mask;
            ++i;
            if (have < k) ++have;
            if (have >= k) {
                ++counts[off];
                ++words;
            }
        }
    }
    return words;
}

// ---------------------------------------------------------------------------
// Span caller: sequential reference-exact scan (SURVEY A.3/A.4).
// Scored positions: k-mer end positions a+k-1 .. b-1 of each segment [a,b]
// (the final k-mer of a segment is never scored).  Regions reported as
// 1-based last-base positions of (first-positive, first-argmax) k-mers.
// Emits into caller-provided buffers; the return value is the TOTAL number
// of regions found (only the first `capacity` are written — if the return
// exceeds capacity, call again with more space).
// If scan_counts != NULL, every scored position increments
// scan_counts[code], and rescanned positions count again (the reference's
// double-counting quirk).
// ---------------------------------------------------------------------------
int64_t ks_spans(const uint8_t* nb, int64_t n, int32_t k,
                 const double* weights, double threshold,
                 int64_t min_width, double min_score,
                 int64_t* out_beg, int64_t* out_end, double* out_score,
                 int64_t capacity, int64_t* scan_counts) {
    const uint64_t mask = (1ull << (2 * k)) - 1;
    int64_t nreg = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && nb[i] == 4) ++i;
        if (i >= n) break;
        // segment [a, b]
        int64_t a = i;
        int64_t b = a;
        while (b < n && nb[b] != 4) ++b;
        --b;  // inclusive end
        i = b + 1;
        if (b - a + 1 < k) continue;
        // restartable scan over scored positions (k-mer ends a+k-1 .. b-1)
        int64_t start_end = a + k - 1;  // first k-mer end position
        int64_t resume = start_end;
        while (resume <= b - 1) {
            // build k-mer ending at `resume`
            uint64_t off = 0;
            for (int64_t p = resume - k + 1; p <= resume; ++p)
                off = ((off << 2) | nb[p]) & mask;
            double score = 0, last = 0, maxs = 0;
            int64_t reg_beg = 0, max_pos = 0;
            int64_t p = resume;
            bool jumped = false;
            for (; p <= b - 1; ++p) {
                if (p > resume) off = ((off << 2) | nb[p]) & mask;
                if (scan_counts) ++scan_counts[off];
                double s = weights[off] - threshold;
                score = last + s;
                if (score < 0) score = 0;
                int64_t pos1 = p + 1;  // 1-based last base
                if (last == 0 && score > 0) {
                    reg_beg = pos1; max_pos = pos1; maxs = score;
                }
                if (score == 0 && last > 0) {
                    if (max_pos - reg_beg >= min_width && maxs >= min_score) {
                        if (nreg < capacity) {
                            out_beg[nreg] = reg_beg;
                            out_end[nreg] = max_pos;
                            out_score[nreg] = maxs;
                        }
                        ++nreg;
                        resume = max_pos;  // 0-based end of next kmer
                        jumped = true;
                        break;
                    }
                    maxs = 0; max_pos = pos1;
                }
                if (score > maxs) { maxs = score; max_pos = pos1; }
                last = score;
            }
            if (jumped) continue;
            // terminal emission (segment end with positive score)
            if (score > 0 && max_pos - reg_beg >= min_width && maxs >= min_score) {
                if (nreg < capacity) {
                    out_beg[nreg] = reg_beg;
                    out_end[nreg] = max_pos;
                    out_score[nreg] = maxs;
                }
                ++nreg;
                resume = max_pos;
                continue;
            }
            break;  // segment done
        }
    }
    return nreg;
}

// ---------------------------------------------------------------------------
// Candidate-stretch replay straight from the device's packed payload
// (spans/pipeline.py packed_bases format): per block one uint32 seed code
// (the rolling code at the block's first position, whose high bits are the
// k-1 halo bases) followed by block/16 words of 2-bit bases.  Replays the
// reference scan (first-positive -> first-argmax, jump-back rescans) over
// the scored positions with s = ranks[code] - threshold in sequential f64,
// bit-identical to ks_replay_scores over the same scores and to
// src/kmer_spans.c:243-307.  Coordinates: 1-based last-base positions
// offset by base_pos (the global 0-based position of element 0).  Returns
// total regions (only the first `capacity` are written).
// ---------------------------------------------------------------------------
int64_t ks_replay_packed(const uint32_t* cand_words, const uint8_t* scored,
                         int64_t rows, int64_t block, int32_t k,
                         const double* ranks, double threshold,
                         int64_t min_width, double min_score,
                         int64_t base_pos,
                         int64_t* out_beg, int64_t* out_end,
                         double* out_score, int64_t capacity) {
    const int64_t wpr = 1 + block / 16;
    const uint64_t mask = (1ull << (2 * k)) - 1;
    const int64_t n = rows * block;

    // base at stretch index i (i in [-(k-1), n)); negative indices read the
    // halo bits of row 0's seed code
    auto base_at = [&](int64_t i) -> uint32_t {
        if (i < 0) return (cand_words[0] >> (uint32_t)(-2 * i)) & 3u;
        const int64_t r = i / block, o = i % block;
        const uint32_t* w = cand_words + r * wpr;
        if (o == 0) return w[0] & 3u;
        return (w[1 + (o >> 4)] >> (uint32_t)(2 * (o & 15))) & 3u;
    };
    auto code_at = [&](int64_t i) -> uint64_t {
        const int64_t r = i / block, o = i % block;
        if (o == 0) return cand_words[r * wpr] & mask;
        uint64_t c = 0;
        for (int32_t t = k - 1; t >= 0; --t)
            c = ((c << 2) | base_at(i - t)) & mask;
        return c;
    };

    int64_t nreg = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && !scored[i]) ++i;
        if (i >= n) break;
        int64_t a = i;  // scored-run start
        int64_t b = a;
        while (b < n && scored[b]) ++b;
        --b;  // inclusive run end
        i = b + 1;
        // restartable reference scan over [a, b]
        int64_t resume = a;
        while (resume <= b) {
            uint64_t code = code_at(resume);
            double S = 0.0;
            double mx = 0.0;
            int64_t u = -1, m = -1;
            int64_t p = resume;
            bool jumped = false;
            for (; p <= b; ++p) {
                if (p > resume) code = ((code << 2) | base_at(p)) & mask;
                S += ranks[code] - threshold;
                if (S <= 0.0) {
                    S = 0.0;
                    if (u >= 0) {  // excursion closed at p
                        if (m - u >= min_width && mx >= min_score) {
                            if (nreg < capacity) {
                                out_beg[nreg] = base_pos + u + 1;
                                out_end[nreg] = base_pos + m + 1;
                                out_score[nreg] = mx;
                            }
                            ++nreg;
                            resume = m + 1;  // jump-back rescan
                            jumped = true;
                            break;
                        }
                        u = -1; m = -1; mx = 0.0;
                    }
                    continue;
                }
                if (u < 0) { u = p; m = p; mx = S; }
                else if (S > mx) { mx = S; m = p; }
            }
            if (jumped) continue;
            // run end with open excursion: terminal emission + rescan
            if (u >= 0 && m - u >= min_width && mx >= min_score) {
                if (nreg < capacity) {
                    out_beg[nreg] = base_pos + u + 1;
                    out_end[nreg] = base_pos + m + 1;
                    out_score[nreg] = mx;
                }
                ++nreg;
                resume = m + 1;
                continue;
            }
            break;  // run done
        }
    }
    return nreg;
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// The one fold of every host finisher of the device paths (spans/extract.py
// extract_spans): the same restartable reference scan as ks_replay_packed
// over each run of scored positions of a stretch of n positions, reading
// position p's score and mask through one of two sources:
//   FlatScores  precomputed f64 scores (ks_replay_scores), s[p] already =
//               ranks[code_p] - threshold at scored positions (anything at
//               unscored ones: they reset the run);
//   TableRows   the codes and mask in place, in rows of 2^shift positions
//               (ks_replay_table): s = table[code_p] - threshold, the same
//               f64 subtraction, at scored positions only, so the codes of
//               unscored positions are never read.
// A -inf score gives S <= 0, which resets the running score too.
//
// Two optional outputs, each skipped where its pointer is null:
//   visits     int64 difference array of length n + 1 (added into): +1 at
//              each scored run's start a and -1 at b + 1; at each emission
//              +1 at m + 1 and -1 just past the position where that
//              excursion closed (b + 1 when it ran to the run's end), so
//              its prefix sum counts each position's scans, rescans
//              included;
//   candidates the count (added into *candidates) of excursions, rescans'
//              included, that closed or reached the run's end with their
//              last positive position at least min_width past their first
//              and max S >= min_score: the candidate excursions.
// ---------------------------------------------------------------------------
struct FlatScores {
    const double* s;
    const uint8_t* scored;
    bool is_scored(int64_t p) const { return scored[p]; }
    double score(int64_t p) const { return s[p]; }
    void ahead(int64_t, int64_t) const {}
};

struct TableRows {
    const int32_t* const* codes;  // the stretch's rows, in order
    const uint8_t* const* scored;
    int32_t shift;                // a row holds 1 << shift positions
    const double* table;
    double threshold;
    int64_t col(int64_t p) const { return p & ((int64_t(1) << shift) - 1); }
    bool is_scored(int64_t p) const { return scored[p >> shift][col(p)]; }
    double score(int64_t p) const {
        return table[codes[p >> shift][col(p)]] - threshold;
    }
    // start loading the table entry of position q early: a 4^k table far
    // beyond the caches would otherwise cost one memory latency a position
    // (the code there may be junk: a prefetch never faults)
    void ahead(int64_t q, int64_t n) const {
        if (q < n) __builtin_prefetch(table + codes[q >> shift][col(q)]);
    }
};

// positions between a prefetch of a table entry and its use
constexpr int64_t kAhead = 32;

template <class Src>
int64_t replay_fold(const Src& src, int64_t n, int64_t min_width,
                    double min_score, int64_t base_pos, int64_t* out_beg,
                    int64_t* out_end, double* out_score, int64_t capacity,
                    int64_t* visits, int64_t* candidates) {
    int64_t nreg = 0;
    int64_t tried = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && !src.is_scored(i)) ++i;
        if (i >= n) break;
        int64_t a = i;
        int64_t b = a;
        while (b < n && src.is_scored(b)) ++b;
        --b;
        i = b + 1;
        if (visits) { ++visits[a]; --visits[b + 1]; }
        int64_t resume = a;
        while (resume <= b) {
            double S = 0.0;
            double mx = 0.0;
            int64_t u = -1, m = -1;
            int64_t p = resume;
            bool jumped = false;
            for (; p <= b; ++p) {
                src.ahead(p + kAhead, n);
                S += src.score(p);
                if (S <= 0.0) {
                    S = 0.0;
                    if (u >= 0) {
                        if (p - 1 - u >= min_width && mx >= min_score)
                            ++tried;
                        if (m - u >= min_width && mx >= min_score) {
                            if (nreg < capacity) {
                                out_beg[nreg] = base_pos + u + 1;
                                out_end[nreg] = base_pos + m + 1;
                                out_score[nreg] = mx;
                            }
                            ++nreg;
                            if (visits) { ++visits[m + 1]; --visits[p + 1]; }
                            resume = m + 1;
                            jumped = true;
                            break;
                        }
                        u = -1; m = -1; mx = 0.0;
                    }
                    continue;
                }
                if (u < 0) { u = p; m = p; mx = S; }
                else if (S > mx) { mx = S; m = p; }
            }
            if (jumped) continue;
            if (u >= 0 && b - u >= min_width && mx >= min_score) ++tried;
            if (u >= 0 && m - u >= min_width && mx >= min_score) {
                if (nreg < capacity) {
                    out_beg[nreg] = base_pos + u + 1;
                    out_end[nreg] = base_pos + m + 1;
                    out_score[nreg] = mx;
                }
                ++nreg;
                if (visits && m < b) { ++visits[m + 1]; --visits[b + 1]; }
                resume = m + 1;
                continue;
            }
            break;
        }
    }
    if (candidates) *candidates += tried;
    return nreg;
}

}  // namespace

extern "C" {

// The fold over precomputed per-position scores: the k >= 13 paths among
// its callers compute exact f64 ranks only for candidate codes and never
// hold a 4^k table.
int64_t ks_replay_scores(const double* s, const uint8_t* scored, int64_t n,
                         int64_t min_width, double min_score,
                         int64_t base_pos,
                         int64_t* out_beg, int64_t* out_end,
                         double* out_score, int64_t capacity,
                         int64_t* visits, int64_t* candidates) {
    return replay_fold(FlatScores{s, scored}, n, min_width, min_score,
                       base_pos, out_beg, out_end, out_score, capacity,
                       visits, candidates);
}

// The fold that reads its scores from the caller's table: a stretch of
// nrows rows of `block` positions (a power of two), row r's codes and mask
// (int32 and 0/1 bytes) read in place at code_rows[r] and mask_rows[r].
// Every scored code must index `table`.  Returns -1, and folds nothing,
// where block is not a power of two.
int64_t ks_replay_table(const int32_t* const* code_rows,
                        const uint8_t* const* mask_rows, int64_t nrows,
                        int64_t block, const double* table, double threshold,
                        int64_t min_width, double min_score,
                        int64_t base_pos,
                        int64_t* out_beg, int64_t* out_end,
                        double* out_score, int64_t capacity,
                        int64_t* visits, int64_t* candidates) {
    if (block <= 0 || (block & (block - 1))) return -1;
    int32_t shift = 0;
    while ((int64_t(1) << shift) < block) ++shift;
    return replay_fold(TableRows{code_rows, mask_rows, shift, table,
                                 threshold},
                       nrows * block, min_width, min_score, base_pos,
                       out_beg, out_end, out_score, capacity, visits,
                       candidates);
}

// ---------------------------------------------------------------------------
// Transition-score replay over one stretch of candidate positions: the C
// form of the JAX package's spans/tr_pipeline.py replay_tr_segment (the
// reference's find_kmer_tr_lr_regions, src/kmer_spans.c:329-395), same
// control flow and the same f64 operations in the same order.  Per
// position its k-mer code and its seed / extension flags; a seed scores
// max(ks[code], 0), an extension adds ts[code]; any other position closes
// the block.  seq_len
// >= 0: a seed whose k-mer ends within 2 bytes of it ends the replay (the
// reference's :341 quirk); < 0: no such check.  Coordinates: 1-based
// last-base positions offset by base_pos.  Returns total regions (only the
// first `capacity` are written).
// ---------------------------------------------------------------------------
int64_t ks_replay_tr(const int32_t* codes, const uint8_t* seed,
                     const uint8_t* ext, int64_t n, const double* ks,
                     const double* ts, int64_t base_pos, int64_t min_len,
                     int64_t seq_len, int64_t* out_beg, int64_t* out_end,
                     double* out_score, int64_t capacity) {
    int64_t nreg = 0;
    bool in_block = false;
    double score = 0.0, last = 0.0, max_score = 0.0;
    int64_t max_pos = 0, reg_begin = 0;
    auto emit = [&]() {
        if (nreg < capacity) {
            out_beg[nreg] = 1 + reg_begin;
            out_end[nreg] = 1 + max_pos;
            out_score[nreg] = max_score;
        }
        ++nreg;
    };
    int64_t j = 0;
    while (j < n) {
        if (seed[j]) {
            if (seq_len >= 0 && base_pos + j >= seq_len - 2) {
                in_block = false;  // the reference's end-of-sequence abandon
                break;
            }
            const double v = ks[codes[j]];
            score = (0.0 > v) ? 0.0 : v;  // Python's max(v, 0.0)
            last = score;
            max_score = 0.0;
            max_pos = reg_begin = 0;
            if (score > 0.0) {
                max_score = score;
                max_pos = base_pos + j + 1;  // one past the seed's last base
                reg_begin = base_pos + j + 1;
            }
            in_block = true;
            ++j;
        } else if (ext[j]) {
            if (!in_block) {
                score = last = max_score = 0.0;
                max_pos = reg_begin = 0;
                in_block = true;
            }
            const int64_t pos0 = base_pos + j;
            score = last + ts[codes[j]];
            if (score > max_score) {
                max_score = score;
                max_pos = pos0;
            }
            if (score < 0.0) score = 0.0;
            if (last == 0.0 && score > 0.0) {
                max_score = score;
                max_pos = pos0;
                reg_begin = pos0;
            }
            if (score == 0.0 && last > 0.0) {
                if (max_pos - reg_begin >= min_len) emit();
                const int64_t jmp = max_pos - base_pos;  // jump back
                score = last = max_score = 0.0;
                reg_begin = max_pos;
                max_pos = 0;
                j = jmp + 1;
                continue;
            }
            last = score;
            ++j;
        } else {
            if (in_block && max_score > 0.0 && max_pos - reg_begin >= min_len)
                emit();
            in_block = false;
            score = last = max_score = 0.0;
            max_pos = reg_begin = 0;
            ++j;
        }
    }
    if (in_block && max_score > 0.0 && max_pos - reg_begin >= min_len) emit();
    return nreg;
}

// ---------------------------------------------------------------------------
// Multithreaded spectrum count: threads partition the CODE space (each
// walks the whole genome but increments only codes whose top bits fall in
// its partition): one shared table, disjoint writes, no merge.  Returns
// total words counted.
// ---------------------------------------------------------------------------
int64_t ks_count_mt(const uint8_t* nb, int64_t n, int32_t k,
                    int32_t* counts, int32_t nthreads) {
    if (nthreads <= 1) return ks_count(nb, n, k, counts);
    const uint64_t mask = (1ull << (2 * k)) - 1;
    const uint64_t size = 1ull << (2 * k);
    std::vector<int64_t> words_t(nthreads, 0);
    std::vector<std::thread> ths;
    for (int32_t t = 0; t < nthreads; ++t) {
        uint64_t lo = size / nthreads * t;
        uint64_t hi = (t == nthreads - 1) ? size : size / nthreads * (t + 1);
        ths.emplace_back([=, &words_t]() {
            int64_t w = 0;
            int64_t i = 0;
            while (i < n) {
                while (i < n && nb[i] == 4) ++i;
                uint64_t off = 0;
                int32_t have = 0;
                while (i < n && nb[i] != 4) {
                    off = ((off << 2) | nb[i]) & mask;
                    ++i;
                    if (have < k) ++have;
                    if (have >= k && off >= lo && off < hi) {
                        ++counts[off];
                        ++w;
                    }
                }
            }
            words_t[t] = w;
        });
    }
    int64_t words = 0;
    for (auto& th : ths) th.join();
    for (int32_t t = 0; t < nthreads; ++t) words += words_t[t];
    return words;
}

// ---------------------------------------------------------------------------
// The reference's EXACT f64 rank chain over a dense spectrum, without
// an argsort (rank_kmers_w, src/kmer_spans.c:189-202): sort order is
// (count asc, code asc) and equal counts contribute bit-identical f64
// terms, so the fold sequence is determined by the VALUE HISTOGRAM and
// each code's fold position by a per-value running cursor over codes in
// index order.  Zero-count codes sort first and fold 0.0 (exact no-ops),
// so their rank is 0.  Three streaming passes, no sort of the spectrum.
// Values >= VCAP use a small sorted side table (rare).
// ---------------------------------------------------------------------------
int64_t ks_rank_chain(const int32_t* counts, int64_t size, double total,
                      double* ranks) {
    const int64_t VCAP = 1 << 16;
    std::vector<int64_t> h(VCAP, 0);
    std::vector<int64_t> bigv;
    for (int64_t c = 0; c < size; ++c) {
        int32_t v = counts[c];
        if (v <= 0) continue;
        if (v < VCAP) ++h[v]; else bigv.push_back(v);
    }
    std::sort(bigv.begin(), bigv.end());
    // distinct values ascending with multiplicities
    std::vector<int64_t> vals, mult;
    for (int64_t v = 1; v < VCAP; ++v)
        if (h[v]) { vals.push_back(v); mult.push_back(h[v]); }
    for (size_t i = 0; i < bigv.size();) {
        size_t j = i;
        while (j < bigv.size() && bigv[j] == bigv[i]) ++j;
        vals.push_back(bigv[i]); mult.push_back((int64_t)(j - i));
        i = j;
    }
    // the fold over all NONZERO terms, value by value (left-to-right f64,
    // the reference's accumulation order), plus each value group's start
    int64_t nnz = 0;
    for (int64_t m : mult) nnz += m;
    std::vector<double> fold(nnz);     // fold[j] = sum of first j+1 terms
    std::vector<int64_t> start_of(vals.size());
    {
        double acc = 0.0;
        int64_t j = 0;
        for (size_t g = 0; g < vals.size(); ++g) {
            start_of[g] = j;
            // DIVIDE, as the reference does (src/kmer_spans.c:198-200):
            // fl(v * fl(1/total)) differs from fl(v/total) by 1 ulp for
            // some (v, total) and would break bit-identity
            const double t = total > 0 ? (double)vals[g] / total : 0.0;
            for (int64_t r = 0; r < mult[g]; ++r) {
                acc += t;
                fold[j++] = acc;
            }
        }
    }
    // per-value cursors: rank[c] = fold value of the term BEFORE c
    // (exclusive prefix) = fold[pos-1], 0.0 at pos 0
    std::vector<int64_t> cur(VCAP, 0);
    std::unordered_map<int64_t, int64_t> curbig;
    std::unordered_map<int64_t, int64_t> startbig;
    for (size_t g = 0; g < vals.size(); ++g) {
        if (vals[g] < VCAP) cur[vals[g]] = start_of[g];
        else startbig[vals[g]] = start_of[g];
    }
    for (int64_t c = 0; c < size; ++c) {
        int32_t v = counts[c];
        if (v <= 0) { ranks[c] = 0.0; continue; }
        int64_t pos;
        if (v < VCAP) pos = cur[v]++;
        else {
            auto it = curbig.find(v);
            if (it == curbig.end())
                it = curbig.emplace(v, startbig[v]).first;
            pos = it->second++;
        }
        ranks[c] = pos == 0 ? 0.0 : fold[pos - 1];
    }
    return nnz;
}

// ---------------------------------------------------------------------------
// Exact f64 chain ranks for queried MASS values given the sparse value
// histogram (stats/ranks.py chain_ranks_from_mass, in C): the fold over
// all nonzero terms streams once; each query's fold position follows
// from its mass (p = nnz_before(group) + (pm - below(group)) / value).
// Queries are answered in p-order via an internal sort.  Returns 0, or
// -1 if some pm is not a valid cumulative-mass value.
// ---------------------------------------------------------------------------
int64_t ks_chain_from_hist(const int64_t* v_vals, const int64_t* n_codes,
                           int64_t nv, double total,
                           const int64_t* pm, int64_t nq, double* out) {
    if (nv == 0) {
        for (int64_t i = 0; i < nq; ++i) out[i] = 0.0;
        return 0;
    }
    std::vector<int64_t> below(nv + 1), nnzb(nv + 1);
    below[0] = 0; nnzb[0] = 0;
    for (int64_t g = 0; g < nv; ++g) {
        below[g + 1] = below[g] + v_vals[g] * n_codes[g];
        nnzb[g + 1] = nnzb[g] + n_codes[g];
    }
    // fold position per query
    std::vector<std::pair<int64_t, int64_t>> q(nq);  // (p, query index)
    for (int64_t i = 0; i < nq; ++i) {
        int64_t m = pm[i];
        // group g with below[g] <= m < below[g+1] (last g if m == total)
        int64_t lo = 0, hi = nv;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (below[mid + 1] <= m) lo = mid + 1; else hi = mid;
        }
        if (lo >= nv) { if (m != below[nv]) return -1; lo = nv - 1; }
        int64_t r = m - below[lo];
        if (lo >= 0 && r % v_vals[lo]) return -1;
        q[i] = { nnzb[lo] + (lo >= 0 ? r / v_vals[lo] : 0), i };
    }
    std::sort(q.begin(), q.end());
    // stream the fold, recording requested exclusive prefixes
    double acc = 0.0;
    int64_t done = 0, qi = 0;
    while (qi < nq && q[qi].first == 0) out[q[qi++].second] = 0.0;
    for (int64_t g = 0; g < nv && qi < nq; ++g) {
        // divide, not multiply-by-reciprocal: reference bit-identity
        const double t = total > 0 ? (double)v_vals[g] / total : 0.0;
        int64_t left = n_codes[g];
        while (left > 0 && qi < nq) {
            int64_t next = q[qi].first - done;  // terms until next answer
            if (next > left) break;
            for (int64_t s = 0; s < next; ++s) acc += t;
            done += next; left -= next;
            while (qi < nq && q[qi].first == done)
                out[q[qi++].second] = acc;
        }
        for (int64_t s = 0; s < left; ++s) acc += t;
        done += left;
    }
    while (qi < nq && q[qi].first == done) out[q[qi++].second] = acc;
    return 0;
}

// ---------------------------------------------------------------------------
// Cache-staged spectrum count for mid-size tables (k ~ 11..13, table
// 4-256 MB): the plain counter's wall is the random table miss.  Threads
// split the GENOME (disjoint end-position ranges, k-1 warm-up overlap)
// and stage codes into per-high-bits buckets; a full bucket flushes into
// one table slice, which is cache-resident, so updates become cache hits.
// Returns total words counted.
// ---------------------------------------------------------------------------
int64_t ks_count_radix(const uint8_t* nb, int64_t n, int32_t k,
                       int32_t* counts, int32_t nthreads) {
    const uint64_t mask = (1ull << (2 * k)) - 1;
    if (nthreads < 1) nthreads = 1;
    // bucket count scales so a table slice stays ~256 KB (L2-resident):
    // k<=12 -> 256 buckets, k=13 -> 1K, k=14 -> 4K, k=15 -> 16K
    const int32_t bbits = (2 * k > 24) ? (2 * k - 16) : 8;
    const int32_t NBUCK = 1 << bbits;
    const int32_t bshift = 2 * k - bbits;
    // staging sized so a thread's buffers stay ~16 MB
    const int64_t STAGE = std::max<int64_t>(
        128, (16ll << 20) / 4 / NBUCK);
    // flushes add into the SHARED output table with atomic increments:
    // no per-thread 4^k copies to zero and merge; slices are cache-resident
    // so the atomics are cheap and cross-thread conflicts are rare
    std::vector<int64_t> words_t(nthreads, 0);
    std::vector<std::thread> ths;
    for (int32_t t = 0; t < nthreads; ++t) {
        const int64_t lo = n / nthreads * t;
        const int64_t hi = (t == nthreads - 1) ? n : n / nthreads * (t + 1);
        ths.emplace_back([=, &words_t]() {
            std::vector<uint32_t> stage((int64_t)NBUCK * STAGE);
            std::vector<int32_t> fill(NBUCK, 0);
            int64_t w = 0;
            // warm up k-1 before lo so k-mers ENDING in [lo, hi) count
            int64_t i = lo - (k - 1);
            if (i < 0) i = 0;
            uint64_t off = 0;
            int32_t have = 0;
            auto flush = [&](int32_t b) {
                int32_t* dst = counts + ((int64_t)b << bshift);
                const uint32_t* src = stage.data() + (int64_t)b * STAGE;
                const uint64_t m = (1ull << bshift) - 1;
                for (int32_t j = 0; j < fill[b]; ++j)
                    __atomic_fetch_add(&dst[src[j] & m], 1,
                                       __ATOMIC_RELAXED);
                fill[b] = 0;
            };
            while (i < hi) {
                if (nb[i] == 4) { have = 0; off = 0; ++i; continue; }
                off = ((off << 2) | nb[i]) & mask;
                ++i;
                if (have < k) ++have;
                if (have >= k && i - 1 >= lo) {
                    ++w;
                    const int32_t b = (int32_t)(off >> bshift);
                    stage[(int64_t)b * STAGE + fill[b]] = (uint32_t)off;
                    if (++fill[b] == STAGE) flush(b);
                }
            }
            for (int32_t b = 0; b < NBUCK; ++b) flush(b);
            words_t[t] = w;
        });
    }
    for (auto& th : ths) th.join();
    int64_t words = 0;
    for (int32_t t = 0; t < nthreads; ++t) words += words_t[t];
    return words;
}

// ---------------------------------------------------------------------------
// SPARSE spectrum for wide k (16 <= k <= 31): distinct int64 codes +
// counts, ascending — the spectrum of the native backend's wide caller
// (a dense table would be 68 GB at k=17).  Threads partition the CODE
// space by top bits (each re-walks the genome, as ks_count_mt — the
// rolling walk is cheap), sort their partitions independently, and the
// partitions concatenate ordered.  Returns the number of distinct codes
// (only the first `cap` entries are written — the caller's buffers are
// safe at cap = n since distinct <= words <= n); *n_words_out gets the
// total counted k-mers.
// ---------------------------------------------------------------------------
int64_t ks_count_sparse(const uint8_t* nb, int64_t n, int32_t k,
                        int64_t* ucodes, int64_t* ucounts, int64_t cap,
                        int64_t* n_words_out, int32_t nthreads) {
    const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    if (nthreads < 1) nthreads = 1;
    std::vector<std::vector<int64_t>> part(nthreads);
    std::vector<int64_t> words_t(nthreads, 0);
    std::vector<std::thread> ths;
    for (int32_t t = 0; t < nthreads; ++t) {
        const uint64_t lo = (mask + 1) / nthreads * t;
        const uint64_t hi = (t == nthreads - 1)
            ? mask + 1 : (mask + 1) / nthreads * (t + 1);
        ths.emplace_back([=, &part, &words_t]() {
            std::vector<int64_t>& v = part[t];
            int64_t w = 0;
            int64_t i = 0;
            while (i < n) {
                while (i < n && nb[i] == 4) ++i;
                uint64_t off = 0;
                int32_t have = 0;
                while (i < n && nb[i] != 4) {
                    off = ((off << 2) | nb[i]) & mask;
                    ++i;
                    if (have < k) ++have;
                    if (have >= k) {
                        ++w;
                        if (off >= lo && off < hi)
                            v.push_back((int64_t)off);
                    }
                }
            }
            std::sort(v.begin(), v.end());
            words_t[t] = w;
        });
    }
    for (auto& th : ths) th.join();
    *n_words_out = words_t.empty() ? 0 : words_t[0];
    int64_t nd = 0;
    for (int32_t t = 0; t < nthreads; ++t) {
        const std::vector<int64_t>& v = part[t];
        for (size_t i = 0; i < v.size();) {
            size_t j = i;
            while (j < v.size() && v[j] == v[i]) ++j;
            if (nd < cap) {
                ucodes[nd] = v[i];
                ucounts[nd] = (int64_t)(j - i);
            }
            ++nd;
            i = j;
        }
    }
    return nd;
}

// ---------------------------------------------------------------------------
// Exact integer mass (rank numerator) for SORTED UNIQUE query codes,
// plus the count-value histogram: the k >= 13 replay path never
// materializes a 4^k f64 rank table; stats/ranks.py chain_ranks_from_mass
// folds the (sparse) value histogram and each query's mass locates its
// fold position exactly (src/kmer_spans.c:189-202: stable sort by count
// then index).
//
//   mass(q) = below(v) + v * eqbelow(q),   v = counts[q]
//   below(v) = total mass at count values < v
//   eqbelow(q) = # codes with count v and index < q
//
// Pass 1 builds the value histogram (dense below VCAP, hash map above);
// pass 2 walks codes up to the last query maintaining per-value running
// counters.  vh_vals/vh_ncodes receive the distinct count values (asc)
// and their code multiplicities; the return value is the number of
// distinct values (the caller retries with a larger cap if return > cap;
// pm is always fully written).
// ---------------------------------------------------------------------------
int64_t ks_mass_of_codes(const int32_t* counts, int64_t size,
                         const int64_t* q, int64_t nq, int64_t* pm,
                         int64_t* vh_vals, int64_t* vh_ncodes,
                         int64_t cap) {
    const int64_t VCAP = 1 << 16;
    std::vector<int64_t> dense(VCAP, 0);
    std::unordered_map<int64_t, int64_t> sparse;
    for (int64_t c = 0; c < size; ++c) {
        int64_t v = counts[c];
        if (v <= 0) { if (v == 0) ++dense[0]; continue; }
        if (v < VCAP) ++dense[v]; else ++sparse[v];
    }
    std::vector<int64_t> vals;
    for (int64_t v = 0; v < VCAP; ++v)
        if (dense[v] > 0) vals.push_back(v);
    for (auto& kv : sparse) vals.push_back(kv.first);
    std::sort(vals.begin(), vals.end());
    // below(v): cumulative mass of values strictly below v
    std::unordered_map<int64_t, int64_t> below;
    {
        int64_t acc = 0;
        for (int64_t v : vals) {
            below[v] = acc;
            int64_t ncodes = (v < VCAP) ? dense[v] : sparse[v];
            acc += v * ncodes;
        }
    }
    // pass 2: eqbelow via running per-value counters, queries in order
    std::vector<int64_t> run_dense(VCAP, 0);
    std::unordered_map<int64_t, int64_t> run_sparse;
    int64_t c = 0;
    for (int64_t i = 0; i < nq; ++i) {
        int64_t qq = q[i];
        for (; c < qq; ++c) {
            int64_t v = counts[c];
            if (v <= 0) continue;
            if (v < VCAP) ++run_dense[v]; else ++run_sparse[v];
        }
        int64_t v = counts[qq];
        int64_t eq = (v < VCAP) ? run_dense[v] : run_sparse[v];
        pm[i] = (v > 0 ? below[v] : 0) + v * eq;
    }
    int64_t nvals = (int64_t)vals.size();
    for (int64_t i = 0; i < nvals && i < cap; ++i) {
        int64_t v = vals[i];
        vh_vals[i] = v;
        vh_ncodes[i] = (v < VCAP) ? dense[v] : sparse[v];
    }
    return nvals;
}

}  // extern "C"
