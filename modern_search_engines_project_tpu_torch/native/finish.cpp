// Native host finishing: one batch's dedup by base url and two-tier domain
// diversification in one call.
//
// The engine ranks a batch on the device and copies back, per query, up to
// k_ret candidate rows (doc, fused score, normalised BM25, window, valid).
// This pass selects each query's top_k rows from them exactly as the
// reference package's rerank.finish_positions does over numpy arrays:
//   * map doc indices to artifact order through the index's permutation;
//   * keep rows with 0 <= doc < n_docs_real;
//   * keep the first row of each query-stripped url (base code);
//   * two-tier diversification (rerank.hybrid_diversification): the high
//     tier is every domain with a row at or above the threshold, each tier
//     keeps one row a domain, the medium tier fills `top_k - len(high)` with
//     Python's slice semantics, and dropped rows backfill with their scores
//     shifted below the last kept one.
// Scores are compared in double after promotion from float32, orders are
// numpy's stable argsort of the negated scores (NaN last), so the selected
// rows and their scores are bit-equal to the numpy pass
// (tests/test_torch_finish_native.py).
//
// ctypes calls a CDLL function with the interpreter lock released, so two
// threads may finish their batches at once: the pass keeps no state
// between calls and allocates its scratch per call.
//
// Built by native/native_finish.py at first use:
//   g++ -O2 -std=c++17 -shared -fPIC -o libmse_finish.so finish.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <iterator>
#include <numeric>
#include <vector>

namespace {

// argsort(-x, kind="stable") order: descending, NaN after every number.
inline bool before(double a, double b) {
  return a > b || (std::isnan(b) && !std::isnan(a));
}

// len(x[:stop]) for a sequence of length n.
inline int64_t py_head(int64_t n, int64_t stop) {
  return stop >= 0 ? std::min(n, stop) : std::max<int64_t>(0, n + stop);
}

template <class Key>
bool sorted_by_score(const int32_t* a, const int32_t* e, const Key& key) {
  return std::is_sorted(
      a, e, [&](int32_t x, int32_t y) { return before(key[x], key[y]); });
}

// out = argsort(-key[a ++ b], kind="stable") applied to a ++ b.  Both runs
// are sorted already wherever the device ranked its rows by score: then a
// stable merge (ties from `a` first) gives that order in one pass.
template <class Key>
void sorted_concat(const int32_t* a, size_t na, const int32_t* b, size_t nb,
                   const Key& key, std::vector<int32_t>& out) {
  auto cmp = [&](int32_t x, int32_t y) { return before(key[x], key[y]); };
  out.clear();
  if (sorted_by_score(a, a + na, key) && sorted_by_score(b, b + nb, key)) {
    std::merge(a, a + na, b, b + nb, std::back_inserter(out), cmp);
    return;
  }
  out.insert(out.end(), a, a + na);
  out.insert(out.end(), b, b + nb);
  std::stable_sort(out.begin(), out.end(), cmp);
}

}  // namespace

extern "C" {

// Returns 0, or: 1 a domain or base code outside its table, 2 a query
// selecting more rows than `width`, 3 a backfill with nothing kept.
// Inputs are row-major [n_rows, k_ret]; outputs [n_rows, width] with the
// first out_count[b] entries of row b set.  perm (n_perm entries) and
// doc_chunk_start (n_docs_real entries) may be null: no permutation, and
// windows outside [0, n_wins) left as they are.
int msetpu_finish_batch(
    int64_t n_rows, int64_t k_ret, const int32_t* doc, const float* vals,
    const float* old, const int32_t* win, const uint8_t* valid,
    const int64_t* perm, int64_t n_perm, const int64_t* domain_codes,
    int64_t n_domains, const int64_t* base_codes, int64_t n_bases,
    const int32_t* doc_chunk_start, int64_t n_docs_real, int64_t n_wins,
    int64_t top_k, double threshold, int diversification, int64_t width,
    int64_t* out_count, int64_t* out_doc, double* out_score, float* out_old,
    int32_t* out_win) {
  // per-code stamps: code c is marked for query b when stamp[c] == b + 1
  std::vector<int32_t> base_seen(n_bases, 0);
  std::vector<int32_t> dom_high(diversification ? n_domains : 0, 0);
  std::vector<int32_t> dom_seen(diversification ? n_domains : 0, 0);
  std::vector<int32_t> row, keep, hi_keep, hi_drop, me_keep, me_drop, fin,
      rest, order, seq;
  std::vector<int64_t> dd;
  std::vector<double> s, fs;
  for (auto* v : {&row, &keep, &hi_keep, &hi_drop, &me_keep, &me_drop, &fin,
                  &rest, &order, &seq})
    v->reserve(k_ret);
  dd.reserve(k_ret);
  s.reserve(k_ret);
  fs.reserve(k_ret);
  std::vector<int32_t> dom(k_ret);

  for (int64_t b = 0; b < n_rows; ++b) {
    const int32_t stamp = static_cast<int32_t>(b + 1);
    const int64_t o = b * k_ret;
    int64_t nv = 0;
    for (int64_t i = 0; i < k_ret; ++i) nv += valid[o + i] != 0;

    // the first nv rows, in artifact order, that name a real doc
    row.clear();
    dd.clear();
    for (int64_t i = 0; i < nv; ++i) {
      int64_t d = doc[o + i];
      if (perm != nullptr && n_perm > 0 && valid[o + i])
        d = perm[std::clamp<int64_t>(d, 0, n_perm - 1)];
      if (d >= 0 && d < n_docs_real) {
        row.push_back(static_cast<int32_t>(i));
        dd.push_back(d);
      }
    }
    // dedup by base url: the first row of each code, in row order
    keep.clear();
    for (size_t j = 0; j < dd.size(); ++j) {
      const int64_t c = base_codes[dd[j]];
      if (c < 0 || c >= n_bases) return 1;
      if (base_seen[c] != stamp) {
        base_seen[c] = stamp;
        keep.push_back(static_cast<int32_t>(j));
      }
    }
    const int64_t k = static_cast<int64_t>(keep.size());
    s.resize(k);
    for (int64_t t = 0; t < k; ++t) s[t] = vals[o + row[keep[t]]];

    fin.clear();
    fs.clear();
    int64_t cnt;
    if (!diversification) {
      cnt = py_head(k, top_k);
      for (int64_t t = 0; t < cnt; ++t) {
        fin.push_back(static_cast<int32_t>(t));
        fs.push_back(s[t]);
      }
      order.resize(cnt);
      std::iota(order.begin(), order.end(), 0);
    } else {
      for (int64_t t = 0; t < k; ++t) {
        const int64_t c = domain_codes[dd[keep[t]]];
        if (c < 0 || c >= n_domains) return 1;
        dom[t] = static_cast<int32_t>(c);
        if (s[t] >= threshold) dom_high[c] = stamp;
      }
      // a domain is in one tier; each tier keeps its first row a domain
      hi_keep.clear();
      hi_drop.clear();
      me_keep.clear();
      me_drop.clear();
      for (int64_t t = 0; t < k; ++t) {
        const int32_t c = dom[t];
        const bool first = dom_seen[c] != stamp;
        dom_seen[c] = stamp;
        if (dom_high[c] == stamp)
          (first ? hi_keep : hi_drop).push_back(static_cast<int32_t>(t));
        else
          (first ? me_keep : me_drop).push_back(static_cast<int32_t>(t));
      }
      const int64_t remaining = top_k - static_cast<int64_t>(hi_keep.size());
      sorted_concat(hi_keep.data(), hi_keep.size(), me_keep.data(),
                    py_head(static_cast<int64_t>(me_keep.size()), remaining),
                    s, fin);
      for (int32_t t : fin) fs.push_back(s[t]);
      const size_t n_fin = fin.size();
      if (static_cast<int64_t>(n_fin) < top_k) {
        sorted_concat(hi_drop.data(), hi_drop.size(), me_drop.data(),
                      me_drop.size(), s, rest);
        if (!rest.empty()) {
          if (fin.empty()) return 3;
          const int64_t add = std::min<int64_t>(
              top_k - static_cast<int64_t>(fin.size()),
              static_cast<int64_t>(rest.size()));
          const double delta = s[rest[0]] - fs.back() + 1e-4;
          for (int64_t a = 0; a < add; ++a) {
            const double v = s[rest[a]] - delta;
            fin.push_back(rest[a]);
            fs.push_back(0.0 >= v ? 0.0 : v);  // np.maximum(0.0, v)
          }
        }
      }
      // kept rows, then backfilled ones: two runs sorted by score
      seq.resize(fin.size());
      std::iota(seq.begin(), seq.end(), 0);
      sorted_concat(seq.data(), n_fin, seq.data() + n_fin, seq.size() - n_fin,
                    fs, order);
      cnt = py_head(static_cast<int64_t>(order.size()), top_k);
    }

    if (cnt > width) return 2;
    out_count[b] = cnt;
    const int64_t w0 = b * width;
    for (int64_t i = 0; i < cnt; ++i) {
      const int32_t j = keep[fin[order[i]]];
      const int64_t r = o + row[j];
      int32_t w = win[r];
      if (doc_chunk_start != nullptr && (w < 0 || w >= n_wins))
        w = doc_chunk_start[dd[j]];
      out_doc[w0 + i] = dd[j];
      out_score[w0 + i] = fs[order[i]];
      out_old[w0 + i] = old[r];
      out_win[w0 + i] = w;
    }
  }
  return 0;
}

}  // extern "C"
