"""The port's native host finishing pass (``native/finish.cpp`` through
``native/native_finish.py``) against the reference package's numpy pass.

The oracle is the engine's per-query loop as the reference package runs
it: artifact order through the permutation, valid rows naming a real doc,
then ``finish_positions`` (dedup by base url, two-tier diversification),
and besides it the dataclass pipeline (``dedup_by_base_url`` +
``hybrid_diversification``).  Batches are fuzzed with the pools of
test_rerank_fast.py (ties, duplicate base urls, few domains) plus rows with
no valid candidate, -1 docs, docs past the real ones, a permutation and
windows outside the index.  Selected docs, windows and scores must be
bit-equal, also when two threads finish batches at once.
"""

import sys
import threading

import numpy as np
import pytest

from modern_search_engines_project_tpu.retrieval.rerank import (
    RankedDoc,
    dedup_by_base_url,
    finish_positions,
    hybrid_diversification,
)
from modern_search_engines_project_tpu_torch.native import native_finish
from modern_search_engines_project_tpu_torch.native.native_finish import (
    Finisher,
)


class Index:
    """Per-doc codes of a fake index: ``n_real`` real docs, domain and
    base-url codes, each doc's first window, an optional permutation
    from ranked (padded) doc order to artifact order."""

    def __init__(self, rng, n_real, n_pad, n_domains, n_bases, n_wins,
                 permute):
        self.n_real, self.n_pad, self.n_wins = n_real, n_pad, n_wins
        self.dom = rng.integers(0, n_domains, n_real).astype(np.int64)
        self.base = rng.integers(0, n_bases, n_real).astype(np.int64)
        self.start = np.sort(rng.integers(0, n_wins, n_real)).astype(np.int32)
        # padded slots map past the real docs, as the index's permutation
        self.perm = (np.concatenate([rng.permutation(n_real),
                                     np.arange(n_real, n_pad)]).astype(np.int64)
                     if permute else None)

    def finisher(self):
        return Finisher(self.perm, self.dom, self.base, self.start,
                        n_docs_real=self.n_real, n_wins=self.n_wins)


def make_batch(rng, idx, B, k_ret, tie_prob=0.3, empty_prob=0.15,
               bad_doc_prob=0.1, scatter_prob=0.1, unsorted_prob=0.15):
    """(doc, vals, old, win, valid), each [B, k_ret], as rank_batch gives
    them: scores descending with exact ties, valid rows first (in a few
    rows valid flags scattered: the first ``sum(valid)`` rows are taken,
    and only valid ones are permuted; in a few scores out of order)."""
    doc = np.full((B, k_ret), -1, np.int32)
    vals = np.full((B, k_ret), -np.inf, np.float32)
    old = np.zeros((B, k_ret), np.float32)
    win = np.full((B, k_ret), -1, np.int32)
    valid = np.zeros((B, k_ret), bool)
    for b in range(B):
        nv = 0 if rng.uniform() < empty_prob else int(rng.integers(1, k_ret + 1))
        s = rng.uniform(0.0, 1.0, nv)
        for i in range(1, nv):
            if rng.uniform() < tie_prob:
                s[i] = s[rng.integers(0, i)]
        vals[b, :nv] = np.sort(s.astype(np.float32))[::-1]
        if rng.uniform() < unsorted_prob:  # the pass sorts what it must
            vals[b, :nv] = rng.permutation(vals[b, :nv])
        d = rng.integers(0, idx.n_pad, nv)
        bad = rng.uniform(size=nv) < bad_doc_prob
        d[bad] = rng.choice([-1, idx.n_real, idx.n_pad + 3], bad.sum())
        doc[b, :nv] = d
        old[b, :nv] = rng.uniform(0.0, 1.0, nv)
        win[b, :nv] = rng.integers(-2, idx.n_wins + 2, nv)
        valid[b, :nv] = True
        if rng.uniform() < scatter_prob:
            valid[b] = rng.permutation(valid[b])
    return doc, vals, old, win, valid


def oracle(idx, raw, n_real, top_k, thr, div, first_window):
    """The reference engine's loop: per query (docs, scores, old, wins)."""
    doc, vals, old, win, valid = raw
    if idx.perm is not None:
        doc = np.where(valid, idx.perm[np.clip(doc, 0, len(idx.perm) - 1)],
                       doc)
    out = []
    for b, nv in enumerate(valid.sum(axis=1).tolist()[:n_real]):
        db = doc[b, :nv]
        pos0 = np.nonzero((db >= 0) & (db < idx.n_real))[0]
        db = db[pos0]
        sel, sc = finish_positions(vals[b, :nv][pos0], idx.dom[db],
                                   idx.base[db], top_k,
                                   relevance_threshold=thr,
                                   diversification=div)
        w = win[b, :nv][pos0][sel]
        if first_window:
            bad = (w < 0) | (w >= idx.n_wins)
            w = np.where(bad, idx.start[db[sel]], w)
        out.append((db[sel], sc, old[b, :nv][pos0][sel], w))
    return out


def dataclass_oracle(idx, raw, b, top_k, thr, div):
    """The dataclass pipeline over query b: (doc, score) pairs."""
    doc, vals, _old, _win, valid = raw
    rows = []
    for i in range(int(valid[b].sum())):
        d = int(doc[b, i])
        if idx.perm is not None and valid[b, i]:
            d = int(idx.perm[np.clip(d, 0, len(idx.perm) - 1)])
        if 0 <= d < idx.n_real:
            rows.append(RankedDoc(
                doc_id=d, url=f"https://x{idx.base[d]}.de/p"
                + ("?q=1" if d % 3 == 0 else ""),
                title="", similarity_score=float(vals[b, i]),
                original_similarity=0.0, window_index=0,
                domain=f"dom{idx.dom[d]}"))
    rows = dedup_by_base_url(rows)
    rows = (hybrid_diversification(rows, relevance_threshold=thr, top_k=top_k)
            if div else rows[:top_k])
    return [(r.doc_id, r.similarity_score) for r in rows]


def assert_same(got, want):
    assert len(got.count) == len(want)
    for b, (d, s, o, w) in enumerate(want):
        n = int(got.count[b])
        assert n == len(d), b
        assert got.doc[b, :n].tolist() == d.tolist(), b
        assert got.score[b, :n].tobytes() == np.asarray(s, np.float64).tobytes(), b
        assert got.old[b, :n].tobytes() == np.asarray(o, np.float32).tobytes(), b
        assert got.win[b, :n].tolist() == w.tolist(), b


def random_case(seed):
    rng = np.random.default_rng(seed)
    n_real = int(rng.integers(1, 400))
    idx = Index(rng, n_real, n_real + int(rng.integers(0, 40)),
                n_domains=int(rng.integers(1, 30)),
                n_bases=int(rng.integers(1, max(2, n_real))),
                n_wins=int(rng.integers(1, 3 * n_real + 1)),
                permute=bool(rng.integers(0, 2)))
    k_ret = int(rng.integers(1, 300))
    B = int(rng.integers(1, 9))
    raw = make_batch(rng, idx, B, k_ret)
    n_real_q = int(rng.integers(0, B + 1))
    top_k = int(rng.choice([rng.integers(1, 150), k_ret, k_ret + 7,
                            rng.integers(1, 4), -int(rng.integers(1, 5)), 0]))
    pool = raw[1][raw[4]]
    thr = (float(rng.choice(pool)) if pool.size and rng.uniform() < 0.4
           else float(rng.uniform(0.0, 1.0)))  # a score at the threshold
    return idx, raw, n_real_q, top_k, thr


@pytest.mark.parametrize("div", [True, False])
@pytest.mark.parametrize("seed", range(30))
def test_fuzz_matches_reference(seed, div):
    idx, raw, n_real, top_k, thr = random_case(seed)
    fin = idx.finisher()
    for first_window in (False, True):
        got = fin.run(raw, n_real, top_k, thr, div, first_window)
        assert_same(got, oracle(idx, raw, n_real, top_k, thr, div,
                                first_window))
    if top_k > 0:  # the dataclass pipeline wants scores in order
        for b in range(n_real):
            nv = int(raw[4][b].sum())
            if np.any(np.diff(raw[1][b, :nv]) > 0):
                continue
            n = int(got.count[b])
            assert list(zip(got.doc[b, :n].tolist(),
                            got.score[b, :n].tolist())) == dataclass_oracle(
                idx, raw, b, top_k, thr, div)


def single(idx, scores, docs, wins=None):
    """A batch of one query over the given candidate rows."""
    n = len(scores)
    wins = np.arange(n) if wins is None else wins
    return (np.asarray([docs], np.int32),
            np.asarray([scores], np.float32),
            np.linspace(1.0, 0.0, n, dtype=np.float32)[None],
            np.asarray([wins], np.int32),
            np.ones((1, n), bool))


def fixed_index(dom, base, n_wins=50, perm=None):
    idx = Index(np.random.default_rng(0), len(dom), len(dom), 1, 1, n_wins,
                False)
    idx.dom = np.asarray(dom, np.int64)
    idx.base = np.asarray(base, np.int64)
    idx.perm = perm
    return idx


@pytest.mark.parametrize("case", [
    "backfill", "flood", "negative_remaining", "duplicate_bases",
    "all_invalid", "no_valid_rows", "ties", "permuted", "top_k_above_pool",
    "nan", "scattered_valid", "at_threshold",
])
def test_branch(case):
    """Each branch of the pass on a hand-made query, both ways of
    diversification, against the reference loop."""
    n = 30
    dom = list(range(n))
    base = list(range(n))
    scores = np.linspace(0.99, 0.5, n)
    docs = list(range(n))
    perm = None
    top_k = 10
    thr = 0.8
    if case == "backfill":  # five rows of one domain: backfill past the cap
        dom, scores, docs, top_k = [0] * 5, [0.95, 0.9, 0.85, 0.5, 0.4], \
            list(range(5)), 4
        base = list(range(5))
    elif case == "flood":  # one domain holds every row
        dom = [7] * n
    elif case == "negative_remaining":  # more high domains than top_k
        scores = np.linspace(0.99, 0.81, n)
        top_k = 5
    elif case == "duplicate_bases":
        base = [i // 3 for i in range(n)]
    elif case == "all_invalid":
        docs = [-1] * 10 + [n + 5] * (n - 10)
    elif case == "no_valid_rows":
        docs = []
        scores = []
    elif case == "ties":
        scores = np.repeat([0.9, 0.85, 0.3], n // 3)
        dom = [i % 4 for i in range(n)]
    elif case == "permuted":
        perm = np.random.default_rng(1).permutation(n).astype(np.int64)
        dom = [i % 5 for i in range(n)]
    elif case == "top_k_above_pool":
        dom = [i % 3 for i in range(n)]
        top_k = 100
    elif case == "scattered_valid":  # invalid rows among the first sum(valid)
        perm = np.random.default_rng(2).permutation(n).astype(np.int64)
        docs = [i if i % 3 else -1 for i in range(n)]
    elif case == "at_threshold":  # a score equal to the threshold is high:
        # its domain's row takes the one slot before the first medium row
        scores, dom, base, docs, top_k, thr = [0.5, 0.75, 0.6], [1, 0, 2], \
            [0, 1, 2], [0, 1, 2], 1, 0.75
    elif case == "nan":  # NaN ranks after every number, as numpy's sort
        scores = np.where(np.arange(n) % 4 == 1, np.nan, scores)
        dom = [i % 6 for i in range(n)]
    idx = fixed_index(dom, base, perm=perm)
    if case == "no_valid_rows":
        raw = (np.full((2, 4), -1, np.int32), np.zeros((2, 4), np.float32),
               np.zeros((2, 4), np.float32), np.zeros((2, 4), np.int32),
               np.zeros((2, 4), bool))
    else:
        raw = single(idx, scores, docs)
    if case == "scattered_valid":
        raw[4][0] = raw[0][0] >= 0
    for div in (True, False):
        want = oracle(idx, raw, len(raw[0]), top_k, thr, div, True)
        got = idx.finisher().run(raw, len(raw[0]), top_k, thr, div, True)
        assert_same(got, want)
    if case == "backfill":
        assert got.count[0] == 4 and list(got.score[0]) == sorted(
            got.score[0], reverse=True)
    if case in ("all_invalid", "no_valid_rows"):
        assert not got.count.any()


def same(a, b):
    """Two finished batches select the same rows, bit for bit."""
    if a.count.tobytes() != b.count.tobytes():
        return False
    return all(x[q, :n].tobytes() == y[q, :n].tobytes()
               for q, n in enumerate(a.count.tolist())
               for x, y in zip(a[1:], b[1:]))


def test_two_threads_at_once_give_the_sequential_results():
    """The pass keeps no state between calls: threads finishing different
    batches at once, with the interpreter switching often, get what one
    thread gets alone."""
    cases = [random_case(100 + i) for i in range(8)]
    fins = [c[0].finisher() for c in cases]
    serial = [f.run(raw, n, k, thr, True, True)
              for f, (_, raw, n, k, thr) in zip(fins, cases)]
    errors, done = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(order):
        try:
            for _ in range(25):
                for i in order:
                    _, raw, n, k, thr = cases[i]
                    got = fins[i].run(raw, n, k, thr, True, True)
                    if not same(got, serial[i]):
                        errors.append(i)
            done.append(order)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(o,))
                   for o in (range(8), range(7, -1, -1), range(8), range(8))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(done) == 4


def test_bad_input_raises_before_the_call():
    idx = fixed_index([0, 1], [0, 1])
    fin = idx.finisher()
    raw = single(idx, [0.9, 0.8], [0, 1])
    with pytest.raises(ValueError, match="ragged"):
        fin.run(raw[:4] + (raw[4][:, :1],), 1, 5, 0.8, True, True)
    with pytest.raises(ValueError, match="queries"):
        fin.run(raw, 2, 5, 0.8, True, True)
    with pytest.raises(ValueError, match="codes"):
        Finisher(None, [0], [0, 1], [0, 0], n_docs_real=2, n_wins=4)


def test_library_builds_outside_the_package():
    so = native_finish.build()
    assert so == native_finish.library_path() and so.exists()
    assert so.parent.parent == native_finish.BUILD_ROOT
    assert not list(native_finish.SRC.parent.glob("*.so"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "finish.cpp"
    bad.write_text("int main( {")
    monkeypatch.setattr(native_finish, "SRC", bad)
    monkeypatch.setattr(native_finish, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_finish.build()
