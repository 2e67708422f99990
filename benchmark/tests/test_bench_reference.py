"""The reference against a brute-force float64 computation on a tiny
corpus, and its encoders against another formulation of the same
arithmetic."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import corpus as corpus_mod, queries, reference, weights
from benchmark.tests import tiny

ENGINE = {"top_k_retrieval": 200, "top_k_reranking": 20, "smoothing": 0.15,
          "positional_max_boost": 0.10, "positional_max_decay": 0.05,
          "diversification": True, "diversification_threshold": 0.8,
          "diversification_max_per_domain": 1}


@pytest.fixture(scope="module")
def corp():
    return corpus_mod.make_corpus(5, tiny.CORPUS, "cpu")


def brute_force(corp, query, qvec, e):
    """Loops over documents and windows in float64, as the reference
    system describes its scoring (reranker_api.py)."""
    vocab = {w: i for i, w in enumerate(corp.words)}
    terms = {}
    for w in reference.processed(query).split():
        terms[vocab[w]] = terms.get(vocab[w], 0) + 1
    score = {}
    for t, c in terms.items():
        for p in range(corp.indptr[t], corp.indptr[t + 1]):
            d = int(corp.post_docs[p])
            score[d] = score.get(d, 0.0) + float(corp.post_impact[p]) * c
    cand = sorted(score, key=lambda d: -score[d])[: e["top_k_retrieval"]]
    lo, hi = min(score[d] for d in cand), max(score[d] for d in cand)
    rows = [(d, corp.doc_chunk_start[d] + k) for d in cand
            for k in range(corp.doc_n_chunks[d])]
    sims = {w: float(np.dot(corp.chunk_emb[w].astype(np.float64),
                            qvec.astype(np.float64))) for _, w in rows}
    slo, shi = min(sims.values()), max(sims.values())
    docs = []
    for d in cand:
        n = int(corp.doc_n_chunks[d])
        ws = [int(corp.doc_chunk_start[d]) + k for k in range(n)]
        vals = [(sims[w] - slo) / (shi - slo) * 0.85
                + (score[d] - lo) / (hi - lo) * 0.15 for w in ws]
        best = vals.index(max(vals))
        if n > 1:
            adj = 0.10 - 0.15 * best / (n - 1)
            vals[best] = min(1.0, max(0.0, vals[best] + adj))
        best = vals.index(max(vals))
        docs.append((vals[best], d, ws[best]))
    docs.sort(key=lambda x: -x[0])
    # two tiers, one document a domain in each, the medium tier filling up
    high_dom = {corp.domains[d] for s, d, _ in docs if s >= 0.8}
    high = [x for x in docs if x[0] >= 0.8 or corp.domains[x[1]] in high_dom]
    med = [x for x in docs if x not in high]

    def cap(xs):
        seen, keep = set(), []
        for x in xs:
            if corp.domains[x[1]] not in seen:
                seen.add(corp.domains[x[1]])
                keep.append(x)
        return keep

    hk = cap(high)
    final = sorted(hk + cap(med)[: e["top_k_reranking"] - len(hk)],
                   key=lambda x: -x[0])
    return final[: e["top_k_reranking"]]


def test_stage2_matches_brute_force(corp):
    ref = reference.Reference(corp, ENGINE)
    rng = np.random.default_rng(0)
    qs = queries.draw_queries(3, corp.words, corp.dfs, 8,
                              {"min_terms": 1, "max_terms": 5})
    for q in qs:
        v = rng.standard_normal(tiny.CORPUS["dim"])
        v /= np.linalg.norm(v)
        got = ref.stage2(q, v)
        want = brute_force(corp, q, v, ENGINE)
        assert len(got.docs) == len(want)
        np.testing.assert_allclose(got.scores, [s for s, _, _ in want],
                                   atol=1e-12)
        assert got.docs.tolist() == [d for _, d, _ in want]
        assert got.wins.tolist() == [w for _, _, w in want]


def test_query_terms_refuse_words_outside_the_model():
    vocab = {"tuebingen": 0, "zaq": 1}
    assert reference.query_terms("zaq zaq", vocab) == {1: 2, 0: 1}
    assert reference.query_terms("Tübingen zaq", vocab) == {0: 1, 1: 1}
    with pytest.raises(ValueError):
        reference.query_terms("castle", vocab)


def _other_trunk(w, cfg, ids, mask):
    """The same encoder through torch's LayerNorm and attention."""
    B, L = ids.shape
    D, H = cfg["dim"], cfg["n_heads"]
    hd = D // H
    ln = lambda x, p: F.layer_norm(x, (D,), p["scale"], p["bias"], 1e-6)
    inv = 1.0 / (cfg["rope_base"] ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    ang = torch.outer(torch.arange(L, dtype=torch.float64), inv)
    rot = torch.polar(torch.ones_like(ang), ang).to(torch.complex128)

    def rope(x):
        xc = torch.view_as_complex(x.reshape(B, L, H, hd // 2, 2).contiguous())
        return torch.view_as_real(xc * rot[None, :, None, :]).reshape(B, L, H, hd)

    x = w["tok"]["embedding"][ids]
    for i in range(cfg["n_layers"]):
        b = w[f"block{i}"]
        q, k, v = (ln(x, b["ln1"]) @ b["attn"]["qkv"]["kernel"]).split(D, -1)
        q, k = rope(q.reshape(B, L, H, hd)), rope(k.reshape(B, L, H, hd))
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            v.reshape(B, L, H, hd).transpose(1, 2),
            attn_mask=(mask[:, None, None, :] > 0))
        x = x + o.transpose(1, 2).reshape(B, L, D) @ b["attn"]["proj"]["kernel"]
        g, u = (ln(x, b["ln2"]) @ b["mlp"]["wi"]["kernel"]).chunk(2, -1)
        x = x + (F.gelu(g, approximate="tanh") * u) @ b["mlp"]["wo"]["kernel"]
    return ln(x, w["ln_f"])


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else v.double()
            for k, v in tree.items()}


def test_encoder_trunk_matches_another_formulation():
    cfg = dict(tiny.ENCODER)
    w = _f64(weights.draw_tree(9, cfg, False, "cpu"))
    ids = torch.randint(0, cfg["vocab_size"], (3, 7), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 7, dtype=torch.long)
    mask[1, 5:] = 0
    got = reference.trunk(w, cfg, ids, mask)
    want = _other_trunk(w, cfg, ids, mask)
    keep = mask.bool()
    # the reference's RoPE table is float32, as the program's is
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=1e-6)


def test_weights_repeat_from_the_seed_and_are_served_type_values():
    cfg = dict(tiny.ENCODER)
    a = weights.draw_tree(4, cfg, False, "cpu")
    b = weights.draw_tree(4, cfg, False, "cpu")
    c = weights.draw_tree(5, cfg, False, "cpu")
    k = a["block0"]["attn"]["qkv"]["kernel"]
    assert torch.equal(k, b["block0"]["attn"]["qkv"]["kernel"])
    assert not torch.equal(k, c["block0"]["attn"]["qkv"]["kernel"])
    assert torch.equal(k, k.to(torch.bfloat16).float())
    assert k.std().item() == pytest.approx(1 / math.sqrt(cfg["dim"]), rel=0.1)


def test_corpus_repeats_from_the_seed(corp):
    again = corpus_mod.make_corpus(5, tiny.CORPUS, "cpu")
    for f in ("indptr", "post_docs", "post_impact", "chunk_emb", "doc_n_chunks"):
        assert np.array_equal(getattr(corp, f), getattr(again, f))
    assert corp.window_texts[7] == again.window_texts[7]
    assert corp.window_texts[7].startswith("w7 ")
    norms = np.linalg.norm(corp.chunk_emb, axis=1)
    assert np.all(np.abs(norms - 1) < 1e-2)
