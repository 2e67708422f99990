"""The plain reference of ``/api/search``, in NumPy and plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's corpus arrays and draws the weights again from the
seed, and works out again what the program derives from them (term ids,
BM25 sums, the encoders' forwards, the fusion, the per-document window,
the selection, deduplication and diversification).

  * Query text -> terms: lowercase, the Tuebingen spellings folded, the
    anchor appended, words counted.  The benchmark's traffic holds only
    the query model's made-up words, which the program's analyzer keeps
    as they are; any other word raises, since this reference has no copy
    of the analyzer's stemmer.
  * BM25: each query term's postings summed in float64.  The candidates
    are the ``top_k_retrieval`` best matched documents.  Documents whose
    score lies within ``BM25_TIE`` of the last candidate's are "near":
    float32 sums may rank either way, so a served near document is judged
    like a candidate.
  * Encoders: the bi-encoder and the cross-encoder forward in float32
    (TF32 off) with the drawn weights: two-pass LayerNorm with eps 1e-6,
    interleaved RoPE, softmax attention over the unmasked keys, a tanh
    GeGLU, mean pooling and an L2 norm; the cross-encoder scores
    ``[CLS] query [SEP] window [SEP]`` by its CLS row and head.
  * Stage 2: cosine of the query with each candidate window in float64,
    min-max normalised over the candidates' windows, fused 0.85 / 0.15
    with the min-max normalised BM25 score, the best window of a document
    raised by the positional boost (+``boost`` first window, down to
    -``decay`` last), the best window taken again; documents by score,
    one per stripped URL, then the two-tier domain diversification
    (reranker_api.py:196-236).

``cast``, when given, rounds every operand of the encoders' weight
products and of the window cosines: the lower-precision control.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.corpus import Corpus

BM25_TIE = 1e-5  # relative band around the last candidate's BM25 score
WINDOW_TIE = 0.01  # windows this close before the boost may each take it

_TUEBINGEN = re.compile(r"t(?:ü|ue|u)binge[nr]s?", re.IGNORECASE)
_TERM = re.compile(r"[a-zA-ZäöüÄÖÜßàâéèêëíìîïóòôúùûñç]+")
_MODEL_WORD = re.compile(r"(?:tuebingen|z[a-z]+q)")
_TOKEN = re.compile(r"[a-zA-Z0-9äöüÄÖÜßàâéèêëíìîïóòôúùûñç]+|[^\sa-zA-Z0-9]")
PAD, CLS, SEP, N_SPECIAL = 0, 1, 2, 4


def processed(query: str) -> str:
    """The query as search preprocessing hands it on."""
    q = _TUEBINGEN.sub("tuebingen", query.lower())
    return q if "tuebingen" in q else q + " tuebingen"


def query_terms(query: str, vocab: Dict[str, int]) -> Dict[int, int]:
    """term id -> count in the processed query."""
    counts: Dict[int, int] = {}
    for w in _TERM.findall(processed(query)):
        if not _MODEL_WORD.fullmatch(w):
            raise ValueError(f"word {w!r} is outside the query model")
        tid = vocab.get(w, -1)
        if tid >= 0:
            counts[tid] = counts.get(tid, 0) + 1
    return counts


class HashTokens:
    """Word-level FNV-1a 64 hashing ids of the encoders' tokenizer."""

    def __init__(self, vocab_size: int):
        self.size = vocab_size
        self.cache: Dict[str, int] = {}

    def word(self, w: str) -> int:
        tid = self.cache.get(w)
        if tid is None:
            h = 0xCBF29CE484222325
            for b in w.lower().encode("utf-8"):
                h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
            tid = self.cache[w] = N_SPECIAL + h % (self.size - N_SPECIAL)
        return tid

    def ids(self, text: str) -> List[int]:
        return [self.word(w) for w in _TOKEN.findall(text)]


# ---- the encoders -----------------------------------------------------------


def _layer_norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * p["scale"] + p["bias"]


def _rope(cfg: dict, L: int, device):
    hd = cfg["dim"] // cfg["n_heads"]
    inv = 1.0 / (cfg["rope_base"] ** (np.arange(0, hd, 2) / hd))
    f = np.outer(np.arange(L), inv)
    return (torch.tensor(np.cos(f), dtype=torch.float32, device=device),
            torch.tensor(np.sin(f), dtype=torch.float32, device=device))


def _rotate(x, cos, sin):
    """x [B, L, H, hd]: rotate interleaved (even, odd) pairs."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], -1).reshape(x.shape)


def _mm(cast):
    if cast is None:
        return torch.matmul
    return lambda a, b: torch.matmul(cast(a), cast(b))


def trunk(w: dict, cfg: dict, ids, mask, cast=None):
    """Token ids and mask [B, L] -> final-LayerNorm states [B, L, dim]."""
    mm = _mm(cast)
    B, L = ids.shape
    D, H = cfg["dim"], cfg["n_heads"]
    hd = D // H
    cos, sin = _rope(cfg, L, ids.device)
    keep = mask[:, None, None, :] > 0
    x = w["tok"]["embedding"][ids]
    for i in range(cfg["n_layers"]):
        b = w[f"block{i}"]
        h = _layer_norm(x, b["ln1"])
        q, k, v = mm(h, b["attn"]["qkv"]["kernel"]).split(D, dim=-1)
        q = _rotate(q.reshape(B, L, H, hd), cos, sin).transpose(1, 2)
        k = _rotate(k.reshape(B, L, H, hd), cos, sin).transpose(1, 2)
        v = v.reshape(B, L, H, hd).transpose(1, 2)
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~keep, float("-inf")), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, L, D)
        x = x + mm(o, b["attn"]["proj"]["kernel"])
        gate, up = mm(_layer_norm(x, b["ln2"]), b["mlp"]["wi"]["kernel"]).chunk(2, -1)
        x = x + mm(F.gelu(gate, approximate="tanh") * up, b["mlp"]["wo"]["kernel"])
    return _layer_norm(x, w["ln_f"])


def _pad(rows: List[List[int]], device):
    L = max(len(r) for r in rows)
    ids = torch.zeros(len(rows), L, dtype=torch.long)
    mask = torch.zeros(len(rows), L, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r)
        mask[i, : len(r)] = 1
    return ids.to(device), mask.to(device)


@torch.no_grad()
def embed(w: dict, cfg: dict, tok: HashTokens, texts: Sequence[str],
          device, cast=None, chunk: int = 64) -> np.ndarray:
    """Unit bi-encoder embeddings [n, dim] of ``texts``, float32."""
    out = []
    body = cfg["max_len"] - 2
    for i in range(0, len(texts), chunk):
        rows = [[CLS] + tok.ids(t)[:body] + [SEP] for t in texts[i : i + chunk]]
        ids, mask = _pad(rows, device)
        x = trunk(w, cfg, ids, mask, cast)
        m = mask[..., None].float()
        pooled = (x * m).sum(1) / m.sum(1)
        out.append(F.normalize(pooled, dim=-1).cpu().numpy())
    return np.concatenate(out)


@torch.no_grad()
def cross_scores(w: dict, cfg: dict, tok: HashTokens, query: str,
                 texts: Sequence[str], device, cast=None,
                 chunk: int = 128) -> np.ndarray:
    """Sigmoid relevance [n] of (query, text) pairs, float32."""
    q = tok.ids(query)
    L = cfg["max_len"]
    out = []
    for i in range(0, len(texts), chunk):
        rows = []
        for t in texts[i : i + chunk]:
            joint = q + [SEP] + tok.ids(t)[: max(L - 3 - len(q), 0)]
            rows.append([CLS] + joint[: L - 2] + [SEP])
        ids, mask = _pad(rows, device)
        cls = trunk(w, cfg, ids, mask, cast)[:, 0]
        mm = _mm(cast)
        h = F.gelu(mm(cls, w["head_hidden"]["kernel"]) + w["head_hidden"]["bias"],
                   approximate="tanh")
        logit = mm(h, w["head_out"]["kernel"])[:, 0] + w["head_out"]["bias"][0]
        out.append(torch.sigmoid(logit).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def fp8_rows(x: np.ndarray) -> np.ndarray:
    """Round each row to float8 e4m3 with a scale of its own."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    s = t.abs().amax(1, keepdim=True).clamp(min=1e-30) / 448.0
    return ((t / s).to(torch.float8_e4m3fn).to(torch.float32) * s).numpy()


# ---- stage 2 ---------------------------------------------------------------


@dataclasses.dataclass
class Stage2:
    """One query's reference answer and what judging a served row needs.

    The positional boost goes to a document's best window before the
    boost; where two windows tie within ``WINDOW_TIE`` before it, either
    may take it, so each such window is a scenario of its own."""

    docs: np.ndarray  # [n] the answer's documents, best first
    scores: np.ndarray  # [n] their scores
    wins: np.ndarray  # [n] their windows
    row: Dict[int, int]  # candidate or near document -> row
    pre: np.ndarray  # [rows, max_chunks] window values before the boost
    adj: np.ndarray  # [rows, max_chunks] the boost a window would take
    start: np.ndarray  # [rows] the document's first window

    def scenarios(self, doc: int):
        """(window values, document score) for each window of ``doc``
        that may take the boost; None for a document that is no
        candidate."""
        r = self.row.get(int(doc))
        if r is None:
            return None
        pre = self.pre[r]
        out = []
        for t in np.nonzero(pre >= pre.max() - WINDOW_TIE)[0]:
            v = pre.copy()
            v[t] = min(1.0, max(0.0, v[t] + self.adj[r, t]))
            out.append((v, float(v.max())))
        return out

    def slot(self, doc: int, win: int) -> Optional[int]:
        """``win``'s place among ``doc``'s windows, or None."""
        r = self.row.get(int(doc))
        if r is None:
            return None
        k = int(win) - int(self.start[r])
        if 0 <= k < self.pre.shape[1] and np.isfinite(self.pre[r, k]):
            return k
        return None


def diversify(scores: np.ndarray, domains: np.ndarray, top_k: int,
              threshold: float):
    """Two-tier domain diversification over rows sorted by score: returns
    (rows, scores) of the answer, best first."""
    high = scores >= threshold
    high_domains = set(domains[high].tolist())
    in_high = [bool(h) or d in high_domains
               for h, d in zip(high.tolist(), domains.tolist())]

    def one_per_domain(rows):
        seen, keep, drop = set(), [], []
        for r in rows:
            (drop if domains[r] in seen else keep).append(r)
            seen.add(domains[r])
        return keep, drop

    hk, hd = one_per_domain([r for r in range(len(scores)) if in_high[r]])
    mk, md = one_per_domain([r for r in range(len(scores)) if not in_high[r]])
    final = [(r, float(scores[r])) for r in hk + mk[: top_k - len(hk)]]
    final.sort(key=lambda x: -x[1])
    rest = sorted(hd + md, key=lambda r: -scores[r])
    if len(final) < top_k and rest:
        add = rest[: top_k - len(final)]
        delta = float(scores[add[0]]) - final[-1][1] + 1e-4
        final += [(r, max(0.0, float(scores[r]) - delta)) for r in add]
    final.sort(key=lambda x: -x[1])
    final = final[:top_k]
    return (np.array([r for r, _ in final], np.int64),
            np.array([s for _, s in final], np.float64))


class Reference:
    """The reference search over ``corpus`` under a configuration's
    ``engine`` block (the program's ``Config`` names)."""

    def __init__(self, corpus: Corpus, engine: dict,
                 bank_cast: Optional[Callable] = None):
        self.c = corpus
        self.e = engine
        self.vocab = {w: i for i, w in enumerate(corpus.words)}
        self.domain = np.unique(np.array(corpus.domains), return_inverse=True)[1]
        self.base = np.unique(np.array([u.split("?", 1)[0] for u in corpus.urls]),
                              return_inverse=True)[1]
        self.bank_cast = bank_cast
        if engine["diversification_max_per_domain"] != 1:
            raise ValueError("the reference diversifies one per domain")

    def bm25(self, query: str) -> np.ndarray:
        """Keyed float64 scores [n_docs]: the score where the document
        matched and scored >= 0, else -1."""
        c = self.c
        s = np.zeros(c.n_docs, np.float64)
        hit = np.zeros(c.n_docs, bool)
        for tid, qtf in query_terms(query, self.vocab).items():
            a, b = int(c.indptr[tid]), int(c.indptr[tid + 1])
            d = c.post_docs[a:b]  # one posting a (term, doc)
            s[d] += c.post_impact[a:b].astype(np.float64) * qtf
            hit[d] = True
        return np.where(hit & (s >= 0), s, -1.0)

    def stage2(self, query: str, qvec: np.ndarray) -> Stage2:
        c, e = self.c, self.e
        keyed = self.bm25(query)
        order = np.argsort(-keyed, kind="stable")
        n = min(e["top_k_retrieval"], int((keyed >= 0).sum()))
        core = order[:n]
        if n == 0:
            empty = np.zeros(0, np.int64)
            return Stage2(empty, np.zeros(0), empty, {}, np.zeros((0, 1)),
                          np.zeros((0, 1)), empty)
        last = keyed[core[-1]]
        near = order[n:][keyed[order[n:]] >= last - BM25_TIE * max(1.0, abs(last))]
        cand = np.concatenate([core, near])
        lo, hi = float(keyed[core].min()), float(keyed[core].max())
        old = (keyed[cand] - lo) / (hi - lo) if hi > lo else np.zeros(len(cand))

        cnt = c.doc_n_chunks[cand].astype(np.int64)
        start = c.doc_chunk_start[cand].astype(np.int64)
        owner = np.repeat(np.arange(len(cand)), cnt)
        slot = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        rows = start[owner] + slot
        emb = c.chunk_emb[rows]
        q = np.asarray(qvec, np.float64)
        if self.bank_cast is not None:
            emb = self.bank_cast(emb)
            q = self.bank_cast(q[None].astype(np.float32))[0].astype(np.float64)
        sims = emb.astype(np.float64) @ q
        in_core = owner < n
        lo_c, hi_c = sims[in_core].min(), sims[in_core].max()
        new = (sims - lo_c) / (hi_c - lo_c) if hi_c > lo_c else np.zeros_like(sims)
        sm = e["smoothing"]
        fused = new * (1.0 - sm) + old[owner] * sm

        width = int(cnt.max())
        pre = np.full((len(cand), width), -np.inf)
        pre[owner, slot] = fused
        b_, d_ = e["positional_max_boost"], e["positional_max_decay"]
        k = np.arange(width)[None, :]
        adj = np.where(cnt[:, None] > 1,
                       b_ - (b_ + d_) * k / np.maximum(cnt[:, None] - 1, 1), 0.0)
        r = np.arange(len(cand))
        best = np.argmax(pre, axis=1)  # the first maximum
        vals = pre.copy()
        vals[r, best] = np.clip(pre[r, best] + adj[r, best], 0.0, 1.0)
        best = np.argmax(vals, axis=1)
        score = vals[r, best]

        # the answer: candidates only, by score, one per stripped URL
        by = np.argsort(-score[:n], kind="stable")
        _, first = np.unique(self.base[cand[by]], return_index=True)
        by = by[np.sort(first)]
        if e["diversification"]:
            sel, sc = diversify(score[by], self.domain[cand[by]],
                                e["top_k_reranking"],
                                e["diversification_threshold"])
        else:
            sel = np.arange(min(e["top_k_reranking"], len(by)))
            sc = score[by][sel]
        pick = by[sel]
        return Stage2(
            docs=cand[pick], scores=sc, wins=start[pick] + best[pick],
            row={int(d): i for i, d in enumerate(cand.tolist())},
            pre=pre, adj=adj, start=start,
        )
