"""The torch port's search assistant against the reference package on the
CPU: the word vocabulary, the causal decoder LM, the greedy decode, the
summarizers and the HTTP client.

Each case feeds the same inputs (made with numpy from fixed seeds, the
reference's own overfit toy, or the committed ``runs/summarizer-real``
checkpoint) through the reference's modules and the port's.

Tolerances.  With ``dtype="float32"`` both sides run the same arithmetic
with no bf16 rounding, and logits agree to 1e-5 of their scale (measured
1e-6): this holds the structure (causal mask, RoPE, the gather before the
head, the tied head) exactly.  In bf16, each side rounds the residual
stream to bf16 after arithmetic done in another order, so an ulp now and
then compounds over the layers: logits agree to 2^-5 of their scale
(measured 2^-6.5 at 2 layers, 64 wide, and 2^-6 at 4 layers, 256 wide),
and a single causal attention to a bf16 ulp of its scale (2^-7).  A greedy
decode is held token for token where the model has real margins (the
overfit toy, the trained checkpoint); on random weights it is held by
teacher forcing: logits at each generated position within the tolerance,
tokens equal up to the first step whose top-2 margin is under twice it.
"""

import dataclasses
import http.server
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu.models import decoder as ref
from modern_search_engines_project_tpu.models import word_vocab as ref_vocab
from modern_search_engines_project_tpu.models.encoder import (
    _rope_angles as ref_rope_angles,
)
from modern_search_engines_project_tpu.serving import assistant as ref_asst
from modern_search_engines_project_tpu_torch.models import decoder as port
from modern_search_engines_project_tpu_torch.models import encoder as port_enc
from modern_search_engines_project_tpu_torch.models import word_vocab as port_vocab
from modern_search_engines_project_tpu_torch.serving import assistant as port_asst
from test_summarizer import _overfit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = os.path.join(ROOT, "runs", "summarizer-real")
BF16_RTOL = 2.0 ** -7
LOGIT_RTOL = 2.0 ** -5
F32_RTOL = 1e-5
SMALL = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, mlp_ratio=4,
             max_len=32)

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU forwards here are many small ops: one intra-op
    thread keeps them from spinning against the suite's other workers
    (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(cfg, seed):
    rng = np.random.default_rng(seed)
    return port.init_decoder_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32))


def _close(got, want, rtol):
    """Agree to ``rtol`` of the output's scale (its max magnitude)."""
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _ids_mask(seed, B, L, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    return ids, (np.arange(L)[None] < lens[:, None]).astype(np.int32)


# ---- WordVocab: the reference's cases on both ------------------------------


@pytest.mark.parametrize("texts,probe", [
    (["the castle overlooks the river neckar"], "castle river"),
    (["alpha beta"], "gamma"),
    (["alpha beta"], "alpha beta"),
    (["castle , river ."], "castle, river."),
    (["Tübingen: die Burg! über 1477 Straße", "b a b c b"], "b c über x ?"),
])
def test_word_vocab_matches_reference(texts, probe):
    r = ref_vocab.WordVocab.build(texts)
    p = port_vocab.WordVocab.build(texts)
    assert p.words == r.words
    ids = p.encode(probe)
    assert ids == r.encode(probe)
    assert p.decode(ids) == r.decode(ids)
    with_eos = ids[:1] + [port_vocab.EOS_ID] + ids[1:]
    assert p.decode(with_eos) == r.decode(with_eos)
    assert p.decode([0, 1, 2, 4, 10_000] + ids) == r.decode(
        [0, 1, 2, 4, 10_000] + ids)
    assert (port_vocab.PAD_ID, port_vocab.BOS_ID, port_vocab.SEP_ID,
            port_vocab.EOS_ID, port_vocab.UNK_ID, port_vocab.N_SPECIAL) == (
        ref_vocab.PAD_ID, ref_vocab.BOS_ID, ref_vocab.SEP_ID,
        ref_vocab.EOS_ID, ref_vocab.UNK_ID, ref_vocab.N_SPECIAL)


def test_word_vocab_save_load_across_packages(tmp_path):
    v = ref_vocab.WordVocab.build(["the castle overlooks the river", "ä ö ü"])
    v.save(str(tmp_path / "ref" / "vocab.json"))
    back = port_vocab.WordVocab.load(str(tmp_path / "ref" / "vocab.json"))
    assert back.words == v.words
    back.save(str(tmp_path / "port" / "vocab.json"))
    assert (tmp_path / "port" / "vocab.json").read_bytes() == (
        tmp_path / "ref" / "vocab.json").read_bytes()
    assert len(back) == len(v) and back.index == v.index


# ---- modules ---------------------------------------------------------------


@pytest.mark.parametrize("B,L", [(2, 16), (3, 32)])
def test_causal_attention_matches_reference(B, L):
    cfg = port.DecoderConfig(**SMALL)
    tree = _tree(cfg, 0)
    att = port_enc.Attention(cfg, causal=True)
    att.load_state_dict(
        {k[len("blocks.0.attn."):]: v
         for k, v in port.decoder_params_from_reference(tree, "cpu").items()
         if k.startswith("blocks.0.attn.")})
    x = np.random.default_rng(1).standard_normal((B, L, cfg.dim))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).bfloat16()
    _, mask = _ids_mask(2, B, L, 10)
    rope = ref_rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
    want = ref.CausalAttention(ref.DecoderConfig(**SMALL)).apply(
        {"params": tree["block0"]["attn"]}, jx, jnp.asarray(mask > 0),
        jnp.asarray(rope, jnp.float32))
    got = att(tx, torch.from_numpy(mask > 0),
              torch.tensor(rope, dtype=torch.float32))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_RTOL)
    # the causal flag only adds the triangle: row l ignores keys after l
    x2 = tx.clone()
    x2[:, -1] += 1.0
    got2 = att(x2, torch.from_numpy(mask > 0),
               torch.tensor(rope, dtype=torch.float32))
    assert torch.equal(got2[:, :-1], got[:, :-1])


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL),
                                        ("bfloat16", LOGIT_RTOL)])
def test_decoder_lm_matches_reference(dtype, rtol):
    """Logits at every position and at gathered positions (a negative one
    counts from the end), in the output dtype of the reference."""
    cfg = port.DecoderConfig(**SMALL, dtype=dtype)
    tree = _tree(cfg, 3)
    rm = ref.DecoderLM(ref.DecoderConfig(**dataclasses.asdict(cfg)))
    pm = port.build_decoder(cfg, tree, "cpu")
    ids, mask = _ids_mask(4, 3, 32, cfg.vocab_size)
    pos = np.array([[31, 5], [9, 0], [0, -1]], np.int32)
    for positions in (None, pos):
        want = rm.apply({"params": tree}, ids, mask, positions=None
                        if positions is None else jnp.asarray(positions))
        with torch.no_grad():
            got = pm(torch.from_numpy(ids), torch.from_numpy(mask), None
                     if positions is None else torch.from_numpy(positions))
        assert str(got.dtype) == f"torch.{want.dtype}"
        _close(got, want, rtol)


def test_decoder_full_width_seeded():
    """4 layers, 256 wide, 32,000 ids (``runs/summarizer-real``'s shape),
    weights drawn from a numpy seed: one position a row, as a decode
    step projects it."""
    cfg = port.DecoderConfig()
    tree = _tree(cfg, 5)
    rm = ref.DecoderLM(ref.DecoderConfig(**dataclasses.asdict(cfg)))
    pm = port.build_decoder(cfg, tree, "cpu")
    ids, mask = _ids_mask(6, 2, cfg.max_len, cfg.vocab_size)
    pos = mask.sum(1, keepdims=True).astype(np.int32) - 1
    want = rm.apply({"params": tree}, ids, mask, positions=jnp.asarray(pos))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(mask),
                 torch.from_numpy(pos))
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, want, LOGIT_RTOL)


def test_seeded_decoder_tree_has_the_reference_form():
    cfg = port.DecoderConfig(**SMALL)
    want = ref.DecoderLM(ref.DecoderConfig(**SMALL)).init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32),
        jnp.ones((1, 32), jnp.int32))["params"]
    got = _tree(cfg, 0)
    ref_leaves = {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_leaves_with_path(want)}
    port_leaves = dict(port_enc._leaves_with_keys(got))
    assert sorted(ref_leaves) == sorted(port_leaves)
    for k, r in ref_leaves.items():
        assert port_leaves[k].dtype == r.dtype, k
        assert port_leaves[k].shape == r.shape, k


# ---- the greedy decode -------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """The reference's overfit toy (``tests/test_summarizer.py``), trained
    in JAX, its parameters carried across as numpy."""
    texts = [
        "the castle overlooks the river and the old town",
        "boats race on the neckar every summer",
        "castle summary text", "race summary text",
    ]
    vocab = ref_vocab.WordVocab.build(texts, max_words=200)
    cfg = ref.DecoderConfig(
        vocab_size=len(vocab), dim=64, n_layers=2, n_heads=2, max_len=32
    )
    pairs = [
        ("the castle overlooks the river", "castle summary"),
        ("boats race on the neckar", "race summary"),
    ]
    model, params, loss = _overfit(cfg, vocab, pairs)
    tree = jax.tree_util.tree_map(np.asarray, params)
    pcfg = port.DecoderConfig(**dataclasses.asdict(cfg))
    return (ref.GreedyGenerator(model, params, cfg),
            port.GreedyGenerator(port.build_decoder(pcfg, tree, "cpu"),
                                 device="cpu"),
            model, params, cfg, vocab, pairs, texts, loss)


def test_greedy_decode_matches_reference_on_overfit_toy(trained):
    rg, pg, _, _, cfg, vocab, pairs, texts, loss = trained
    assert loss < 0.05
    prompts = [[ref_vocab.BOS_ID] + vocab.encode(s) + [ref_vocab.SEP_ID]
               for s, _ in pairs]
    # 31 tokens: cut to L - max_new
    long = ([ref_vocab.BOS_ID] + vocab.encode(" ".join(texts * 3))[:29]
            + [ref_vocab.SEP_ID])
    assert len(long) > cfg.max_len - 8
    cases = [(prompts, 8), ([long], 8),
             # max_new > L: the cut keeps len - 8 tokens (none of the
             # short prompt) and pos reaches L at step 9; the later steps
             # emit with ids, mask and pos frozen
             ([long, prompts[0]], 40), (prompts, 0)]
    for ps, max_new in cases:
        want = rg.generate(ps, max_new=max_new)
        got = pg.generate(ps, max_new=max_new)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape == (len(ps), max_new)
        np.testing.assert_array_equal(got, want)
    for (src, tgt), row in zip(pairs, pg.generate(prompts, max_new=8)):
        assert vocab.decode(row) == tgt
    dev = pg.generate_device(prompts, max_new=8)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32


def _teacher_forced(model, prompt, toks, L):
    """Logits [n, V] f32 at the positions that emitted ``toks`` (a
    decode of ``prompt`` that stayed inside L), from one forward over the
    prompt and the decode."""
    seq = list(prompt) + list(toks)
    assert len(seq) <= L
    ids = np.zeros((1, L), np.int32)
    ids[0, : len(seq)] = seq
    mask = (np.arange(L)[None] < len(seq)).astype(np.int32)
    pos = np.arange(len(prompt) - 1, len(seq) - 1, dtype=np.int32)[None]
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.from_numpy(ids).to(dev),
                    torch.from_numpy(mask).to(dev),
                    torch.from_numpy(pos).to(dev))
    return out[0].float().cpu().numpy()


def test_greedy_decode_random_weights_teacher_forced():
    """Random weights have near-ties: the port's decode is held against
    the reference's logits at the reference's own tokens, and tokens are
    equal up to the first step whose top-2 margin is under 2 x tol."""
    cfg = port.DecoderConfig(vocab_size=16, dim=64, n_layers=2, n_heads=4,
                             max_len=48)
    tree = _tree(cfg, 7)
    rcfg = ref.DecoderConfig(**dataclasses.asdict(cfg))
    rm = ref.DecoderLM(rcfg)
    rg = ref.GreedyGenerator(rm, tree, rcfg)
    pm = port.build_decoder(cfg, tree, "cpu")
    pg = port.GreedyGenerator(pm, device="cpu")
    rng = np.random.default_rng(8)
    matched = []
    for n in (3, 12, 25):
        prompt = [1] + rng.integers(5, 16, n).tolist() + [2]
        want = rg.generate([prompt], max_new=16)[0]
        got = pg.generate([prompt], max_new=16)[0]
        seq = list(prompt) + list(want)
        ids = np.zeros((1, cfg.max_len), np.int32)
        ids[0, : len(seq)] = seq
        mask = (np.arange(cfg.max_len)[None] < len(seq)).astype(np.int32)
        pos = np.arange(len(prompt) - 1, len(seq) - 1, dtype=np.int32)[None]
        ref_logits = np.asarray(rm.apply(
            {"params": tree}, ids, mask, positions=jnp.asarray(pos)
        ).astype(jnp.float32))[0]
        port_logits = _teacher_forced(pm, prompt, want, cfg.max_len)
        tol = LOGIT_RTOL * float(np.abs(ref_logits).max())
        assert np.abs(port_logits - ref_logits).max() <= tol
        top2 = np.sort(ref_logits, axis=-1)[:, -2:]
        near = np.nonzero(top2[:, 1] - top2[:, 0] < 2 * tol)[0]
        first = int(near[0]) if near.size else len(want)
        # up to there, the reference's own teacher forcing gives its decode
        # back (at an exact tie its scan and this forward may part), and so
        # does the port's decode
        np.testing.assert_array_equal(ref_logits.argmax(-1)[:first],
                                      want[:first])
        np.testing.assert_array_equal(got[:first], want[:first])
        matched.append(first)
    assert max(matched) >= 4, matched  # the check held some real steps


def test_decode_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.DecoderConfig(**SMALL)
    model = port.build_decoder(cfg, _tree(cfg, 0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.GreedyGenerator(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_asst.GenerativeSummarizer.from_checkpoint(REAL)
    assert port.GreedyGenerator(model, device="cpu").device.type == "cpu"


# ---- summarizers ---------------------------------------------------------------

WINDOWS = [
    "The University of Tübingen is one of the oldest universities in "
    "Germany, founded in 1477. It is known for medicine, law and theology.",
    "Hohentübingen Castle overlooks the old town and the Neckar river. "
    "Today it houses the museum of the university with ancient art.",
    "Punting on the Neckar is a popular summer activity in Tübingen. The "
    "annual punting race attracts thousands of visitors. "
    "Punting on the Neckar is a popular summer activity in Tübingen.",
    "The chocolate festival ChocolART takes place every December on the "
    "market square.",
    "",
    "short. too short! tiny?",
    "x" * 5000,
]


@pytest.mark.parametrize("query,windows,kw", [
    ("tübingen castle", WINDOWS, {}),
    ("punting race", WINDOWS[2:], {}),
    ("university law", WINDOWS * 3, {"max_sentences": 2, "max_chars": 90}),
    ("xyz", WINDOWS[4:6], {}),
    ("castle", [], {}),
    ("castle", [""], {}),
])
def test_extractive_summarizer_matches_reference(query, windows, kw):
    want = ref_asst.ExtractiveSummarizer(**kw).generate_summary(query, windows)
    got = port_asst.ExtractiveSummarizer(**kw).generate_summary(query, windows)
    assert got == want


def test_generative_summarizer_matches_reference_on_toy(trained, tmp_path):
    """The toy saved by the reference's ``save_decoder`` (f16 on disk),
    read by the port's reader: the same text for decodes and fallbacks;
    a checkpoint with no vocab raises."""
    _, _, model, params, cfg, vocab, pairs, _, _ = trained
    path = str(tmp_path / "dec")
    ref.save_decoder(params, cfg, path, vocab=vocab)
    rs = ref_asst.GenerativeSummarizer.from_checkpoint(path)
    ps = port_asst.GenerativeSummarizer.from_checkpoint(path, device="cpu")
    assert ps.gen.device.type == "cpu" and ps.vocab.words == vocab.words
    for q, ws in (("castle", ["the castle overlooks the river"]),
                  ("race", ["boats race on the neckar", "castle summary"]),
                  ("castle", WINDOWS[:2]), ("castle", []), ("x", [""])):
        assert ps.generate_summary(q, ws) == rs.generate_summary(q, ws)
    prompt = [ref_vocab.BOS_ID] + vocab.encode(pairs[1][0]) + [ref_vocab.SEP_ID]
    np.testing.assert_array_equal(ps.gen.generate([prompt], max_new=8),
                                  rs.gen.generate([prompt], max_new=8))
    ref.save_decoder(params, cfg, str(tmp_path / "novocab"), vocab=None)
    with pytest.raises(ValueError):
        port_asst.GenerativeSummarizer.from_checkpoint(
            str(tmp_path / "novocab"), device="cpu")


def test_device_errors_propagate_not_the_fallback(trained):
    """An error from the decode is raised, never answered by the
    extractive fallback (which is for degenerate decodes only)."""
    pg, vocab = trained[1], trained[5]
    s = port_asst.GenerativeSummarizer(pg.model, vocab, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("device fault")

    s.gen.generate = broken
    with pytest.raises(RuntimeError, match="device fault"):
        s.generate_summary("castle", ["the castle overlooks the river"])


@pytest.fixture(scope="module")
def real():
    """``runs/summarizer-real``, read once by each package."""
    return (ref_asst.GenerativeSummarizer.from_checkpoint(REAL),
            port_asst.GenerativeSummarizer.from_checkpoint(REAL, device="cpu"))


def test_real_checkpoint_config_and_vocab(real):
    rs, ps = real
    assert dataclasses.asdict(ps.cfg) == dataclasses.asdict(rs.cfg)
    assert dataclasses.asdict(ps.cfg) == dataclasses.asdict(
        port.DecoderConfig())
    assert ps.vocab.words == rs.vocab.words


@pytest.mark.parametrize("query,windows", [
    ("university of tübingen", [WINDOWS[0], "tax law seminar for students "
                                "of the faculty of law", WINDOWS[2]]),
    ("tübingen castle", WINDOWS[:3]),
])
def test_real_checkpoint_summary_matches_reference(real, query, windows,
                                                   monkeypatch):
    """The trained model's decode, token for token (it has real margins),
    and the summary text: one decode a side, its prompt and tokens
    recorded on the way."""
    rs, ps = real
    seen = {}
    for name, s in (("ref", rs), ("port", ps)):
        def spy(prompts, max_new, _gen=s.gen.generate, _name=name):
            out = _gen(prompts, max_new=max_new)
            seen[_name] = (prompts, np.asarray(out))
            return out
        monkeypatch.setattr(s.gen, "generate", spy)
    got = ps.generate_summary(query, windows)
    assert got == rs.generate_summary(query, windows)
    assert got
    (p_prompts, p_toks), (r_prompts, r_toks) = seen["port"], seen["ref"]
    assert p_prompts == r_prompts == [ps.prompt_ids(query, windows)]
    ids = p_prompts[0]
    assert ids[0] == ref_vocab.BOS_ID and ids[-1] == ref_vocab.SEP_ID
    assert len(ids) <= rs.cfg.max_len - rs.max_new - 2
    assert p_toks.shape == (1, 48)
    np.testing.assert_array_equal(p_toks, r_toks)


# ---- the HTTP client -------------------------------------------------------------


class _Stub(http.server.BaseHTTPRequestHandler):
    """Records each POST body; answers with the server's ``reply``."""

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        self.server.bodies.append(
            (self.path, self.headers.get("Content-Type"),
             json.loads(self.rfile.read(n))))
        status, body = self.server.reply
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if status in (301, 302, 307):
            self.send_header("Location", "/elsewhere")
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def stub(monkeypatch):
    for k in ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY",
              "HTTPS_PROXY", "ALL_PROXY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Stub)
    srv.bodies = []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}/generate_summary"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("reply,want", [
    ("<think>plan the answer</think>  Tübingen is a university town. ",
     "Tübingen is a university town."),
    ("no reasoning prefix", "no reasoning prefix"),
    ("a</think>b</think>c", "b</think>c"),
])
def test_http_client_payload_and_think_strip(stub, reply, want):
    srv, url = stub
    srv.reply = (200, {"response": reply})
    windows = [f"window {i} " + "w" * 4100 for i in range(12)]
    port_c = port_asst.HttpLlmClient(url)
    assert port_c.timeout == ref_asst.HttpLlmClient(url).timeout == 30.0
    got = port_c.generate_summary("tübingen castle", windows)
    assert got == want
    assert got == ref_asst.HttpLlmClient(url).generate_summary(
        "tübingen castle", windows)
    (p_path, p_type, p_body), (r_path, _, r_body) = srv.bodies
    assert p_body == r_body and p_path == r_path == "/generate_summary"
    assert p_type == "application/json"
    assert p_body["query"] == "tübingen castle"
    assert len(p_body["most_relevant_windows"]) == 10
    assert all(len(w) == 4000 for w in p_body["most_relevant_windows"])


def test_http_client_no_response_key(stub):
    srv, url = stub
    srv.reply = (200, {"other": 1})
    assert port_asst.HttpLlmClient(url).generate_summary("q", ["w"]) == ""


@pytest.mark.parametrize("status", [302, 404, 500])
def test_http_client_raises_on_non_2xx(stub, status):
    srv, url = stub
    srv.reply = (status, {"response": "should not be read"})
    with pytest.raises(OSError):
        port_asst.HttpLlmClient(url).generate_summary("q", ["w"])
    assert len(srv.bodies) == 1  # no redirect was followed
