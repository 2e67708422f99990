"""Bi-encoder: a ModernBERT-style transformer in PyTorch.

Counterpart of the reference package's ``models/encoder.py`` (the trained
query and window encoder, ``runs/encoder-real``): pre-LayerNorm blocks,
rotary position embeddings rotating interleaved (even, odd) pairs, a GeGLU
feed-forward (gate first, then up, tanh GELU), mean pooling over the
attention mask and L2-normalised sentence embeddings.

The arithmetic follows the reference's, step by step, so that the same
parameters give the same embeddings to bf16 rounding:
  * weights and the embedding table in bf16 (cast once when loaded; the
    reference casts its f32 parameters on every call, to the same bits),
    LayerNorm scale and bias in f32;
  * a bf16 residual stream;
  * LayerNorm statistics in f32 with the fast variance E[x^2] - E[x]^2,
    eps 1e-6, the output cast to bf16;
  * RoPE in f32, then cast to bf16;
  * both attention products with f32 outputs (bf16 inputs are exact in
    f32), the softmax in f32, its output cast to bf16;
  * mean pooling and the final norm in f32.
Products run through ``torch.matmul``; this module holds no hand-written
kernel (the reference's products are XLA einsums, not Pallas kernels).

The arithmetic lives in functions over the weights (``layer_norm``,
``attention``, ``geglu``, ``block``, ``encode``) whose products go
through a ``Products`` object: the modules pass the one-device products,
the dp x tp training step (``models/train.py``) its tensor-parallel ones,
so both compute one function in one way.

Training (``models/train.py``) builds the modules with
``param_dtype=torch.float32``: f32 parameters with gradients, cast to
``cfg.dtype`` inside ``forward`` on every call, as the reference keeps
f32 parameters and casts them per call.  Casting per call gives the bits
of casting once, so a trained model and its inference copy agree.  The
token table is gathered in f32 and the rows cast after the gather (the
same forward bits), so its gradient accumulates in f32; the reference
casts the whole table first and scatter-adds the rows' gradients in bf16.
A trainable ``BiEncoder`` recomputes each block's activations in the
backward (``torch.utils.checkpoint``): the f32 intermediates this
arithmetic keeps (LayerNorm statistics, RoPE, scores, the GeGLU
activation) take ~136 MB a 128-token sequence at full width, ~70 GB for
the recipe's 2 x 256 sequences a step, which would not fit one 80 GB
card beside the optimizer; recomputing costs one more forward a step
and gives the same bits.  ``params_to_reference`` carries the parameters
back to the reference's tree form (for ``params_digest`` and the
checkpoint writer).

``Attention`` and ``Block`` take a ``causal`` flag, which the decoder's
blocks set (``models/decoder.py``, the reference's ``CausalAttention``);
the cross-encoder (``models/cross_encoder.py``) reuses the blocks as
they are.

``TorchEncoder`` is the ``encode_batch`` protocol over ``BiEncoder``, a
drop-in for ``HashingEncoder`` in ``IndexBuilder`` and ``SearchEngine``,
with ``encode_batch_device`` for the engine's device route.  Parameters
cross from the reference's tree form through ``params_from_reference``,
and ``params_digest`` hashes that tree exactly as the reference's
``JaxEncoder.params_digest`` does, so indexes built by either package
carry the same provenance.

On a card, ``encode_batch_device`` replays the inference forward of a
short chunk from a CUDA graph (``replays_graph``: at most ``batch_size``
rows of at most ``GRAPH_MAX_LEN`` tokens, no gradients), one graph a
(rows, length) shape: a 12L/768d forward is ~900 PyTorch calls, and the
data plane's two dispatcher threads in one process hand the interpreter
lock back and forth at each of them, so its host enqueue takes several
times its device time; one replay is a few calls.  The graph holds the
eager forward's kernels on the same shapes and dtypes, so it gives the
same bits.  A shape's first call runs eagerly (it warms cuBLAS and the
allocator), its second captures, on a side stream in the thread-local
capture mode, so the other thread's launches neither fail nor join the
graph.  Longer inputs (document windows, 256-512 tokens) stay eager: a
graph's private memory would hold their f32 attention scores, and their
launches are a small share of their device time.  The CPU path is the
eager one.  Two threads may encode at once: one lock per encoder covers
the copy into the graph's static input, the replay and the clone of its
static output, all three on the caller's current stream (a replay on
another stream than the last one's first waits for that one), so stream
order keeps a later replay from overwriting an earlier chunk's input or
output before that chunk's clone has run.  That order also lets all of an
encoder's graphs share one memory pool: no two replays run at once, and
each graph's output stays its own, live until the encoder goes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    resolve_device,
    upload,
)
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer
from modern_search_engines_project_tpu_torch.utils.timing import (
    inner_record,
    inner_timer,
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_ratio: int = 4
    max_len: int = 512
    dtype: str = "bfloat16"  # activation and weight dtype on the device
    rope_base: float = 10000.0


def _rope_angles(head_dim: int, max_len: int, base: float) -> np.ndarray:
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    t = np.arange(max_len)
    freqs = np.outer(t, inv)  # [L, hd/2]
    return np.stack([np.cos(freqs), np.sin(freqs)], axis=-1)  # [L, hd/2, 2]


def apply_rope(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, hd]; rope: f32 [max_len, hd/2, 2].  Rotates the
    interleaved (even, odd) pairs of each head in f32; returns f32."""
    L = x.shape[1]
    cos = rope[:L, :, 0][None, :, None, :]
    sin = rope[:L, :, 1][None, :, None, :]
    x = x.float()
    x1, x2 = x[..., ::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x1 * sin + x2 * cos
    return torch.stack([out1, out2], dim=-1).reshape(x.shape)


def _weight(shape, dtype, device, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


def _param_dtype(cfg, param_dtype):
    """(weight dtype, trainable): the activation dtype and frozen for
    inference (``param_dtype=None``), else ``param_dtype`` with
    gradients."""
    if param_dtype is None:
        return getattr(torch, cfg.dtype), False
    return param_dtype, True


class Products:
    """How the weight products and the token gather run.  On one device
    each is one ``torch.matmul`` of the input by the weight cast to the
    activation dtype (and one ``F.embedding``); the dp x tp training step
    (``models/train.py``) passes its own, which split them over a tensor
    parallel group, so both run the arithmetic below."""

    @staticmethod
    def col(x, w, dtype):
        """A product whose weight a tp group splits by column."""
        return torch.matmul(x, w.to(dtype))

    @staticmethod
    def row(x, w, dtype):
        """A product whose weight a tp group splits by row."""
        return torch.matmul(x, w.to(dtype))

    @staticmethod
    def embed(ids, tok):
        return F.embedding(ids, tok)


DENSE = Products()


def layer_norm(x, ln, dtype):
    """The reference's LayerNorm over ``ln`` (``scale``, ``bias``,
    ``eps``): f32 statistics by the fast variance, output in ``dtype``."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    mu2 = (x * x).mean(-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.scale
    return ((x - mu) * mul + ln.bias).to(dtype)


def attention(x, mask, rope, w, cfg, dtype, tril=None, mm: Products = DENSE):
    """Self-attention with ``w.qkv`` / ``w.proj``; ``tril`` (a causal
    mask) also hides later keys."""
    B, L, _ = x.shape
    hd = cfg.dim // cfg.n_heads
    qkv = mm.col(x, w.qkv, dtype)
    q, k, v = qkv.split(cfg.dim, dim=-1)
    q = apply_rope(q.reshape(B, L, cfg.n_heads, hd), rope).to(dtype)
    k = apply_rope(k.reshape(B, L, cfg.n_heads, hd), rope).to(dtype)
    v = v.reshape(B, L, cfg.n_heads, hd)
    # f32 outputs of bf16 products: the inputs are exact in f32
    att = torch.matmul(q.float().transpose(1, 2),
                       k.float().permute(0, 2, 3, 1)) / math.sqrt(hd)
    keep = mask[:, None, None, :]
    if tril is not None:
        keep = keep & tril[:L, :L]
    att = att.masked_fill(~keep, -1e30)
    att = torch.softmax(att, dim=-1).to(dtype)
    out = torch.matmul(att.float(), v.float().transpose(1, 2))
    out = out.to(dtype).transpose(1, 2).reshape(B, L, cfg.dim)
    return mm.row(out, w.proj, dtype)


def geglu(x, w, dtype, mm: Products = DENSE):
    """The GeGLU feed-forward with ``w.wi`` (gate | up) and ``w.wo``."""
    gate, up = mm.col(x, w.wi, dtype).chunk(2, dim=-1)
    act = F.gelu(gate.float(), approximate="tanh") * up.float()
    return mm.row(act.to(dtype), w.wo, dtype)


def block(x, mask, rope, w, cfg, dtype, tril=None, mm: Products = DENSE):
    """One pre-LayerNorm block over ``w`` (``ln1``, ``attn``, ``ln2``,
    ``mlp``)."""
    x = x + attention(layer_norm(x, w.ln1, dtype), mask, rope, w.attn, cfg,
                      dtype, tril, mm)
    return x + geglu(layer_norm(x, w.ln2, dtype), w.mlp, dtype, mm)


def encode(w, ids, mask, rope, cfg, dtype, mm: Products = DENSE,
           recompute: bool = False):
    """The bi-encoder over ``w`` (``tok``, ``blocks``, ``ln_f``): token ids
    and mask [B, L] -> unit embeddings [B, dim] f32; ``recompute`` runs
    each block under ``torch.utils.checkpoint``."""
    x = mm.embed(ids, w.tok).to(dtype)  # gather, then cast
    bool_mask = mask > 0
    for blk in w.blocks:
        if recompute:
            x = checkpoint(block, x, bool_mask, rope, blk, cfg, dtype, None,
                           mm, use_reentrant=False)
        else:
            x = block(x, bool_mask, rope, blk, cfg, dtype, None, mm)
    x = layer_norm(x, w.ln_f, dtype)
    # mean pooling over valid tokens, in f32
    m = mask[..., None].float()
    pooled = (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return pooled / torch.clamp(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12
    )


class LayerNorm(nn.Module):
    """The reference's LayerNorm: f32 statistics by the fast variance,
    eps 1e-6, f32 scale and bias, output in the activation dtype."""

    def __init__(self, dim: int, dtype, device=None, eps: float = 1e-6,
                 trainable: bool = False):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = _weight((dim,), torch.float32, device, trainable)
        self.bias = _weight((dim,), torch.float32, device, trainable)

    def forward(self, x):
        return layer_norm(x, self, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over the keys ``mask`` keeps; with
    ``causal`` (the decoder's), a query also sees no later key: the
    reference's ``tril & mask[key]``, masked with -1e30 as the padding
    is.  ``cfg`` is any config with ``dim``, ``n_heads``, ``max_len`` and
    ``dtype``."""

    def __init__(self, cfg: EncoderConfig, device=None, causal: bool = False,
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        wdt, train = _param_dtype(cfg, param_dtype)
        self.qkv = _weight((cfg.dim, 3 * cfg.dim), wdt, device, train)
        self.proj = _weight((cfg.dim, cfg.dim), wdt, device, train)
        self.causal = causal
        if causal:
            self.register_buffer(
                "tril",
                torch.ones(cfg.max_len, cfg.max_len, dtype=torch.bool,
                           device=device).tril(),
                persistent=False,
            )

    def forward(self, x, mask, rope):
        return attention(x, mask, rope, self, self.cfg, self.dtype,
                         self.tril if self.causal else None)


class GeGLU(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None, param_dtype=None):
        super().__init__()
        self.dtype = getattr(torch, cfg.dtype)
        wdt, train = _param_dtype(cfg, param_dtype)
        hidden = cfg.dim * cfg.mlp_ratio
        self.wi = _weight((cfg.dim, 2 * hidden), wdt, device, train)
        self.wo = _weight((hidden, cfg.dim), wdt, device, train)

    def forward(self, x):
        return geglu(x, self, self.dtype)


class Block(nn.Module):
    """Pre-LayerNorm block; ``causal`` makes it the decoder's block;
    ``param_dtype`` as ``BiEncoder``'s."""

    def __init__(self, cfg: EncoderConfig, device=None, causal: bool = False,
                 param_dtype=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        train = param_dtype is not None
        self.cfg, self.dtype = cfg, dt
        self.ln1 = LayerNorm(cfg.dim, dt, device, trainable=train)
        self.attn = Attention(cfg, device, causal, param_dtype)
        self.ln2 = LayerNorm(cfg.dim, dt, device, trainable=train)
        self.mlp = GeGLU(cfg, device, param_dtype)

    def forward(self, x, mask, rope):
        return block(x, mask, rope, self, self.cfg, self.dtype,
                     self.attn.tril if self.attn.causal else None)


class BiEncoder(nn.Module):
    """token ids + mask [B, L] -> L2-normalised sentence embedding [B, dim]
    (f32).  ``param_dtype=None``: frozen weights in ``cfg.dtype`` (the
    inference copy); ``torch.float32``: f32 parameters with gradients,
    cast to ``cfg.dtype`` on every call, each block recomputed in the
    backward (training)."""

    def __init__(self, cfg: EncoderConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = getattr(torch, cfg.dtype)
        wdt, train = _param_dtype(cfg, param_dtype)
        self.recompute = train
        self.tok = _weight((cfg.vocab_size, cfg.dim), wdt, device, train)
        self.blocks = nn.ModuleList(
            Block(cfg, device, param_dtype=param_dtype)
            for _ in range(cfg.n_layers)
        )
        self.ln_f = LayerNorm(cfg.dim, dt, device, trainable=train)
        self.register_buffer(
            "rope", rope_table(cfg, device), persistent=False,
        )

    def forward(self, ids, mask):
        return encode(self, ids, mask, self.rope, self.cfg, self.dtype,
                      recompute=self.recompute and torch.is_grad_enabled())


def rope_table(cfg, device) -> torch.Tensor:
    """The f32 RoPE angles [max_len, head_dim / 2, 2] of ``cfg``."""
    rope = _rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
    return torch.tensor(rope, dtype=torch.float32, device=device)


# ---- parameters in the reference's tree form --------------------------------


def init_reference_params(
    cfg: EncoderConfig, normal: Callable[[tuple], np.ndarray]
) -> dict:
    """A random parameter tree in the reference's form, at the scale of the
    reference's default inits: Dense kernels [in, out] with std
    1/sqrt(in), the embedding table with std 1/sqrt(dim), LayerNorm scale
    1 and bias 0.  ``normal(shape)`` draws f32 standard normals (the
    caller's seeded generator).  The reference's init draws other bits, so
    a seeded encoder equals a reference one only when both are given the
    same tree."""
    D, Hd = cfg.dim, cfg.dim * cfg.mlp_ratio

    def dense(n_in, n_out):
        return {"kernel": (normal((n_in, n_out)) / np.float32(math.sqrt(n_in)))
                .astype(np.float32)}

    def ln():
        return {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}

    tree = {"tok": {"embedding": (normal((cfg.vocab_size, D))
                                  / np.float32(math.sqrt(D))).astype(np.float32)}}
    for i in range(cfg.n_layers):
        tree[f"block{i}"] = {
            "ln1": ln(),
            "attn": {"qkv": dense(D, 3 * D), "proj": dense(D, D)},
            "ln2": ln(),
            "mlp": {"wi": dense(D, 2 * Hd), "wo": dense(Hd, D)},
        }
    tree["ln_f"] = ln()
    return tree


def _leaves_with_keys(tree, prefix=""):
    """(key path in the reference's ``keystr`` form, leaf) pairs, e.g.
    ``['block0']['attn']['qkv']['kernel']``."""
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            yield from _leaves_with_keys(v, path)
        else:
            yield path, v


def params_digest(tree: dict) -> str:
    """Short digest of a parameter tree: sha1 over the sorted key paths,
    each with its dtype, shape and raw bytes, as the reference hashes its
    tree (so both packages give one checkpoint the same digest)."""
    h = hashlib.sha1()
    for path, leaf in sorted(_leaves_with_keys(tree), key=lambda kv: kv[0]):
        arr = np.asarray(leaf)
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def params_from_reference(tree: dict, device, dtype=torch.bfloat16) -> dict:
    """The reference's tree (nested dict of numpy arrays, Dense kernels
    [in, out]) -> a ``BiEncoder`` state dict on ``device``: weight
    matrices and the embedding table cast to ``dtype`` once, LayerNorm
    scale and bias in f32."""

    def w(x):
        return torch.tensor(np.asarray(x, np.float32), device=device).to(dtype)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    out = {"tok": w(tree["tok"]["embedding"]),
           "ln_f.scale": f32(tree["ln_f"]["scale"]),
           "ln_f.bias": f32(tree["ln_f"]["bias"])}
    n_layers = sum(1 for k in tree if k.startswith("block"))
    for i in range(n_layers):
        b, p = tree[f"block{i}"], f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            out[p + ln + ".scale"] = f32(b[ln]["scale"])
            out[p + ln + ".bias"] = f32(b[ln]["bias"])
        for mod, names in (("attn", ("qkv", "proj")), ("mlp", ("wi", "wo"))):
            for n in names:
                out[f"{p}{mod}.{n}"] = w(b[mod][n]["kernel"])
    return out


def params_to_reference(module) -> dict:
    """The inverse of ``params_from_reference``: a ``BiEncoder`` (or its
    state dict, or a dict of its parameters' gradients under the same
    names) -> the reference's tree, a nested dict of f32 numpy copies with
    Dense kernels [in, out], its keys in the order the reference's init
    creates them (``tok``; ``block{i}`` with ``ln1``, ``attn``, ``ln2``,
    ``mlp``; ``ln_f``), which is the order its serializer writes."""
    sd = module.state_dict() if isinstance(module, nn.Module) else module

    def a(key):
        return sd[key].detach().to("cpu", torch.float32, copy=True).numpy()

    def ln(prefix):
        return {"scale": a(prefix + ".scale"), "bias": a(prefix + ".bias")}

    tree = {"tok": {"embedding": a("tok")}}
    n_layers = sum(1 for k in sd if k.startswith("blocks.")
                   and k.endswith(".ln1.scale"))
    for i in range(n_layers):
        p = f"blocks.{i}."
        tree[f"block{i}"] = {
            "ln1": ln(p + "ln1"),
            "attn": {"qkv": {"kernel": a(p + "attn.qkv")},
                     "proj": {"kernel": a(p + "attn.proj")}},
            "ln2": ln(p + "ln2"),
            "mlp": {"wi": {"kernel": a(p + "mlp.wi")},
                    "wo": {"kernel": a(p + "mlp.wo")}},
        }
    tree["ln_f"] = ln("ln_f")
    return tree


# ---- the inference forward from CUDA graphs ---------------------------------

GRAPH_MAX_LEN = 64  # the longest token bucket that replays a graph


def replays_graph(device: torch.device, n: int, L: int, grad: bool,
                  batch_size: int) -> bool:
    """Whether ``encode_batch_device`` replays a chunk of ``n`` rows padded
    to ``L`` tokens from a CUDA graph: on a card, without gradients, for
    at most ``batch_size`` rows of at most ``GRAPH_MAX_LEN`` tokens."""
    return (device.type == "cuda" and not grad
            and 0 < n <= batch_size and L <= GRAPH_MAX_LEN)


class GraphedForward:
    """The inference forward of ``model`` on ``device``, one CUDA graph a
    shape of its [2, n, L] int32 input (ids, mask); the module docstring
    says when and why it is safe.  ``__call__`` runs a shape's first call
    eagerly, captures at its second, and replays from then on, counting
    each replay as ``encode_graph`` with its host seconds in the caller's
    registry (``inner_record``)."""

    def __init__(self, model: nn.Module, device: torch.device):
        self.model, self.device = model, device
        self.lock = threading.Lock()
        self.seen = set()
        self.graphs = {}  # input shape -> (graph, static input, static output)
        self.stream = None  # the capture stream
        self.pool = None  # one memory pool for every graph of the model
        self.last = None  # the stream of the latest replay

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = tuple(x.shape)
        with self.lock:
            entry = self.graphs.get(key)
            if entry is None and key in self.seen:
                entry = self.graphs[key] = self._capture(x)
            self.seen.add(key)
            if entry is not None:
                return self._replay(entry, x)
        return self.model(x[0], x[1])

    def _capture(self, x: torch.Tensor):
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            if self.stream is None:
                self.stream = torch.cuda.Stream()
                self.pool = torch.cuda.graph_pool_handle()
            static_in = torch.empty_like(x)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self.model(x[0], x[1])  # warms the capture stream's cuBLAS
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    static_out = self.model(static_in[0], static_in[1])
                finally:
                    graph.capture_end()
            cur.wait_stream(self.stream)
        return graph, static_in, static_out

    def _replay(self, entry, x: torch.Tensor) -> torch.Tensor:
        graph, static_in, static_out = entry
        t0 = time.monotonic_ns()
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            if self.last is not None and self.last != cur:
                cur.wait_stream(self.last)
            self.last = cur
            static_in.copy_(x)
            graph.replay()
            out = static_out.clone()
        inner_record("encode_graph", (time.monotonic_ns() - t0) / 1e9)
        return out


# ---- the encode_batch protocol ---------------------------------------------


class TorchEncoder:
    """``encode_batch`` protocol over ``BiEncoder`` (drop-in for
    ``HashingEncoder`` in ``IndexBuilder`` / ``SearchEngine``).

    ``params``: a tree in the reference's form (``load_encoder``,
    ``init_reference_params``).  Without one, the parameters are drawn by
    ``init_reference_params`` from ``generator`` (a ``torch.Generator``;
    seed 0 when none is given).  ``device``: "cuda" (default) or "cpu";
    with no card and no ``device="cpu"`` this raises.

    Each batch of ``batch_size`` texts pads to the smallest length bucket
    that holds its longest text; rows are independent, so batches are not
    padded to ``batch_size`` rows."""

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        params: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        batch_size: int = 64,
        max_len: Optional[int] = None,
        device=None,
    ):
        self.cfg = cfg or EncoderConfig()
        self.device = resolve_device(device)
        self.tokenizer = HashTokenizer(self.cfg.vocab_size)
        self.batch_size = batch_size
        # sequences can't exceed the model's trained position range
        self.max_len = min(max_len or self.cfg.max_len, self.cfg.max_len)
        self.len_buckets = tuple(
            L for L in (16, 32, 64, 128, 256, 512) if L < self.max_len
        ) + (self.max_len,)
        if params is None:
            g = generator or torch.Generator().manual_seed(0)
            params = init_reference_params(
                self.cfg, lambda s: torch.randn(s, generator=g).numpy()
            )
        self._digest = params_digest(params)
        self.model = BiEncoder(self.cfg, self.device)
        self.model.load_state_dict(
            params_from_reference(params, self.device,
                                  getattr(torch, self.cfg.dtype))
        )
        self.model.eval()
        self.graphed = GraphedForward(self.model, self.device)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "TorchEncoder":
        """Load the parameters and config of a checkpoint directory
        (``config.json`` + ``params.msgpack``)."""
        from modern_search_engines_project_tpu_torch.models.checkpoint import (
            load_encoder,
        )

        params, enc_cfg = load_encoder(path)
        enc = cls(enc_cfg, params=params, **kw)
        enc.ckpt_path = path
        return enc

    def params_digest(self) -> str:
        return self._digest

    def describe(self) -> dict:
        """Provenance record stored in index artifacts; the same record as
        the reference's bi-encoder writes, so serving can refuse to pair an
        index with a mismatched query encoder."""
        return {
            "kind": "jax_biencoder",
            "dim": self.cfg.dim,
            "config": dataclasses.asdict(self.cfg),
            "params_digest": self.params_digest(),
            "ckpt": getattr(self, "ckpt_path", None),
        }

    def bucket_len(self, tok: Sequence[Sequence[int]]) -> int:
        """Smallest length bucket fitting the longest sequence (+2 for
        the tokenizer's CLS/SEP framing), capped at max_len."""
        need = max((len(t) for t in tok), default=0) + 2
        for L in self.len_buckets:
            if L >= need:
                return L
        return self.max_len

    def _upload(self, chunk: Sequence[str]) -> torch.Tensor:
        """Token ids and mask [2, n, L] int32 of one batch, on the device
        in one copy."""
        tok = [self.tokenizer.encode(t) for t in chunk]
        ids, mask = self.tokenizer.pad_batch(tok, self.bucket_len(tok))
        return upload(np.array([ids, mask], dtype=np.int32), self.device)

    def encode_batch_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Embeddings [n, dim] f32 as a tensor on the device, with no host
        sync: the engine feeds it straight into the ranking dispatch.
        Inside a caller's span (the engine's ``query_encode``), each chunk
        is two child spans in the caller's registry: ``encode_tokens``
        (tokenize, pad, the pinned upload) and ``encode_forward`` (the
        host's enqueue of the forward, eager or a graph's replay; a replay
        also counts as ``encode_graph``)."""
        chunks = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                with inner_timer("encode_tokens"):
                    x = self._upload(texts[i : i + self.batch_size])
                with inner_timer("encode_forward"):
                    chunks.append(self._forward(x))
        if not chunks:
            return torch.zeros(0, self.cfg.dim, device=self.device)
        return chunks[0] if len(chunks) == 1 else torch.cat(chunks)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of one uploaded chunk [2, n, L]: from a graph where
        ``replays_graph`` says so, else eager."""
        if replays_graph(self.device, x.shape[1], x.shape[2],
                         torch.is_grad_enabled(), self.batch_size):
            return self.graphed(x)
        return self.model(x[0], x[1])

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode_batch_device(list(texts)).cpu().numpy()

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]
