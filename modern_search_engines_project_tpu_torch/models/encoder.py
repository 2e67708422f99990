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

``TorchEncoder`` is the ``encode_batch`` protocol over ``BiEncoder``, a
drop-in for ``HashingEncoder`` in ``IndexBuilder`` and ``SearchEngine``,
with ``encode_batch_device`` for the engine's device route.  Parameters
cross from the reference's tree form through ``params_from_reference``,
and ``params_digest`` hashes that tree exactly as the reference's
``JaxEncoder.params_digest`` does, so indexes built by either package
carry the same provenance.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    resolve_device,
    upload,
)
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer


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


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LayerNorm(nn.Module):
    """The reference's LayerNorm: f32 statistics by the fast variance,
    eps 1e-6, f32 scale and bias, output in the activation dtype."""

    def __init__(self, dim: int, dtype, device=None, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = _weight((dim,), torch.float32, device)
        self.bias = _weight((dim,), torch.float32, device)

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        mu2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mu) * mul + self.bias).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.qkv = _weight((cfg.dim, 3 * cfg.dim), self.dtype, device)
        self.proj = _weight((cfg.dim, cfg.dim), self.dtype, device)

    def forward(self, x, mask, rope):
        c = self.cfg
        B, L, _ = x.shape
        hd = c.dim // c.n_heads
        q, k, v = torch.matmul(x, self.qkv).split(c.dim, dim=-1)
        q = apply_rope(q.reshape(B, L, c.n_heads, hd), rope).to(self.dtype)
        k = apply_rope(k.reshape(B, L, c.n_heads, hd), rope).to(self.dtype)
        v = v.reshape(B, L, c.n_heads, hd)
        # f32 outputs of bf16 products: the inputs are exact in f32
        att = torch.matmul(q.float().transpose(1, 2),
                           k.float().permute(0, 2, 3, 1)) / math.sqrt(hd)
        att = att.masked_fill(~mask[:, None, None, :], -1e30)
        att = torch.softmax(att, dim=-1).to(self.dtype)
        out = torch.matmul(att.float(), v.float().transpose(1, 2))
        out = out.to(self.dtype).transpose(1, 2).reshape(B, L, c.dim)
        return torch.matmul(out, self.proj)


class GeGLU(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.dtype = getattr(torch, cfg.dtype)
        hidden = cfg.dim * cfg.mlp_ratio
        self.wi = _weight((cfg.dim, 2 * hidden), self.dtype, device)
        self.wo = _weight((hidden, cfg.dim), self.dtype, device)

    def forward(self, x):
        gate, up = torch.matmul(x, self.wi).chunk(2, dim=-1)
        act = F.gelu(gate.float(), approximate="tanh") * up.float()
        return torch.matmul(act.to(self.dtype), self.wo)


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.ln1 = LayerNorm(cfg.dim, dt, device)
        self.attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg.dim, dt, device)
        self.mlp = GeGLU(cfg, device)

    def forward(self, x, mask, rope):
        x = x + self.attn(self.ln1(x), mask, rope)
        return x + self.mlp(self.ln2(x))


class BiEncoder(nn.Module):
    """token ids + mask [B, L] -> L2-normalised sentence embedding [B, dim]
    (f32)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        self.tok = _weight((cfg.vocab_size, cfg.dim), dt, device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers)
        )
        self.ln_f = LayerNorm(cfg.dim, dt, device)
        rope = _rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
        self.register_buffer(
            "rope", torch.tensor(rope, dtype=torch.float32, device=device),
            persistent=False,
        )

    def forward(self, ids, mask):
        x = F.embedding(ids, self.tok)
        bool_mask = mask > 0
        for blk in self.blocks:
            x = blk(x, bool_mask, self.rope)
        x = self.ln_f(x)
        # mean pooling over valid tokens, in f32
        m = mask[..., None].float()
        pooled = (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12
        )


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
        sync: the engine feeds it straight into the ranking dispatch."""
        chunks = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                x = self._upload(texts[i : i + self.batch_size])
                chunks.append(self.model(x[0], x[1]))
        if not chunks:
            return torch.zeros(0, self.cfg.dim, device=self.device)
        return chunks[0] if len(chunks) == 1 else torch.cat(chunks)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode_batch_device(list(texts)).cpu().numpy()

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]
