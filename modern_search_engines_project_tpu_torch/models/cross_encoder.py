"""Cross-encoder reranker: joint query + window scoring (stage 3).

Counterpart of the reference package's ``models/cross_encoder.py``
(``runs/cross-encoder-real``: 4 layers, 384 wide, 50,257 hashed ids,
``max_len`` 192).  The query and the candidate window are encoded
jointly, ``[CLS] query [SEP] window [SEP]``, through the bi-encoder's
trunk (``models/encoder.py``, non-causal blocks, the same arithmetic),
then a relevance head on the CLS row: the final LayerNorm's bf16 row cast
to f32, a 384 x 384 f32 ``Dense`` with bias, tanh GELU, a 384 x 1 f32
``Dense`` with bias, and ``rescore`` applies the sigmoid.

The head's products are f32 and must stay f32: run it with
``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default), or the
card rounds their inputs to TF32 and the scores move by ~1e-3.  This
module sets no global flag.

``CrossEncoderReranker`` gives the protocol the engine's optional stage 3
reads, ``rescore(query, texts) -> float32 [n]``, in chunks of
``batch_size`` pairs with one copy to the host a call.  The reference pads
the last chunk to ``batch_size`` rows for its static shapes; rows are
independent, so the port does not.  Products run through
``torch.matmul``; this module holds no hand-written kernel (the
reference's products are XLA einsums).

``train_cross_encoder`` fine-tunes it as the reference does (pointwise
sigmoid BCE on logits, AdamW with optax's default decay of 1e-4, the
reference's shuffle, the tail batch dropped) on f32 parameters cast per
call (``param_dtype``, see ``models/encoder.py``); ``save`` writes the
reference's checkpoint form.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from modern_search_engines_project_tpu_torch.models.checkpoint import (
    read_checkpoint,
    save_encoder,
)
from modern_search_engines_project_tpu_torch.models.encoder import (
    Block,
    EncoderConfig,
    LayerNorm,
    _param_dtype,
    _rope_angles,
    _weight,
    init_reference_params,
    params_from_reference,
    params_to_reference,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    resolve_device,
    upload,
)
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import (
    SEP_ID,
    HashTokenizer,
)


class Dense(nn.Module):
    """f32 ``x @ kernel + bias`` (kernel [in, out]), the product first and
    the bias after, as the reference's ``Dense`` adds it."""

    def __init__(self, n_in: int, n_out: int, device=None,
                 trainable: bool = False):
        super().__init__()
        self.kernel = _weight((n_in, n_out), torch.float32, device, trainable)
        self.bias = _weight((n_out,), torch.float32, device, trainable)

    def forward(self, x):
        return torch.matmul(x, self.kernel) + self.bias


class CrossEncoder(nn.Module):
    """(ids, mask) [B, L] of joint sequences -> relevance logit [B], f32.
    ``param_dtype`` as ``BiEncoder``'s (the head is f32 either way)."""

    def __init__(self, cfg: EncoderConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = getattr(torch, cfg.dtype)
        wdt, train = _param_dtype(cfg, param_dtype)
        self.tok = _weight((cfg.vocab_size, cfg.dim), wdt, device, train)
        self.blocks = nn.ModuleList(
            Block(cfg, device, param_dtype=param_dtype)
            for _ in range(cfg.n_layers)
        )
        self.ln_f = LayerNorm(cfg.dim, dt, device, trainable=train)
        self.head_hidden = Dense(cfg.dim, cfg.dim, device, train)
        self.head_out = Dense(cfg.dim, 1, device, train)
        rope = _rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
        self.register_buffer(
            "rope", torch.tensor(rope, dtype=torch.float32, device=device),
            persistent=False,
        )

    def forward(self, ids, mask):
        x = F.embedding(ids, self.tok).to(self.dtype)  # gather, then cast
        bool_mask = mask > 0
        for blk in self.blocks:
            x = blk(x, bool_mask, self.rope)
        cls = self.ln_f(x[:, 0]).float()  # the CLS row (norms are per row)
        h = F.gelu(self.head_hidden(cls), approximate="tanh")
        return self.head_out(h)[:, 0]


def init_cross_encoder_params(
    cfg: EncoderConfig, normal: Callable[[tuple], np.ndarray]
) -> dict:
    """A random cross-encoder tree in the reference's form: the trunk of
    ``init_reference_params`` plus ``head_hidden`` ([dim, dim]) and
    ``head_out`` ([dim, 1]), f32 kernels with std 1/sqrt(in) and zero
    biases, as the reference's default inits draw them (other bits)."""
    tree = init_reference_params(cfg, normal)
    for name, n_out in (("head_hidden", cfg.dim), ("head_out", 1)):
        tree[name] = {
            "kernel": (normal((cfg.dim, n_out))
                       / np.float32(math.sqrt(cfg.dim))).astype(np.float32),
            "bias": np.zeros(n_out, np.float32),
        }
    return tree


def cross_encoder_params_from_reference(tree: dict, device,
                                        dtype=torch.bfloat16) -> dict:
    """The reference's cross-encoder tree -> a ``CrossEncoder`` state dict
    on ``device``: the trunk as ``params_from_reference`` carries it
    (weights and table cast to ``dtype`` once, f32 LayerNorms), the head's
    kernels and biases in f32."""
    out = params_from_reference(tree, device, dtype)
    for name in ("head_hidden", "head_out"):
        for leaf in ("kernel", "bias"):
            out[f"{name}.{leaf}"] = torch.tensor(
                np.asarray(tree[name][leaf], np.float32), device=device
            )
    return out


def cross_encoder_params_to_reference(module) -> dict:
    """A ``CrossEncoder`` (or its state dict, or its gradients by
    parameter name) -> the reference's tree: ``params_to_reference``'s
    trunk, then ``head_hidden`` and ``head_out`` (kernel, bias), in the
    order the reference's init creates them."""
    sd = module.state_dict() if isinstance(module, nn.Module) else module
    tree = params_to_reference(sd)
    for name in ("head_hidden", "head_out"):
        tree[name] = {
            leaf: sd[f"{name}.{leaf}"].detach().to(
                "cpu", torch.float32, copy=True).numpy()
            for leaf in ("kernel", "bias")
        }
    return tree


class CrossEncoderReranker:
    """Batched (query, window) joint scoring: ``rescore(query, texts)``.

    ``params``: a tree in the reference's form (``from_checkpoint``,
    ``init_cross_encoder_params``); without one it is drawn from a numpy
    generator seeded with ``seed``.  ``device``: "cuda" (default) or "cpu";
    with no card and no ``device="cpu"`` this raises.  ``param_dtype``:
    None for inference (weights in ``cfg.dtype``, cast once), or
    ``torch.float32`` for training (see ``CrossEncoder``)."""

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        params: Optional[dict] = None,
        seed: int = 0,
        batch_size: int = 32,
        max_len: Optional[int] = None,
        device=None,
        param_dtype=None,
    ):
        self.cfg = cfg or EncoderConfig()
        self.device = resolve_device(device)
        self.tokenizer = HashTokenizer(self.cfg.vocab_size)
        self.batch_size = batch_size
        self.max_len = max_len or self.cfg.max_len
        if params is None:
            rng = np.random.default_rng(seed)
            params = init_cross_encoder_params(
                self.cfg, lambda s: rng.standard_normal(s, dtype=np.float32)
            )
        self.model = CrossEncoder(self.cfg, self.device, param_dtype)
        self.model.load_state_dict(
            cross_encoder_params_from_reference(
                params, self.device,
                param_dtype or getattr(torch, self.cfg.dtype))
        )
        self.model.eval()

    def save(self, path: str, dtype: str = "float16") -> None:
        """Persist the parameters and config in the reference's checkpoint
        form (``config.json`` round-trips through ``EncoderConfig``).  An
        inference reranker holds ``cfg.dtype`` weights and saves those."""
        save_encoder(cross_encoder_params_to_reference(self.model), self.cfg,
                     path, dtype=dtype)

    @classmethod
    def from_checkpoint(
        cls, path: str, batch_size: int = 32, max_len: Optional[int] = None,
        device=None,
    ) -> "CrossEncoderReranker":
        """Load ``config.json`` and ``params.msgpack`` from ``path``."""
        tree, conf = read_checkpoint(path)
        return cls(EncoderConfig(**conf), params=tree, batch_size=batch_size,
                   max_len=max_len, device=device)

    def _encode_pairs(self, query: str, texts: Sequence[str]):
        q_ids = list(self.tokenizer.encode(query))
        joint = []
        for t in texts:
            t_ids = list(self.tokenizer.encode(t))
            # [CLS] q [SEP] t [SEP], truncating the window first
            body_budget = self.max_len - 3 - len(q_ids)
            joint.append(q_ids + [SEP_ID] + t_ids[: max(body_budget, 0)])
        return self.tokenizer.pad_batch(joint, self.max_len)

    @torch.no_grad()
    def rescore_device(self, query: str, texts: Sequence[str]) -> torch.Tensor:
        """Sigmoid relevance [n] f32 as a tensor on the device, with no host
        sync: one upload and one forward per ``batch_size`` pairs."""
        out = []
        for i in range(0, len(texts), self.batch_size):
            ids, mask = self._encode_pairs(query, texts[i : i + self.batch_size])
            x = upload(np.array([ids, mask], dtype=np.int32), self.device)
            out.append(torch.sigmoid(self.model(x[0], x[1])))
        if not out:
            return torch.zeros(0, device=self.device)
        return out[0] if len(out) == 1 else torch.cat(out)

    def rescore(self, query: str, texts: Sequence[str]) -> np.ndarray:
        return self.rescore_device(query, texts).cpu().numpy()


def train_cross_encoder(
    triples: Sequence[Tuple[str, str, float]],
    cfg: Optional[EncoderConfig] = None,
    epochs: int = 1,
    batch_size: int = 16,
    learning_rate: float = 2e-5,
    max_len: int = 128,
    seed: int = 0,
    params: Optional[dict] = None,
    device=None,
) -> Tuple[CrossEncoderReranker, List[float]]:
    """Pointwise BCE fine-tune on (query, passage, label) triples; returns
    (reranker, per-step losses).  Starts from ``params`` (a reference-form
    tree) or from the seeded init.  AdamW at a constant ``learning_rate``
    with b1 0.9, b2 0.999, eps 1e-8 and decay 1e-4 (optax's ``adamw``
    defaults, not torch's 1e-2); each epoch shuffles with numpy's
    ``default_rng(seed)`` and drops the tail batch, as the reference does.
    One host read of the loss a step."""
    reranker = CrossEncoderReranker(
        cfg or EncoderConfig(), params=params, seed=seed,
        batch_size=batch_size, max_len=max_len, device=device,
        param_dtype=torch.float32,
    )
    model = reranker.model
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    rng = np.random.default_rng(seed)
    order = np.arange(len(triples))
    losses: List[float] = []
    for _ in range(epochs):
        rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            batch = [triples[i] for i in order[s : s + batch_size]]
            # per-row queries differ: encode each pair on its own
            rows = [reranker._encode_pairs(q, [t]) for q, t, _ in batch]
            x = upload(np.array([[r[0][0] for r in rows],
                                 [r[1][0] for r in rows]], np.int32),
                       reranker.device)
            labels = upload(np.asarray([l for _, _, l in batch], np.float32),
                            reranker.device)
            opt.zero_grad(set_to_none=True)
            loss = F.binary_cross_entropy_with_logits(model(x[0], x[1]),
                                                      labels)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    return reranker, losses
