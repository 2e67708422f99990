"""Causal decoder LM and its greedy decode, in PyTorch.

Counterpart of the reference package's ``models/decoder.py``: the small
prefix-LM behind ``GenerativeSummarizer`` (``runs/summarizer-real``: 4
layers, 256 wide, 32,000 words, ``max_len`` 192), trained on mined
(window -> summary head) pairs.  It is the bi-encoder's trunk
(``models/encoder.py``: pre-LayerNorm blocks, interleaved RoPE, GeGLU,
the same arithmetic step by step) with causal attention, a final
LayerNorm and an output head tied to the token table.

The head follows the reference's ``Embed.attend``: the LayerNorm's bf16
rows times the bf16 table, a bf16 x bf16 product with a **bf16 output**
(f32 accumulation).  Many of 32,000 bf16 logits tie exactly; argmax
takes the first maximal index on both sides, but an accumulation that
rounds the other way can change which entries tie, so a decode on other
hardware is held by teacher forcing, not token for token.

``GreedyGenerator`` is the reference's fixed-shape greedy decode: every
step re-runs the whole padded [B, max_len] sequence and projects only
the last valid position.  All of it stays on the device (argmax, the
writes into ids and mask, the position counters), with no host sync
between steps and one copy to the host at the end: the counterpart of
the reference's one ``lax.scan`` in one jit.  Products run through
``torch.matmul``; this module holds no hand-written kernel (the
reference's products are XLA einsums, not Pallas kernels).
``save_decoder`` writes the reference's checkpoint form.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from modern_search_engines_project_tpu_torch.models.checkpoint import (
    read_checkpoint,
    write_checkpoint,
)
from modern_search_engines_project_tpu_torch.models.encoder import (
    Block,
    LayerNorm,
    _rope_angles,
    _weight,
    init_reference_params,
    params_from_reference,
)
from modern_search_engines_project_tpu_torch.models.word_vocab import WordVocab
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    resolve_device,
    upload,
)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 192
    dtype: str = "bfloat16"
    rope_base: float = 10000.0


class DecoderLM(nn.Module):
    """token ids + mask [B, L] -> next-token logits, bf16.

    ``positions=None`` gives logits at every position, [B, L, vocab];
    ``positions`` [B, P] gathers those rows before the head, [B, P, vocab]
    (the decode projects one row a step).  A negative position counts
    from the end, as the reference's gather does."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        self.tok = _weight((cfg.vocab_size, cfg.dim), dt, device)
        self.blocks = nn.ModuleList(
            Block(cfg, device, causal=True) for _ in range(cfg.n_layers)
        )
        self.ln_f = LayerNorm(cfg.dim, dt, device)
        rope = _rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
        self.register_buffer(
            "rope", torch.tensor(rope, dtype=torch.float32, device=device),
            persistent=False,
        )

    def forward(self, ids, mask, positions=None):
        x = F.embedding(ids, self.tok)
        bool_mask = mask > 0
        for blk in self.blocks:
            x = blk(x, bool_mask, self.rope)
        x = self.ln_f(x)
        if positions is not None:
            L = x.shape[1]
            p = positions.long()
            p = torch.where(p < 0, p + L, p)
            x = torch.gather(x, 1, p[:, :, None].expand(-1, -1, x.shape[-1]))
        # weight-tied head: bf16 rows x bf16 table, bf16 out
        return torch.matmul(x, self.tok.t())


def init_decoder_params(
    cfg: DecoderConfig, normal: Callable[[tuple], np.ndarray]
) -> dict:
    """A random decoder tree in the reference's form (the bi-encoder's:
    ``tok``, ``block{i}``, ``ln_f``; the head is the token table), drawn
    by ``init_reference_params``."""
    return init_reference_params(cfg, normal)


def decoder_params_from_reference(tree: dict, device,
                                  dtype=torch.bfloat16) -> dict:
    """The reference's decoder tree -> a ``DecoderLM`` state dict on
    ``device`` (weights and table cast to ``dtype`` once, f32
    LayerNorms)."""
    return params_from_reference(tree, device, dtype)


def build_decoder(cfg: DecoderConfig, tree: dict, device) -> DecoderLM:
    """A ``DecoderLM`` on ``device`` holding the reference-form ``tree``."""
    model = DecoderLM(cfg, device)
    model.load_state_dict(
        decoder_params_from_reference(tree, device, getattr(torch, cfg.dtype))
    )
    return model.eval()


def save_decoder(params: dict, cfg: DecoderConfig, path: str,
                 vocab: Optional[WordVocab] = None) -> None:
    """Write a decoder's reference-form tree as f16 leaves with its
    ``config.json`` (the encoder checkpoint's form), and ``vocab.json``
    beside them when a generation vocab is given.  ``params_to_reference``
    (``models/encoder.py``) gives a ``DecoderLM``'s tree."""
    write_checkpoint(params, dataclasses.asdict(cfg), path, dtype="float16")
    if vocab is not None:
        vocab.save(os.path.join(path, "vocab.json"))


def load_decoder(
    path: str, device=None
) -> Tuple[DecoderLM, DecoderConfig, Optional[WordVocab]]:
    """(model on ``device``, config, generation vocab or None) of the
    checkpoint in ``path`` (``config.json``, ``params.msgpack`` and, where
    present, ``vocab.json``).  f16 leaves are restored to f32 first, as the
    reference restores them."""
    tree, conf = read_checkpoint(path)
    cfg = DecoderConfig(**conf)
    model = build_decoder(cfg, tree, resolve_device(device))
    vpath = os.path.join(path, "vocab.json")
    vocab = WordVocab.load(vpath) if os.path.exists(vpath) else None
    return model, cfg, vocab


class GreedyGenerator:
    """Fixed-shape greedy decoding on ``device`` ("cuda" by default, or
    "cpu"; with no card and no ``device="cpu"`` this raises).  The model
    is moved there."""

    def __init__(self, model: DecoderLM, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg

    def _prompts(self, prompt_ids, max_new: int):
        """[3, B, L] int32 host array: ids, mask and (in row 0 of the third
        plane) each prompt's length, each prompt cut to L - max_new."""
        L = self.cfg.max_len
        B = len(prompt_ids)
        out = np.zeros((3, B, L), np.int32)
        for b, p in enumerate(prompt_ids):
            p = list(p)[: L - max_new]
            out[0, b, : len(p)] = p
            out[1, b, : len(p)] = 1
            out[2, b, 0] = len(p)
        return out

    @torch.no_grad()
    def generate_device(self, prompt_ids, max_new: int = 48) -> torch.Tensor:
        """[B, max_new] int32 token ids as a tensor on the device, with no
        host sync: one upload, then ``max_new`` steps queued back to back."""
        L = self.cfg.max_len
        x = upload(self._prompts(prompt_ids, max_new), self.device)
        ids, mask, pos = x[0].clone(), x[1].clone(), x[2, :, 0].clone()
        B = ids.shape[0]
        toks = torch.empty((B, max_new), dtype=torch.int32, device=self.device)
        for s in range(max_new):
            logits = self.model(ids, mask, positions=(pos - 1)[:, None])
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            toks[:, s] = nxt
            # past the last position the step still emits, but ids, mask
            # and pos stay as they were
            in_range = pos < L
            safe = torch.where(in_range, pos, L - 1)[:, None].long()
            ids.scatter_(1, safe, torch.where(
                in_range[:, None], nxt[:, None], ids.gather(1, safe)))
            mask.scatter_(1, safe, torch.where(
                in_range[:, None], 1, mask.gather(1, safe)))
            pos = pos + in_range.to(torch.int32)
        return toks

    def generate(self, prompt_ids: Sequence[Sequence[int]],
                 max_new: int = 48) -> np.ndarray:
        """prompt_ids: list of id lists.  Returns [B, max_new] int32 token
        ids (EOS and later positions included; the caller truncates at
        EOS)."""
        return self.generate_device(prompt_ids, max_new).cpu().numpy()
