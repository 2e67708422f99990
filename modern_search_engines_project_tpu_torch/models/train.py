"""Bi-encoder fine-tuning: cosine and InfoNCE losses, hard-negative mining.

Counterpart of the reference package's ``models/train.py`` (the port of
the upstream ``embedder_training/train.py``): pairs with binary labels
under ``CosineSimilarityLoss`` (MSE between cosine and label), or
symmetric in-batch InfoNCE, optionally with one mined hard negative per
row (a third tower, ``loss="infonce_hn"``); hard negatives mined with an
encoder by one chunked device product and a sorted top slice; AdamW with
linear warmup and linear decay.

The arithmetic follows the reference's:
  * the model is ``BiEncoder(param_dtype=torch.float32)``: f32 parameters
    cast to ``cfg.dtype`` on every call (``models/encoder.py``);
  * the losses in f32, with the reference's -1e9 fills for in-batch
    duplicates (``qid`` / ``pid`` crc32 hashes, widened to int64 on
    upload: torch compares uint32 poorly) and for mined negatives equal
    to the row's own positive (``nid``), and ``logsumexp`` in f32;
  * optax's ``adamw(join_schedules(...), weight_decay)``: b1 0.9, b2
    0.999, eps 1e-8 outside the square root, decoupled decay on every
    leaf, and the learning rate of ``lr_schedule`` (computed in f32 as
    optax computes it) written into the optimizer before each step, so
    the first step has rate 0 and leaves the parameters as they were.
    ``torch.optim.AdamW`` computes the same update up to f32 rounding.
One host read of the loss a step, as the reference's loop does.  The
products are ``torch.matmul`` (the reference's are XLA einsums); this
module holds no hand-written kernel.  The reference's dp x tp mesh step
is not ported: ``Trainer(mesh=...)`` raises (ROADMAP section 1, item 7).
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.models.encoder import (
    BiEncoder,
    EncoderConfig,
    TorchEncoder,
    init_reference_params,
    params_from_reference,
    params_to_reference,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    resolve_device,
    upload,
)
from modern_search_engines_project_tpu_torch.retrieval.ops import _sorted_topk
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer

_HASH_KEYS = ("qid", "pid", "nid")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5  # train.py:101
    warmup_ratio: float = 0.1  # train.py:102
    batch_size: int = 256  # train.py:99
    epochs: int = 1  # train.py:100
    num_negatives: int = 5  # train.py:54
    max_len: int = 128
    weight_decay: float = 0.01
    seed: int = 0
    # "cosine": CosineSimilarityLoss (fine-tuning a pretrained backbone);
    # "infonce": symmetric in-batch contrastive (the from-scratch recipe);
    # "infonce_hn": infonce plus one mined hard negative per row (stage B,
    # after mining with the stage-A encoder)
    loss: str = "cosine"
    temperature: float = 0.05


def cosine_loss(model: BiEncoder, batch: dict) -> torch.Tensor:
    """CosineSimilarityLoss: MSE(cos(e1, e2), label)."""
    e1 = model(batch["ids1"], batch["mask1"])
    e2 = model(batch["ids2"], batch["mask2"])
    cos = (e1 * e2).sum(-1)
    return ((cos - batch["label"]) ** 2).mean()


def infonce_loss(model: BiEncoder, batch: dict,
                 temperature: float) -> torch.Tensor:
    """Symmetric in-batch contrastive loss over positive pairs.  Rows whose
    query or passage text repeats elsewhere in the batch are masked out
    of the negatives (``qid`` / ``pid``); with ``ids3`` a third tower of
    one mined negative per row extends the q->p denominator to [B, 2B],
    minus a mined negative whose text is the row's own positive
    (``nid``)."""
    e1 = model(batch["ids1"], batch["mask1"])
    e2 = model(batch["ids2"], batch["mask2"])
    # a tensor divisor: the card divides by a Python scalar through its
    # reciprocal, one ulp off the CPU's (and the reference's) division
    temp = torch.tensor(temperature, dtype=torch.float32, device=e1.device)
    logits = (e1 @ e2.T) / temp  # [B, B]
    B = logits.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=logits.device)
    pid, qid = batch["pid"], batch["qid"]
    dup_p = (pid[:, None] == pid[None, :]) & ~eye
    dup_q = (qid[:, None] == qid[None, :]) & ~eye
    diag = logits.diagonal()
    l_qp = logits.masked_fill(dup_p, -1e9)
    l_pq = logits.T.masked_fill(dup_q, -1e9)
    if "ids3" in batch:
        e3 = model(batch["ids3"], batch["mask3"])
        l_neg = (e1 @ e3.T) / temp  # [B, B]
        false_neg = pid[:, None] == batch["nid"][None, :]
        l_qp = torch.cat([l_qp, l_neg.masked_fill(false_neg, -1e9)], dim=1)
    loss_qp = (torch.logsumexp(l_qp, dim=1) - diag).mean()
    loss_pq = (torch.logsumexp(l_pq, dim=1) - diag).mean()
    return 0.5 * (loss_qp + loss_pq)


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """The reference's schedule, ``optax.join_schedules`` of a linear
    warmup from 0 to ``learning_rate`` over ``max(1, int(total_steps *
    warmup_ratio))`` steps and a linear decay to 0 over the rest, in f32
    as optax computes it.  Step 0 has rate 0."""
    warmup = max(1, int(total_steps * cfg.warmup_ratio))
    decay = max(1, total_steps - warmup)

    def linear(init, end, steps, count):  # optax.linear_schedule
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    lr = cfg.learning_rate

    def at(step: int) -> float:
        if step < warmup:
            return float(linear(0.0, lr, warmup, step))
        return float(linear(lr, 0.0, decay, step - warmup))

    return at


def mine_hard_negatives(
    encoder,
    queries: Sequence[str],
    positives: Sequence[str],
    pool: Sequence[str],
    k: int = 5,
    device=None,
) -> List[Tuple[str, str, float]]:
    """(query, passage, label) triples: each positive pair plus the k
    most-similar non-positive pool passages as negatives.

    ``encoder`` is any ``encode_batch`` model.  Queries are scored against
    the pool in chunks of 4,096 by one product on ``device`` (default: the
    encoder's device, else the card), and the top ``min(k + 8, len(pool))``
    of each row come back, ordered as ``lax.top_k`` orders them (value
    descending, index ascending among ties); the walk that skips the
    positive's own text runs on the host, as the reference's does."""
    dev = resolve_device(device if device is not None
                         else getattr(encoder, "device", None))
    q = np.asarray(encoder.encode_batch(list(queries)), np.float32)
    p = np.asarray(encoder.encode_batch(list(pool)), np.float32)
    triples: List[Tuple[str, str, float]] = []
    chunk = 4096
    top = min(k + 8, len(pool))  # headroom to skip the positive (+ dups)
    p_dev = upload(p, dev).T
    for c0 in range(0, len(queries), chunk):
        c1 = min(c0 + chunk, len(queries))
        _, idx = _sorted_topk(upload(q[c0:c1], dev) @ p_dev, top)
        idx = idx.cpu().numpy()
        for r in range(c1 - c0):
            i = c0 + r
            query, pos = queries[i], positives[i]
            triples.append((query, pos, 1.0))
            negs = 0
            for j in idx[r]:
                if pool[j] == pos:
                    continue
                triples.append((query, pool[j], 0.0))
                negs += 1
                if negs >= k:
                    break
    return triples


def mine_hn_triples(
    encoder,
    pairs: Sequence[Tuple[str, str]],
    pool: Optional[Sequence[str]] = None,
    per_pair: int = 1,
    device=None,
) -> List[Tuple[str, str, str]]:
    """(query, positive, mined-negative) triples for ``loss="infonce_hn"``:
    mined with ``encoder`` (typically the stage-A tower), ``per_pair`` rows
    per pair, one mined negative each.  Raises when no pair yields a
    negative; logs a warning naming how many pairs yielded none."""
    queries = [q for q, _ in pairs]
    positives = [p for _, p in pairs]
    if pool is None:
        pool = list(dict.fromkeys(positives))
    flat = mine_hard_negatives(
        encoder, queries, positives, pool, k=per_pair, device=device
    )
    out: List[Tuple[str, str, str]] = []
    cur_q = cur_p = None
    mined_pairs = set()
    for q, text, label in flat:
        if label == 1.0:
            cur_q, cur_p = q, text
        else:
            out.append((cur_q, cur_p, text))
            mined_pairs.add((cur_q, cur_p))
    if not out:
        raise ValueError(
            "hard-negative mining produced no triples: the passage pool "
            f"({len(pool)} texts) has no non-positive candidates"
        )
    dropped = len(pairs) - len(mined_pairs)
    if dropped:
        logging.getLogger(__name__).warning(
            "mine_hn_triples: %d/%d pairs yielded no mined negative "
            "(candidate slices exhausted by duplicates/positives); "
            "stage B trains on %d triples",
            dropped, len(pairs), len(out),
        )
    return out


class Trainer:
    """The reference's ``Trainer`` on one device (``device``: "cuda" by
    default, or "cpu"; with no card and no ``device="cpu"`` this raises).
    ``mesh`` is not ported: the dp x tp step waits for the multi-GPU work
    (ROADMAP section 1, item 7)."""

    def __init__(
        self,
        enc_cfg: Optional[EncoderConfig] = None,
        train_cfg: Optional[TrainConfig] = None,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the dp x tp training step is not ported "
                "to the GPU yet (ROADMAP section 1, item 7)"
            )
        self.enc_cfg = enc_cfg or EncoderConfig()
        self.cfg = train_cfg or TrainConfig()
        self.device = resolve_device(device)
        self.tokenizer = HashTokenizer(self.enc_cfg.vocab_size)
        self.model: Optional[BiEncoder] = None
        self.opt: Optional[torch.optim.AdamW] = None
        self.lr_at: Optional[Callable[[int], float]] = None
        self.step_count = 0

    # -- setup ---------------------------------------------------------------

    def init(self, total_steps: int = 1000, params: Optional[dict] = None):
        """Create the f32 model and the optimizer.  ``params``: a
        reference-form tree to warm-start from (copied, never aliased);
        without one, the tree is drawn by ``init_reference_params`` from a
        ``torch.Generator`` seeded with ``cfg.seed`` (other bits than the
        reference's init)."""
        if params is None:
            g = torch.Generator().manual_seed(self.cfg.seed)
            params = init_reference_params(
                self.enc_cfg, lambda s: torch.randn(s, generator=g).numpy())
        self.model = BiEncoder(self.enc_cfg, self.device,
                               param_dtype=torch.float32)
        self.model.load_state_dict(
            params_from_reference(params, self.device, torch.float32))
        self.lr_at = lr_schedule(self.cfg, total_steps)
        self.opt = torch.optim.AdamW(
            self.model.parameters(), lr=self.lr_at(0), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.cfg.weight_decay,
        )
        self.step_count = 0
        return self

    @property
    def params(self) -> Optional[dict]:
        """A host copy of the parameters in the reference's tree form
        (``params_to_reference``), or None before ``init``."""
        return None if self.model is None else params_to_reference(self.model)

    # -- train step ----------------------------------------------------------

    def loss(self, batch: dict) -> torch.Tensor:
        """The configured loss of a device batch (``upload_batch``)."""
        if self.cfg.loss in ("infonce", "infonce_hn"):
            return infonce_loss(self.model, batch, self.cfg.temperature)
        return cosine_loss(self.model, batch)

    def upload_batch(self, batch: dict) -> dict:
        """A host batch (``encode_pairs``) on the device; the crc32 hashes
        widened to int64."""
        return {k: upload(v.astype(np.int64) if k in _HASH_KEYS else v,
                          self.device)
                for k, v in batch.items()}

    def step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss (a device
        tensor, before the update), with no host sync."""
        loss = self.loss(self.upload_batch(batch))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.update()
        return loss.detach()

    def update(self) -> None:
        """One AdamW update from the parameters' gradients, at the
        schedule's rate for this step."""
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.step_count)
        self.opt.step()
        self.step_count += 1

    # -- data ----------------------------------------------------------------

    def encode_pairs(
        self, triples: Sequence[Tuple[str, str, float]]
    ) -> dict:
        """Tokenize (query, passage, label) triples into a host batch.

        When the third element is a STRING it is a mined hard-negative
        passage (loss="infonce_hn"): a third tower ids3/mask3 plus its
        text-identity hash ``nid`` are emitted and ``label`` is fixed 1.0.
        """
        L = self.cfg.max_len
        hn = bool(triples) and isinstance(triples[0][2], str)
        if hn and self.cfg.loss != "infonce_hn":
            raise ValueError(
                "(q, p, negative-text) triples require loss='infonce_hn' "
                f"(got {self.cfg.loss!r})"
            )
        if not triples:
            raise ValueError("no training examples provided (empty batch)")
        if self.cfg.loss == "infonce_hn" and not hn:
            raise ValueError(
                "loss='infonce_hn' requires (q, p, negative-text) triples "
                "(e.g. from mine_hn_triples); got float labels"
            )
        t1 = [self.tokenizer.encode(a) for a, _, _ in triples]
        t2 = [self.tokenizer.encode(b) for _, b, _ in triples]
        ids1, mask1 = self.tokenizer.pad_batch(t1, L)
        ids2, mask2 = self.tokenizer.pad_batch(t2, L)
        extra: dict = {}
        if hn:
            t3 = [self.tokenizer.encode(c) for _, _, c in triples]
            ids3, mask3 = self.tokenizer.pad_batch(t3, L)
            extra = {
                "ids3": np.asarray(ids3, np.int32),
                "mask3": np.asarray(mask3, np.int32),
                "nid": np.asarray(
                    [zlib.crc32(c.encode()) for _, _, c in triples],
                    np.uint32,
                ),
            }
        return {
            **extra,
            "ids1": np.asarray(ids1, np.int32),
            "mask1": np.asarray(mask1, np.int32),
            "ids2": np.asarray(ids2, np.int32),
            "mask2": np.asarray(mask2, np.int32),
            "label": np.asarray(
                [1.0] * len(triples) if hn else [l for _, _, l in triples],
                np.float32,
            ),
            # text-identity hashes: infonce masks in-batch false negatives
            "qid": np.asarray(
                [zlib.crc32(a.encode()) for a, _, _ in triples], np.uint32
            ),
            "pid": np.asarray(
                [zlib.crc32(b.encode()) for _, b, _ in triples], np.uint32
            ),
        }

    def train(
        self,
        triples: Sequence[Tuple[str, str, float]],
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        log_every: int = 50,
    ) -> List[float]:
        """Mini-batch training loop; returns per-step losses.  Each epoch
        shuffles with numpy's ``default_rng(seed)``; the last batch wraps
        around to the epoch's first rows; the whole set is tokenized once
        up front when it takes under 6e9 bytes."""
        epochs = epochs or self.cfg.epochs
        bs = batch_size or self.cfg.batch_size
        n = len(triples)
        steps_per_epoch = max(1, n // bs)
        if self.model is None:
            t0 = time.time()
            print("trainer.init ...", file=sys.stderr, flush=True)
            self.init(total_steps=steps_per_epoch * epochs)
            print(f"trainer.init done in {time.time() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        rng = np.random.default_rng(self.cfg.seed)
        losses: List[float] = []
        order = np.arange(n)
        pre = None
        bytes_per_tok = 24 if self.cfg.loss == "infonce_hn" else 16
        if n * self.cfg.max_len * bytes_per_tok < 6e9:
            t0 = time.time()
            print(f"pre-tokenizing {n} triples ...", file=sys.stderr,
                  flush=True)
            pre = self.encode_pairs(triples)
            print(f"pre-tokenized in {time.time() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        for _ in range(epochs):
            rng.shuffle(order)
            for s in range(steps_per_epoch):
                idx = order[s * bs : (s + 1) * bs]
                if len(idx) < bs:  # fixed shapes: wrap around
                    idx = np.concatenate([idx, order[: bs - len(idx)]])
                if pre is not None:
                    batch = {k: v[idx] for k, v in pre.items()}
                else:
                    batch = self.encode_pairs([triples[i] for i in idx])
                losses.append(float(self.step(batch)))
        return losses

    def to_encoder(self, batch_size: int = 64) -> TorchEncoder:
        """The trained tower as an inference ``TorchEncoder`` on the same
        device (weights in ``cfg.dtype``)."""
        return TorchEncoder(
            self.enc_cfg,
            params=self.params,
            batch_size=batch_size,
            max_len=self.cfg.max_len,
            device=self.device,
        )
