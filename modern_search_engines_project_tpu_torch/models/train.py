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
module holds no hand-written kernel.

The dp x tp step (``Trainer(mesh=Mesh(devices, ("dp", "tp")))``) computes
the one-device function, as the reference's GSPMD step does, with the
reference's layout (``param_spec``): 1-D leaves replicated, the token
table split on its feature axis, ``qkv`` and ``wi`` by column, ``proj``
and ``wo`` by row, everything else replicated.  ``ShardedBiEncoder``
keeps one f32 master a tp shard, on that shard's device in dp row 0,
and hands each dp replica a differentiable copy (``Tensor.to``), so
autograd sums the replicas' gradients into the masters and AdamW steps
them; within one process this needs no hand-written collective.  Each dp
replica runs ``models/encoder.encode`` on its slice of the batch with
``TensorParallel`` products: a column product multiplies the input by
each shard on its device and concatenates the outputs (whatever the
columns mean: q | k | v, gate | up), a row product multiplies each
input slice by its rows and adds the partial sums in f32 (the only
change of summation order).  The replicated arithmetic (LayerNorm,
RoPE, attention, GeGLU) runs on the replica's first tp device.  The
loss takes the embeddings of the whole batch on the mesh's first
device, so InfoNCE's in-batch negatives and duplicate masks span every
dp slice.  A device may repeat in the mesh
(``Mesh(np.array([cuda:0] * 4).reshape(2, 2), ("dp", "tp"))`` runs the
step on one card).
"""

from __future__ import annotations

import dataclasses
import logging
import types
import sys
import time
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from modern_search_engines_project_tpu_torch.models.encoder import (
    BiEncoder,
    EncoderConfig,
    Products,
    TorchEncoder,
    encode,
    init_reference_params,
    params_from_reference,
    params_to_reference,
    rope_table,
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


# ---- the dp x tp step -------------------------------------------------------


def reference_path(name: str) -> str:
    """A ``BiEncoder`` state-dict name -> the reference's leaf path, e.g.
    ``blocks.3.attn.qkv`` -> ``block3/attn/qkv/kernel``, ``tok`` ->
    ``tok/embedding``."""
    if name == "tok":
        return "tok/embedding"
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"block{parts[1]}"] + parts[2:]
        if parts[-1] in ("qkv", "proj", "wi", "wo"):
            parts.append("kernel")
    return "/".join(parts)


def param_spec(path: str, x) -> Optional[int]:
    """The axis over which the tp axis splits a leaf (None: replicated),
    by the reference's ``Trainer._param_spec`` on its leaf ``path``
    (``reference_path``): leaves under 2-D replicated, the token table on
    its feature axis (1), ``qkv`` and ``wi`` by column (1), ``proj`` and
    ``wo`` by row (0), everything else replicated."""
    if x.ndim < 2:
        return None
    if "tok" in path and "embedding" in path:
        return 1
    if "qkv" in path or "wi" in path:
        return 1
    if "proj" in path or "wo" in path:
        return 0
    return None


class TensorParallel(Products):
    """The products of one dp replica over its tp devices ``devs``, the
    activations on ``devs[0]``.  Weights are lists of tp shards, one on
    each device."""

    def __init__(self, devs):
        self.devs = list(devs)
        self.lead = self.devs[0]

    def col(self, x, ws, dtype):
        outs = [torch.matmul(x.to(d), w.to(dtype))
                for d, w in zip(self.devs, ws)]
        return torch.cat([o.to(self.lead) for o in outs], dim=-1)

    def row(self, x, ws, dtype):
        n, acc = ws[0].shape[0], None
        for j, (d, w) in enumerate(zip(self.devs, ws)):
            part = torch.matmul(x[..., j * n:(j + 1) * n].to(d), w.to(dtype))
            part = part.to(self.lead, torch.float32)
            acc = part if acc is None else acc + part
        return acc.to(dtype)

    def embed(self, ids, toks):
        return torch.cat([F.embedding(ids.to(d), t).to(self.lead)
                          for d, t in zip(self.devs, toks)], dim=-1)


class ShardedBiEncoder:
    """A trainable ``BiEncoder`` over a ("dp", "tp") mesh: f32 master
    shards laid out by ``param_spec`` (``shards[name][j]`` on
    ``mesh.devices[0, j]``; a replicated leaf has one master, on
    ``mesh.devices[0, 0]``).  Called on per-replica slices of ids and
    mask, it returns the whole batch's embeddings on
    ``mesh.devices[0, 0]``."""

    def __init__(self, cfg: EncoderConfig, mesh, state: dict):
        self.cfg, self.mesh = cfg, mesh
        self.dtype = getattr(torch, cfg.dtype)
        self.devs = mesh.devices
        self.dp, self.tp = self.devs.shape
        self.device = self.devs[0, 0]
        self.axis, self.shards = {}, {}
        for name, full in state.items():
            ax = param_spec(reference_path(name), full)
            if ax is not None and full.shape[ax] % self.tp:
                raise ValueError(
                    f"{reference_path(name)} of shape {tuple(full.shape)}: "
                    f"axis {ax} does not split over tp = {self.tp}")
            parts = ([full] if ax is None
                     else list(full.chunk(self.tp, dim=ax)))
            self.axis[name] = ax
            self.shards[name] = [
                p.detach().to(self.devs[0, j], torch.float32, copy=True)
                .contiguous().requires_grad_(True)
                for j, p in enumerate(parts)]
        self.ropes = [rope_table(cfg, self.devs[i, 0]) for i in range(self.dp)]
        self.products = [TensorParallel(self.devs[i]) for i in range(self.dp)]

    def parameters(self) -> list:
        return [p for ps in self.shards.values() for p in ps]

    def layout(self) -> dict:
        """{reference path: (split axis or None, [(device, shape) of each
        master shard])}."""
        return {reference_path(n): (self.axis[n],
                                    [(p.device, tuple(p.shape)) for p in ps])
                for n, ps in self.shards.items()}

    def gathered(self, grads: bool = False) -> dict:
        """The full tensors (or their gradients) under ``BiEncoder``'s
        state-dict names, on the mesh's first device."""
        out = {}
        for n, ps in self.shards.items():
            ts = [(p.grad if grads else p.detach()).to(self.device) for p in ps]
            out[n] = ts[0] if self.axis[n] is None else torch.cat(
                ts, dim=self.axis[n])
        return out

    def _replica(self, i: int):
        """Replica ``i``'s weights: differentiable copies of the masters
        on its devices, in the attribute tree ``encoder.encode`` reads."""
        devs = self.devs[i]

        def leaf(name):
            ps = self.shards[name]
            if self.axis[name] is None:
                return ps[0].to(devs[0])
            return [p.to(devs[j]) for j, p in enumerate(ps)]

        def ln(prefix):
            return types.SimpleNamespace(scale=leaf(prefix + ".scale"),
                                         bias=leaf(prefix + ".bias"),
                                         eps=1e-6)

        blocks = []
        for k in range(self.cfg.n_layers):
            p = f"blocks.{k}."
            blocks.append(types.SimpleNamespace(
                ln1=ln(p + "ln1"), ln2=ln(p + "ln2"),
                attn=types.SimpleNamespace(qkv=leaf(p + "attn.qkv"),
                                           proj=leaf(p + "attn.proj")),
                mlp=types.SimpleNamespace(wi=leaf(p + "mlp.wi"),
                                          wo=leaf(p + "mlp.wo"))))
        return types.SimpleNamespace(tok=leaf("tok"), blocks=blocks,
                                     ln_f=ln("ln_f"))

    def __call__(self, ids: list, mask: list) -> torch.Tensor:
        outs = []
        for i in range(self.dp):
            e = encode(self._replica(i), ids[i], mask[i], self.ropes[i],
                       self.cfg, self.dtype, self.products[i],
                       recompute=torch.is_grad_enabled())
            outs.append(e.to(self.device))
        return torch.cat(outs)


class Trainer:
    """The reference's ``Trainer`` on one device (``device``: "cuda" by
    default, or "cpu"; with no card and no ``device="cpu"`` this raises),
    or over ``mesh``, a ``parallel.sharding.Mesh`` on axes ("dp", "tp"):
    the dp x tp step (the module docstring), its devices taking the place
    of ``device``."""

    def __init__(
        self,
        enc_cfg: Optional[EncoderConfig] = None,
        train_cfg: Optional[TrainConfig] = None,
        mesh=None,
        device=None,
    ):
        axes = tuple(getattr(mesh, "axis_names", ()))
        if mesh is not None and axes != ("dp", "tp"):
            raise ValueError(
                f"Trainer(mesh=...) takes a parallel.sharding.Mesh on axes "
                f"('dp', 'tp'), not {axes or type(mesh).__name__}")
        self.enc_cfg = enc_cfg or EncoderConfig()
        self.cfg = train_cfg or TrainConfig()
        self.mesh = mesh
        self.device = (mesh.devices[0, 0] if mesh is not None
                       else resolve_device(device))
        self.tokenizer = HashTokenizer(self.enc_cfg.vocab_size)
        self.model = None  # a BiEncoder, or a ShardedBiEncoder on a mesh
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
        state = params_from_reference(params, self.device, torch.float32)
        if self.mesh is not None:
            self.model = ShardedBiEncoder(self.enc_cfg, self.mesh, state)
        else:
            self.model = BiEncoder(self.enc_cfg, self.device,
                                   param_dtype=torch.float32)
            self.model.load_state_dict(state)
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
        if self.model is None:
            return None
        if self.mesh is not None:
            return params_to_reference(self.model.gathered())
        return params_to_reference(self.model)

    def grads(self) -> dict:
        """The parameters' gradients (after ``loss(...).backward()``) as a
        host tree in the reference's form."""
        if self.mesh is not None:
            return params_to_reference(self.model.gathered(grads=True))
        return params_to_reference(
            {n: p.grad for n, p in self.model.named_parameters()})

    def layout(self) -> dict:
        """On a mesh: {reference leaf path: (tp split axis or None,
        [(device, shape) of each master shard])}."""
        if self.mesh is None:
            raise ValueError("layout() describes a mesh's shards")
        return self.model.layout()

    # -- train step ----------------------------------------------------------

    def loss(self, batch: dict) -> torch.Tensor:
        """The configured loss of a device batch (``upload_batch``)."""
        if self.cfg.loss in ("infonce", "infonce_hn"):
            return infonce_loss(self.model, batch, self.cfg.temperature)
        return cosine_loss(self.model, batch)

    def upload_batch(self, batch: dict) -> dict:
        """A host batch (``encode_pairs``) on the device; the crc32 hashes
        widened to int64.  On a mesh the token ids and masks are split over
        dp, a list of one slice a replica on its first tp device, and the
        loss's inputs (labels, hashes) stay whole on the mesh's first
        device; a batch that dp does not divide is refused."""
        if self.mesh is None:
            return {k: upload(v.astype(np.int64) if k in _HASH_KEYS else v,
                              self.device)
                    for k, v in batch.items()}
        dp = self.model.dp
        B = len(batch["ids1"])
        if B % dp:
            raise ValueError(
                f"a batch of {B} rows does not split over dp = {dp}")
        b, out = B // dp, {}
        for k, v in batch.items():
            if k.startswith(("ids", "mask")):
                out[k] = [upload(v[i * b:(i + 1) * b],
                                 self.mesh.devices[i, 0]) for i in range(dp)]
            else:
                out[k] = upload(v.astype(np.int64) if k in _HASH_KEYS else v,
                                self.device)
        return out

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
        device, the mesh's first on a mesh (weights in ``cfg.dtype``)."""
        return TorchEncoder(
            self.enc_cfg,
            params=self.params,
            batch_size=batch_size,
            max_len=self.cfg.max_len,
            device=self.device,
        )
