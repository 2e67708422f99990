"""Sharded serving: postings and chunk banks split by document over a mesh.

Counterpart of the reference package's ``parallel/sharding.py``.  The
document axis is range-partitioned over the mesh's shard axis; every shard
holds its own CSR postings, slot postings and bucket banks (a one-device
``DeviceIndex`` with ``n_docs_pad = d_loc``), and chunks stay with their
documents, so per-doc pooling never crosses shards.

One controller a process: the reference runs one SPMD program over a
device mesh; here one process walks its shards in lockstep and
joins them with collectives.  Per batch:

  1. per shard: BM25 stage 1 (slot kernel 1, a U-dedup kernel, or the CSR
     scatter) and a local top-k, ids made global (``lidx + s_id * d_loc``);
  2. ONE gather of the packed ``vals ++ ids`` candidate sets (ids ride as
     f32 bit patterns) and a re-top-k with ``lax.top_k``'s tie order; with
     a "host" axis, within the host first, then one set a host across;
  3. per shard: the candidate mask with the per-shard tie quota, kernel 4
     once a bucket, the pool extrema, then ONE max of ``(-lo, hi)``;
  4. per shard: fusion and positional math, the per-candidate combine as
     ONE max of ``(scores, win as f32)`` (two maxes when chunk ids reach
     2^24), and a final top-k on the merge device.

Collectives inside a process are functions over per-shard tensor lists: a
gather is a concatenation on the merge device, shard-major in flat shard
order (host-major: ``host * n_local + shard``); a max is an elementwise
maximum there.  Across processes (``parallel.multihost``) a gather is
``dist.all_gather_into_tensor`` of the packed tensor and a max
``dist.all_reduce(MAX)``, on NCCL or gloo (which takes CUDA tensors for
both).

The bitcast ids: ids below 2^23 are f32 subnormals, so only copies carry
them (a concatenation, a collective's copy); they are read back as int32
before any indexing, and nothing computes on them as floats.

A device may repeat in a mesh: ``Mesh(np.array([torch.device("cuda", 0)]
* 8), ("shard",))`` is eight shards on one card, the counterpart of the
reference's eight virtual CPU devices.  Shards on a CUDA device launch
the kernels or raise; on the CPU the wrappers take their plain versions.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index.builder import IndexArtifacts
from modern_search_engines_project_tpu_torch.retrieval import ops
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    bm25_score_slots,
    bm25_score_slots_udedup,
    dedup_query_terms,
    u_pad_for,
    udedup_plan,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    DOC_BLOCK,
    SLOT_COLS,
    _round_up,
    _sort_by_load,
    _stride_classes,
    build_slot_postings,
    csr_fields,
    device_index_from_numpy,
    posting_cap_for,
    resolve_device,
    upload,
)

SERVING_AXES = (("shard",), ("dp", "shard"), ("host", "shard"))
TRAINING_AXES = (("dp", "tp"),)  # models/train.py's dp x tp step
AXES = SERVING_AXES + TRAINING_AXES


@dataclasses.dataclass(eq=False)
class Mesh:
    """Devices on named axes: ``("shard",)``, ``("dp", "shard")`` (the
    index replicated over dp, query batches split over it) or
    ``("host", "shard")`` (a two-level merge) for serving; ``("dp",
    "tp")`` for the training step (``models/train.Trainer``), which
    serving refuses.  ``devices`` is an object
    array of ``torch.device``, one axis a name; a device may repeat.
    ``owner`` (same shape, ints) names the process that holds each device
    when the mesh spans several processes (``parallel.multihost``); None
    means this process holds them all."""

    devices: np.ndarray
    axis_names: tuple
    owner: Optional[np.ndarray] = None

    def __post_init__(self):
        self.devices = np.asarray(self.devices, dtype=object)
        self.axis_names = tuple(self.axis_names)
        if self.axis_names not in AXES:
            raise ValueError(f"mesh axes {self.axis_names}: one of {AXES}")
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(
                f"mesh devices of shape {self.devices.shape} for axes "
                f"{self.axis_names}")
        self.devices = np.vectorize(resolve_device, otypes=[object])(
            self.devices)
        if self.owner is not None:
            self.owner = np.asarray(self.owner, np.int64)
            if self.owner.shape != self.devices.shape:
                raise ValueError("mesh owner and devices differ in shape")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _cards(n: int, device) -> list:
    """The first ``n`` visible devices of ``device``'s type ("cuda" by
    default, or "cpu", which repeats the one CPU)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > count:
        raise ValueError(
            f"{n} shards need {n} visible CUDA devices, {count} visible; to "
            "put several shards on one card, build the mesh yourself, e.g. "
            "Mesh(np.array([torch.device('cuda', 0)] * 8), ('shard',))")
    if n < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for CPU shards")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard",
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible cards (all of them
    when None); ``device="cpu"`` gives ``n_devices`` (default 1) CPU
    shards.  Raises when fewer cards are visible."""
    kind = torch.device("cuda" if device is None else device).type
    if n_devices is None:
        n_devices = 1 if kind == "cpu" else (
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
    return Mesh(np.array(_cards(n_devices, device), dtype=object), (axis,))


def make_mesh_2d(dp: int, shard: int, device=None) -> Mesh:
    """The (dp, shard) deployment mesh over ``dp * shard`` visible cards
    (or CPU shards with ``device="cpu"``): the index sharded over
    ``shard`` and replicated over ``dp``, query batches split over dp.
    Raises when fewer cards are visible."""
    devs = np.array(_cards(dp * shard, device), dtype=object)
    return Mesh(devs.reshape(dp, shard), ("dp", "shard"))


def _layout(mesh: Mesh):
    """(dp, S, n_host, rows): ``rows[r]`` lists (flat shard id, device) of
    the shards this process holds in dp row ``r``, in flat (host-major)
    order.  Raises on a training mesh."""
    if mesh.axis_names not in SERVING_AXES:
        raise ValueError(
            f"a serving mesh has axes {SERVING_AXES}, not {mesh.axis_names} "
            "(a ('dp', 'tp') mesh is the training step's)")
    shape = mesh.shape
    devs = mesh.devices
    if "dp" in shape:
        dp, S = devs.shape
        grid = [[(s, devs[r, s]) for s in range(S)] for r in range(dp)]
        if mesh.owner is not None:
            raise ValueError("a (dp, shard) mesh spans one process")
        return dp, S, 1, grid
    flat = devs.reshape(-1)
    owner = None if mesh.owner is None else mesh.owner.reshape(-1)
    rank = 0 if owner is None else torch.distributed.get_rank()
    row = [(f, flat[f]) for f in range(flat.size)
           if owner is None or owner[f] == rank]
    if not row:
        raise ValueError(f"process {rank} holds no shard of the mesh")
    if owner is not None:  # the ranks' shards: equal, contiguous, in order
        n_local = len(row)
        if (owner != np.repeat(np.arange(flat.size // n_local), n_local)).any():
            raise ValueError("each process must hold an equal, contiguous, "
                             "rank-ordered run of the flat shard ids")
    return 1, flat.size, shape.get("host", 1), [row]


@dataclasses.dataclass
class ShardedDeviceIndex:
    """The per-shard indexes under one global schema.

    ``rows[r][c]`` is the ``DeviceIndex`` of local shard ``c`` in dp row
    ``r`` (a replica on a device that already holds the same shard is the
    same object).  Every shard has the same buckets ``((n, cnt_pad), ...)``
    (capacities from the largest shard, 128-rounded), ``d_loc`` docs, the
    same slot stride classes (from the cross-shard maximum a group) and one
    ``posting_cap``; its docs are bucket-permuted, and the global candidate
    index ``shard * d_loc + local`` maps to the artifact doc index through
    ``doc_perm`` on the host (-1: a pad)."""

    rows: list
    shard_ids: tuple  # flat shard id of each local column
    buckets: tuple
    doc_perm: np.ndarray  # [S * d_loc]
    mesh: Mesh
    n_shards: int
    n_docs: int
    d_loc: int
    posting_cap: int

    @property
    def n_docs_pad(self) -> int:
        return self.n_shards * self.d_loc

    @property
    def shards(self) -> list:
        """The local shards of dp row 0."""
        return self.rows[0]

    @classmethod
    def from_artifacts(
        cls,
        art: IndexArtifacts,
        mesh: Mesh,
        config: Optional[Config] = None,
        bank_dtype=None,
        posting_cap: Optional[int] = None,
    ) -> "ShardedDeviceIndex":
        """The reference's construction (same numpy arithmetic), each
        local shard then placed on its device; ``bank_dtype`` as in
        ``DeviceIndex`` (bf16 on the card, f32 on the CPU, or "int8")."""
        cfg = config or art.config
        dp, S, _, grid = _layout(mesh)
        n_docs = art.n_docs
        V = art.n_terms
        dim = art.chunk_emb.shape[1]
        d_base = -(-max(n_docs, 1) // S)  # docs a shard, original order

        dnc = np.minimum(
            np.asarray(art.doc_n_chunks)[:n_docs], cfg.max_chunks_per_doc
        ).astype(np.int64)
        starts_all = np.asarray(art.doc_chunk_start)[:n_docs]
        post_load = np.bincount(
            np.asarray(art.post_docs), minlength=max(n_docs, 1)
        ).astype(np.int64)
        shard_of = (
            np.arange(n_docs) // d_base if n_docs else np.zeros(0, np.int64)
        )

        # ---- global bucket schema: capacities = the largest shard's count
        distinct = sorted(set(int(x) for x in dnc)) or [1]
        cnt_pads = []
        for n in distinct:
            per_shard = np.bincount(shard_of[dnc == n], minlength=S)
            cnt_pads.append(_round_up(max(int(per_shard.max()), 8), 128))
        total = sum(cnt_pads)
        # the DOC_BLOCK rounding goes to the SMALLEST-stride bucket
        cnt_pads[0] += max(_round_up(total, DOC_BLOCK), DOC_BLOCK) - total
        d_loc = sum(cnt_pads)

        # ---- per-shard bucket fill, docs sorted by load ------------------
        gperm = np.full((S, d_loc), -1, np.int64)
        bank_src = []  # per bucket: (S, n, cnt) chunk rows of each doc slot
        bucket_valid_l, bucket_start_l = [], []
        off = 0
        for n, cnt_pad in zip(distinct, cnt_pads):
            src_b = np.full((S, n, cnt_pad), -1, np.int64)
            valid = np.zeros((S, cnt_pad), bool)
            bstart = np.zeros((S, cnt_pad), np.int32)
            for s in range(S):
                idxs = _sort_by_load(
                    np.nonzero((dnc == n) & (shard_of == s))[0], post_load
                )
                cnt = len(idxs)
                if cnt:
                    src_b[s, :, :cnt] = (
                        starts_all[idxs][None, :] + np.arange(n)[:, None])
                    valid[s, :cnt] = True
                    bstart[s, :cnt] = starts_all[idxs]
                    gperm[s, off : off + cnt] = idxs
            bank_src.append(src_b)
            bucket_valid_l.append(valid)
            bucket_start_l.append(bstart)
            off += cnt_pad
        doc_perm = gperm.reshape(-1)

        # original doc idx -> permuted local idx within its shard
        inv_local = np.zeros(max(n_docs, 1), np.int32)
        for s in range(S):
            real = gperm[s] >= 0
            inv_local[gperm[s][real]] = np.nonzero(real)[0].astype(np.int32)

        # ---- per-shard CSR postings in the permuted local order ----------
        post_docs_all = np.asarray(art.post_docs)
        term_of_post = np.repeat(np.arange(V, dtype=np.int64),
                                 np.diff(art.indptr))
        post_shard = (post_docs_all // d_base if n_docs
                      else np.zeros(0, np.int64))
        indptr_l, docs_l, imp_l = [], [], []
        for s in range(S):
            mask = post_shard == s
            docs_l.append(inv_local[post_docs_all[mask]])
            imp_l.append(np.asarray(art.post_impact)[mask])
            counts = np.bincount(term_of_post[mask], minlength=V)
            ip = np.zeros(V + 1, np.int32)
            np.cumsum(counts, out=ip[1:])
            indptr_l.append(ip)
        nnz_pad = max(_round_up(max(len(d) for d in docs_l), 128), 128)

        # shared stride classes from the cross-shard maximum a group, so
        # every shard has the same class structure (and one col_unperm)
        n_slots = _round_up(max(d_loc, SLOT_COLS), SLOT_COLS)
        gmax = np.zeros(n_slots // SLOT_COLS, np.int64)
        for s in range(S):
            counts = np.bincount(docs_l[s], minlength=n_slots)
            gmax = np.maximum(gmax, np.maximum.reduceat(
                counts, np.arange(0, n_slots, SLOT_COLS)))
        S_g = _stride_classes(gmax)

        if posting_cap is None:  # the largest shard's
            posting_cap = max(posting_cap_for(ip, cfg.max_query_terms)
                              for ip in indptr_l)

        def shard_fields(s: int) -> dict:
            slot_terms, slot_impact, col_unperm = build_slot_postings(
                indptr_l[s], docs_l[s], imp_l[s], d_loc, S_g=S_g)
            pd = np.zeros(nnz_pad, np.int32)
            pi = np.zeros(nnz_pad, np.float32)
            pd[: len(docs_l[s])] = docs_l[s]
            pi[: len(docs_l[s])] = imp_l[s]
            emb = []
            for src_b in bank_src:
                e = np.zeros(src_b.shape[1:] + (dim,), np.float32)
                real = src_b[s] >= 0
                e[real] = art.chunk_emb[src_b[s][real]]
                emb.append(e)
            n_ch = int(sum((b[s] >= 0).sum() for b in bank_src))
            return {
                "slot_terms": slot_terms, "slot_impact": slot_impact,
                "col_unperm": col_unperm,
                **csr_fields(indptr_l[s], pd, pi, posting_cap),
                "buckets": tuple(zip(distinct, cnt_pads)),
                "bucket_emb": emb,
                "bucket_valid": [v[s] for v in bucket_valid_l],
                "bucket_start": [b[s] for b in bucket_start_l],
                "doc_perm": gperm[s],
                "n_docs": int((gperm[s] >= 0).sum()),
                "n_docs_pad": d_loc,
                "n_chunks_pad": max(_round_up(n_ch, 128), 128),
                "n_terms": V,
                "nnz": len(docs_l[s]),
            }

        # one DeviceIndex a (shard, device): a dp replica on a device that
        # already holds the shard shares its tensors
        placed = {}
        rows = []
        for row in grid:
            out = []
            for s, dev in row:
                key = (s, dev)
                if key not in placed:
                    placed[key] = device_index_from_numpy(
                        shard_fields(s), dev, bank_dtype)
                out.append(placed[key])
            rows.append(out)
        return cls(
            rows=rows,
            shard_ids=tuple(s for s, _ in grid[0]),
            buckets=tuple((int(n), int(c)) for n, c in zip(distinct, cnt_pads)),
            doc_perm=doc_perm,
            mesh=mesh,
            n_shards=S,
            n_docs=n_docs,
            d_loc=d_loc,
            posting_cap=int(posting_cap),
        )


# ---- collectives -------------------------------------------------------------


def _cross_all_gather(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] on every process -> [world * n, ...], rank-major."""
    dist = torch.distributed
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size() * x.shape[0],)
                      + tuple(x.shape[1:]))
    with warnings.catch_warnings():  # renamed all_gather_single in new torch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x)
    return out


def _cross_max(x: torch.Tensor) -> torch.Tensor:
    dist = torch.distributed
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


class Collectives:
    """Gathers and maxes over per-shard tensor lists, counted a call.

    Each method takes ``jobs``: one list of per-shard tensors a group
    (a dp row, or a host within one) and returns one result a group on
    the device of the group's first tensor.  ``cross=True`` continues the
    collective across the processes of ``torch.distributed`` (this
    process's part first reduced locally); the host wall time spent
    there is added to ``cross_s``."""

    def __init__(self, multiprocess: bool):
        self.multiprocess = multiprocess
        self.counts = collections.Counter()
        self.cross_s = 0.0

    def _cross(self, fn, x):
        t0 = time.perf_counter()
        out = fn(x)
        self.cross_s += time.perf_counter() - t0
        return out

    def gather(self, jobs, cross: bool = True):
        """Each group's tensors stacked shard-major on its first device:
        [n_group (x world), ...]."""
        self.counts["gather"] += 1
        out = []
        for parts in jobs:
            dev = parts[0].device
            x = torch.stack([p.to(dev) for p in parts])
            if cross and self.multiprocess:
                x = self._cross(_cross_all_gather, x)
            out.append(x)
        return out

    def max(self, jobs, cross: bool = True):
        """Each group's elementwise maximum on its first device."""
        self.counts["max"] += 1
        out = []
        for parts in jobs:
            dev = parts[0].device
            x = parts[0]
            for p in parts[1:]:
                x = torch.maximum(x, p.to(dev))
            if cross and self.multiprocess:
                x = self._cross(_cross_max, x)
            out.append(x)
        return out


def _pack(vals: torch.Tensor, *ids: torch.Tensor) -> torch.Tensor:
    """One candidate set as [B, (1 + len(ids)) * k] f32: the values, then
    the bits of each int32 column (ids, windows)."""
    return torch.cat(
        [vals] + [x.to(torch.int32).view(torch.float32) for x in ids], dim=1)


def _merge_topk(packed: torch.Tensor, n_cols: int, k_out: int):
    """Gathered candidate sets [n, B, n_cols * k] (``_pack``'s layout) ->
    the top ``k_out`` of their union: (vals [B, k], int32 columns...), ties
    by (shard, local rank) as ``lax.top_k`` breaks them.  The int32
    columns are read from the gathered bits before anything reorders
    them."""
    n, B, w = packed.shape
    k_in = w // n_cols

    def col(x, i):
        return x[:, :, i * k_in:(i + 1) * k_in].permute(1, 0, 2).reshape(
            B, n * k_in)

    vals, sel = ops._sorted_topk(col(packed, 0), min(k_out, n * k_in))
    ints = packed.view(torch.int32)
    return (vals, *(col(ints, i).gather(1, sel.long())
                    for i in range(1, n_cols)))


# ---- the backend -------------------------------------------------------------


class ShardedEngineBackend:
    """The sharded device half of ``SearchEngine``: ``rank`` (the hybrid
    path), ``dense_topk`` and ``bm25_topk``, each returning tensors on the
    merge device (the first local shard's) with doc ids in the permuted
    global space (``doc_perm`` maps them back).

    ``use_pallas``: None or True runs stage 1 through the slot kernels (1,
    or 2/3 as ``udedup_plan`` picks; their plain versions on the CPU);
    False through the CSR scatter.  Stage 2 is kernel 4 a bucket either
    way (on the card; int8 banks take the s32 product).
    ``last_collectives`` holds the collectives of the latest call."""

    def __init__(
        self,
        art: IndexArtifacts,
        mesh: Mesh,
        config: Optional[Config] = None,
        bank_dtype=None,
        use_pallas: Optional[bool] = None,
    ):
        cfg = config or art.config
        self.cfg = cfg
        self.use_pallas = use_pallas is not False
        self.sidx = ShardedDeviceIndex.from_artifacts(
            art, mesh, cfg, bank_dtype=bank_dtype)
        s = self.sidx
        self.doc_perm = s.doc_perm
        self.k_ret = min(cfg.top_k_retrieval, s.n_docs_pad)
        self.dp, _, self.n_host, grid = _layout(mesh)
        self.device = s.rows[0][0].device
        # host groups of the local columns: (host, columns); in one process
        # a ("host", "shard") mesh merges within each host, then across
        n_local = mesh.devices.shape[-1] if "host" in mesh.shape else None
        cols = collections.defaultdict(list)
        for c, (f, _) in enumerate(grid[0]):
            cols[f // n_local if n_local else 0].append(c)
        self._hosts = list(cols.values())
        self.multiprocess = mesh.owner is not None
        # the (score, win) combine rides one max while chunk ids are exact
        # in f32
        self.fuse_win = s.n_docs * cfg.max_chunks_per_doc < (1 << 24)
        # the latest call's collectives, and its host ms in cross-process
        # ones (each call counts its own: two threads may rank at once)
        self.last_collectives = {}
        self.cross_ms = 0.0

    # -- helpers --

    def _pad_dp(self, x, B: int):
        """Pad the batch axis (0) of a numpy array or tensor to a dp
        multiple with zeros."""
        pad = (-B) % self.dp
        if not pad:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    def _finish(self, coll, outs, B: int):
        self.last_collectives = dict(coll.counts)
        self.cross_ms = coll.cross_s * 1e3
        dev = self.device
        return tuple(
            torch.cat([o[i].to(dev) for o in outs])[:B]
            for i in range(len(outs[0]))
        )

    def _row_inputs(self, arrays, r: int, Bd: int):
        """Row ``r``'s slice of each batch array, once a distinct device of
        the row: {device: [tensor, ...]}."""
        out = {}
        for sh in self.sidx.rows[r]:
            if sh.device not in out:
                out[sh.device] = [
                    a[r * Bd:(r + 1) * Bd].to(sh.device, non_blocking=True)
                    if isinstance(a, torch.Tensor)
                    else upload(a[r * Bd:(r + 1) * Bd], sh.device)
                    for a in arrays
                ]
        return out

    def _merge(self, coll, parts, k_out: int, levels: bool = True):
        """The candidate merge of every dp row: ``parts[r]`` holds one
        (vals, ids, ...) a local shard; returns one (vals, int32 columns...)
        a row on its merge device, the top ``k_out`` of all shards.  Flat:
        one gather over every shard (across processes too).  With hosts
        and ``levels``: one gather within each host, then one of the
        hosts' merged sets."""
        n_cols = len(parts[0][0])
        if self.n_host == 1 or not levels:
            return [_merge_topk(p, n_cols, k_out) for p in coll.gather(
                [[_pack(*x) for x in row] for row in parts])]
        per_host = [_merge_topk(p, n_cols, k_out) for p in coll.gather(
            [[_pack(*row[c]) for c in cols]
             for row in parts for cols in self._hosts], cross=False)]
        n_h = len(self._hosts)
        return [_merge_topk(p, n_cols, k_out) for p in coll.gather(
            [[_pack(*per_host[r * n_h + h]) for h in range(n_h)]
             for r in range(len(parts))])]

    # -- the hybrid path --

    def rank(self, term_ids, qtf, qvec):
        """One batch: (doc, fused, bm25_norm, win, valid), each [B, k]."""
        s, cfg = self.sidx, self.cfg
        term_ids = np.asarray(term_ids, np.int32)
        qtf = np.asarray(qtf, np.float32)
        Bq = term_ids.shape[0]
        plan = None
        if self.use_pallas and cfg.bm25_udedup:
            u_pad = u_pad_for(int(np.unique(term_ids[term_ids >= 0]).size))
            # each dp row scores Bq / dp queries
            plan = udedup_plan(u_pad, max(1, Bq // self.dp))
            if cfg.bm25_udedup == "always" and plan is None:
                plan = "sublane"
        if not isinstance(qvec, torch.Tensor):
            qvec = np.asarray(qvec, np.float32)
        qvec = self._pad_dp(qvec, Bq)
        Bd = qvec.shape[0] // self.dp
        if plan is not None:
            uids, w = dedup_query_terms(term_ids, qtf)
            # [B, 2, U]: the dp split stays a split of the leading axis
            w2 = self._pad_dp(np.stack([w[:Bq], w[Bq:]], axis=1), Bq)
            batch = (w2, qvec)
        else:
            batch = (self._pad_dp(term_ids, Bq), self._pad_dp(qtf, Bq), qvec)
        coll = Collectives(self.multiprocess)
        d_loc = s.d_loc
        k_loc = min(self.k_ret, d_loc)

        # ---- stage 1: local BM25 + local top-k, ids made global ----------
        bms, cands, qs = [], [], []
        for r, row in enumerate(s.rows):
            ins = self._row_inputs(batch, r, Bd)
            if plan is not None:  # (uids, w [2B, U], q) a device
                ins = {dev: (upload(uids, dev),
                             torch.cat([x[0][:, 0], x[0][:, 1]]), x[1])
                       for dev, x in ins.items()}
            qs.append({dev: x[-1] for dev, x in ins.items()})
            bm_r, cand_r = [], []
            for sid, sh in zip(s.shard_ids, row):
                x = ins[sh.device]
                if plan is not None:
                    bm = bm25_score_slots_udedup(sh, x[0], x[1], plan)
                elif self.use_pallas:
                    bm = bm25_score_slots(sh, x[0], x[1])
                else:
                    bm = ops.bm25_score_batch(
                        sh.indptr, sh.post_docs, sh.post_impact, x[0], x[1],
                        n_docs_pad=d_loc, posting_cap=s.posting_cap)
                lv, li = ops.topk_blockmax(bm[:, :d_loc], k_loc)
                bm_r.append(bm)
                cand_r.append((lv, li + sid * d_loc))
            bms.append(bm_r)
            cands.append(cand_r)

        # ---- the global candidate merge ----------------------------------
        merged = self._merge(coll, cands, self.k_ret)

        # ---- stage 2: candidate masks, dense stats, the pool extrema -----
        per_shard, ext_jobs = [], []
        for r, row in enumerate(s.rows):
            tv0, ti0 = merged[r]
            work, ext = [], []
            for sid, sh, bm in zip(s.shard_ids, row, bms[r]):
                tv, ti = tv0.to(sh.device), ti0.to(sh.device)
                local = ti - sid * d_loc
                in_shard = (local >= 0) & (local < d_loc) & (tv >= 0.0)
                n_loc = in_shard.sum(dim=1, keepdim=True)
                cand_mask, old_dense, old_norm, _ = (
                    ops.dense_candidates_from_topk(bm, tv, d_loc,
                                                   n_valid=n_loc))
                stats = ops.bucket_doc_stats(
                    s.buckets, sh.bucket_emb, qs[r][sh.device])
                lo, hi = ops.stats_pool_extrema(stats, cand_mask, s.buckets)
                ext.append(torch.stack([-lo, hi]))
                work.append((local, in_shard, cand_mask, old_dense, old_norm,
                             stats))
            per_shard.append(work)
            ext_jobs.append(ext)
        exts = coll.max(ext_jobs)  # one max carries both extrema

        # ---- fusion, then the per-candidate combine across shards --------
        comb_jobs = []
        for r, row in enumerate(s.rows):
            parts = []
            for sh, (local, in_shard, cand_mask, old_dense, _, stats) in zip(
                    row, per_shard[r]):
                e = exts[r].to(sh.device)
                doc_score, win = ops.fused_scores_from_stats(
                    s.buckets, sh.bucket_start, stats, cand_mask, old_dense,
                    (-e[0])[:, None], e[1][:, None], cfg.smoothing)
                at = torch.where(in_shard, local, 0).clamp(0, d_loc - 1).long()
                cs = torch.where(in_shard, doc_score.gather(1, at),
                                 float("-inf"))
                cw = torch.where(in_shard, win.gather(1, at), -1)
                parts.append(torch.stack([cs, cw.to(torch.float32)])
                             if self.fuse_win else (cs, cw))
            comb_jobs.append(parts)
        if self.fuse_win:
            combs = coll.max(comb_jobs)
            cand = [(c[0], c[1].to(torch.int32)) for c in combs]
        else:
            sc = coll.max([[p[0] for p in job] for job in comb_jobs])
            wn = coll.max([[p[1] for p in job] for job in comb_jobs])
            cand = list(zip(sc, wn))

        outs = []
        for r in range(len(s.rows)):
            tv, ti = merged[r]
            old_norm = per_shard[r][0][4]  # the same on every shard
            cand_scores, cand_win = cand[r]
            valid_c = tv >= 0.0
            sort_key = torch.where(valid_c, cand_scores, -1.0)
            final_vals, order = ops._sorted_topk(sort_key, tv.shape[1])
            order = order.long()
            outs.append((ti.gather(1, order), final_vals,
                         old_norm.gather(1, order),
                         cand_win.gather(1, order), valid_c.gather(1, order)))
        return self._finish(coll, outs, Bq)

    # -- one stage alone --

    def dense_topk(self, qvec, k: int):
        """Exact brute-force dense retrieval: per shard the per-doc max
        cosine over its buckets and a local top-k, one gather, the top-k.
        Returns (idx, vals, win), each [B, k]."""
        s = self.sidx
        k_loc = min(k, s.d_loc)
        if not isinstance(qvec, torch.Tensor):
            qvec = np.asarray(qvec, np.float32)
        B = qvec.shape[0]
        qvec = self._pad_dp(qvec, B)
        Bd = qvec.shape[0] // self.dp
        coll = Collectives(self.multiprocess)
        parts = []
        for r, row in enumerate(s.rows):
            ins = self._row_inputs((qvec,), r, Bd)
            row_parts = []
            for sid, sh in zip(s.shard_ids, row):
                doc_best, win = ops.bucket_dense_best(
                    s.buckets, sh.bucket_emb, sh.bucket_valid,
                    sh.bucket_start, ins[sh.device][0])
                lv, li = ops.topk_blockmax(doc_best, k_loc)
                row_parts.append((lv, li + sid * s.d_loc,
                                  win.gather(1, li.long())))
            parts.append(row_parts)
        outs = [(i, v, w) for v, i, w in self._merge(coll, parts, k,
                                                     levels=False)]
        return self._finish(coll, outs, B)

    def bm25_topk(self, term_ids, qtf, k: int):
        """BM25-only retrieval, always through the CSR scatter: per shard
        a local top-k, one gather, the top-k.  Returns (idx, vals)."""
        s = self.sidx
        k_loc = min(k, s.d_loc)
        term_ids = np.asarray(term_ids, np.int32)
        B = term_ids.shape[0]
        batch = (self._pad_dp(term_ids, B),
                 self._pad_dp(np.asarray(qtf, np.float32), B))
        Bd = batch[0].shape[0] // self.dp
        coll = Collectives(self.multiprocess)
        parts = []
        for r, row in enumerate(s.rows):
            ins = self._row_inputs(batch, r, Bd)
            row_parts = []
            for sid, sh in zip(s.shard_ids, row):
                x = ins[sh.device]
                bm = ops.bm25_score_batch(
                    sh.indptr, sh.post_docs, sh.post_impact, x[0], x[1],
                    n_docs_pad=s.d_loc, posting_cap=s.posting_cap)
                lv, li = ops.topk_blockmax(bm[:, : s.d_loc], k_loc)
                row_parts.append((lv, li + sid * s.d_loc))
            parts.append(row_parts)
        outs = [(i, v) for v, i in self._merge(coll, parts, k,
                                               levels=False)]
        return self._finish(coll, outs, B)


# ---- the query encoder over the mesh -----------------------------------------


class ShardedQueryEncoder:
    """A ``TorchEncoder``'s batch split over the mesh's devices (flattened
    in axis order; this process's only), padded to a multiple; each part
    runs on the replica of its device, is normalised there, and the parts
    are gathered in the original order on the first device.  A replica is
    made once a distinct device (the encoder's own model where the device
    is its own); a repeated device shares it."""

    def __init__(self, encoder, mesh: Mesh):
        self.enc = encoder
        devs = mesh.devices.reshape(-1)
        if mesh.owner is not None:
            devs = devs[mesh.owner.reshape(-1) == torch.distributed.get_rank()]
        self.devices = list(devs)
        self.replicas = {}
        for dev in self.devices:
            if dev not in self.replicas:
                self.replicas[dev] = replica(encoder, dev)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def encode_parts(self, texts):
        """Raw embeddings of each device's part, in order: [tensor, ...]."""
        n = len(self.devices)
        texts = list(texts) + [""] * ((-len(texts)) % n)
        per = len(texts) // n
        return [self.replicas[dev].encode_batch_device(
                    texts[i * per:(i + 1) * per])
                for i, dev in enumerate(self.devices)]

    def __call__(self, texts):
        """Unit-norm embeddings [len(texts), dim] f32 on the first device,
        with no host sync."""
        parts = []
        for e in self.encode_parts(texts):
            e = e.float()
            e = e / torch.clamp(torch.linalg.vector_norm(e, dim=1,
                                                         keepdim=True),
                                min=1e-12)
            parts.append(e.to(self.device))
        return torch.cat(parts)[: len(texts)]


def replica(encoder, device: torch.device):
    """``encoder`` (a ``TorchEncoder``) on ``device``: itself when it is
    there already, else a shallow copy whose model's weights are copied
    to ``device`` once, with graphs of its own (``GraphedForward``)."""
    if encoder.device == device:
        return encoder
    from modern_search_engines_project_tpu_torch.models.encoder import (
        BiEncoder,
        GraphedForward,
    )

    rep = copy.copy(encoder)
    rep.device = device
    rep.model = BiEncoder(encoder.cfg, device)
    rep.model.load_state_dict(encoder.model.state_dict())
    rep.model.eval()
    rep.graphed = GraphedForward(rep.model, device)
    return rep
