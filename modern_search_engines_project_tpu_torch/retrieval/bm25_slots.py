"""BM25 over the doc-slot layout: TPU kernels 1, 2, 3, 5 and 6.

Counterpart of the slot half of the reference package's
``retrieval/bm25_pallas.py``.  Five TPU kernels score the slot postings
there; here each is a hand-written CUDA kernel with a plain PyTorch
version beside its wrapper:

  * ``slots_keyed``          <- ``_kernel_slots``, every query matched
    against its own T term ids (``csrc/bm25_slots.cu``);
  * ``slots_udedup_keyed(variant=...)``: postings matched once against the
    batch's distinct term ids, per-query weights recovered from the
    ``[2B, U]`` weight matrix:
      - "sublane", "i8" <- ``_kernel_slots_udedup`` /
        ``_kernel_slots_udedup_i8``: a lookup of the matched id
        (``csrc/bm25_slots.cu``);
      - "wide", "wide_i8" <- ``_kernel_slots_udedup_wide``: the weights as
        a bf16 or int8 product on the tensor cores of ``w[:B]`` with the
        one-hot ids of each stage's matched postings, folded in row order
        (``csrc/bm25_slots.cu``);
      - "acc" <- ``_kernel_slots_udedup_acc``: impacts and presence
        gathered per distinct id, then ``w[:B] @ X`` (X split three ways
        into bf16) and ``w[B:2B] @ P`` on the tensor cores
        (``csrc/bm25_slots.cu``).

Kernels 2-3 and 5-6 share the streaming front of kernel 1.

A wrapper takes the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises.

Keyed contract (as in the reference): a column holds the doc's score when
the doc matched and the score is >= 0, else -1; ``_slots_key`` maps the
class-concatenated columns to dense doc order and appends a -1 sentinel
column.  All are exact (integer weights, f32 or s32 sums) except "acc",
whose split product sums in another order (an ulp or two).  "acc" alone
reads the presence rows ``w[B:2B]``; the others derive presence from the
weight.
"""

from __future__ import annotations

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    SLOT_COLS,
    SlotStream,
)

SMEM_MAX_U = 1024  # distinct ids the U-dedup kernels keep in shared memory
# (csrc/uid_table.cuh kSmemMaxU); above it they need a device-memory table
SMEM_MAX_T = 64  # term slots a query kernel 1 keeps in shared memory
# (csrc/bm25_slots.cu kMaxT); above it, device-memory query tables
PLAIN_CHUNK = 16  # queries a block of kernel 1 (csrc/bm25_slots.cu)

SLOTS_KERNEL = cuda_lib.register(
    cuda_lib.CudaKernel(
        "bm25_slots",
        "mse_bm25_slots",
        "modern_search_engines_project_tpu_torch/csrc/bm25_slots.cu",
        "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:190",
    )
)
UDEDUP_KERNELS = {
    "sublane": cuda_lib.register(
        cuda_lib.CudaKernel(
            "bm25_slots_udedup_sublane",
            "mse_bm25_slots_udedup_bf16",
            "modern_search_engines_project_tpu_torch/csrc/bm25_slots.cu",
            "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:241",
        )
    ),
    "i8": cuda_lib.register(
        cuda_lib.CudaKernel(
            "bm25_slots_udedup_i8",
            "mse_bm25_slots_udedup_i8",
            "modern_search_engines_project_tpu_torch/csrc/bm25_slots.cu",
            "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:289",
        )
    ),
    "acc": cuda_lib.register(
        cuda_lib.CudaKernel(
            "bm25_slots_udedup_acc",
            "mse_bm25_slots_udedup_acc",
            "modern_search_engines_project_tpu_torch/csrc/bm25_slots.cu",
            "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:380",
        )
    ),
    "wide": cuda_lib.register(
        cuda_lib.CudaKernel(
            "bm25_slots_udedup_wide",
            "mse_bm25_slots_udedup_wide_bf16",
            "modern_search_engines_project_tpu_torch/csrc/bm25_slots.cu",
            "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:327",
        )
    ),
    "wide_i8": cuda_lib.register(
        cuda_lib.CudaKernel(
            "bm25_slots_udedup_wide_i8",
            "mse_bm25_slots_udedup_wide_i8",
            "modern_search_engines_project_tpu_torch/csrc/bm25_slots.cu",
            "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:327",
        )
    ),
}
# the tensor-core variants: the weight operands their A fragments hold
# (wq, and wp for "acc") and the ids of one k block (16 bf16, 32 int8)
_MMA_OPERANDS = {"acc": (2, 16), "wide": (1, 16), "wide_i8": (1, 32)}


# ---- host-side dispatch and query prep -------------------------------------


def udedup_plan(u_pad: int, B: int):
    """Which slot kernel serves a batch: None (plain per-query kernel),
    "sublane" or "i8".

    These boundaries were fitted on a TPU v5e (the reference package's
    gate fit) and are kept unchanged so both packages dispatch alike;
    refitting them on the H100 is open work.
      * B >= 32: "sublane" at U <= 128, "i8" up to U = 1024;
      * 8 <= B < 32: "sublane" up to U = 512;
      * otherwise None."""
    if B >= 32 and u_pad <= 1024:
        return "sublane" if u_pad <= 128 else "i8"
    if B >= 8 and u_pad <= 512:
        return "sublane"
    return None


def u_pad_for(n_distinct: int, u_buckets=(128, 256, 512, 1024)) -> int:
    """Smallest U bucket holding ``n_distinct`` terms."""
    for u in u_buckets:
        if n_distinct <= u:
            return u
    return int(-(-n_distinct // 128) * 128)


def dedup_query_terms(term_ids, qtf):
    """Distinct batch term ids and the per-query weight/presence matrix.

    Returns (uids [U_pad] int32: the distinct ids ascending, then pad -2;
    w [2B, U_pad] f32: rows [0, B) qtf weights, rows [B, 2B) presence 0/1),
    with U_pad from ``u_pad_for``."""
    tids = np.asarray(term_ids)
    qw = np.asarray(qtf, np.float32)
    B, T = tids.shape
    valid = tids >= 0
    uniq = np.unique(tids[valid])
    U_pad = u_pad_for(uniq.size)
    uids = np.full(U_pad, -2, np.int32)
    uids[: uniq.size] = uniq
    w = np.zeros((2 * B, U_pad), np.float32)
    if uniq.size:
        rows, slots = np.nonzero(valid)
        cols = np.searchsorted(uniq, tids[rows, slots])
        np.add.at(w, (rows, cols), qw[rows, slots])
        w[B + rows, cols] = 1.0
    return uids, w


def dedup_query_terms_device(term_ids: torch.Tensor, qtf: torch.Tensor,
                             u_pad: int):
    """The device twin of ``dedup_query_terms`` under a fixed distinct-term
    budget ``u_pad`` (the reference's ``dedup_query_terms_device``):
    static shapes and no host sync, so a batch goes from its term ids to
    the U-dedup kernels without a round trip.

    ``term_ids`` [B, T] (ids below 0 are padding), ``qtf`` [B, T] f32 on
    one device.  Returns (uids [u_pad] int32: the ``u_pad`` smallest
    distinct ids ascending, then pad -2; w [2B, u_pad] f32: rows [0, B)
    each query's qtf summed per distinct id, rows [B, 2B) presence 0/1).
    A term whose id falls outside the ``u_pad`` kept, and every pad, goes
    to a discarded column, so distinct ids beyond ``u_pad`` are dropped
    silently: callers size ``u_pad`` from the host's distinct count, as
    the reference's callers do.

    Plain torch, as the reference's is XLA outside any Pallas kernel: a
    sort, a first-occurrence mask, a cumulative sum for the rank, a
    scatter into ``u_pad + 1`` slots and ``torch.searchsorted``."""
    B, T = term_ids.shape
    dev = term_ids.device
    tids = term_ids.to(torch.int64)
    sent = torch.iinfo(torch.int32).max
    flat = torch.where(tids < 0, sent, tids).reshape(-1)
    srt = torch.sort(flat).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    first &= srt != sent
    rank = torch.cumsum(first, 0) - 1
    slot = torch.where(first & (rank < u_pad), rank, u_pad)
    uniq = torch.full((u_pad + 1,), sent, dtype=torch.int64, device=dev)
    uniq = uniq.scatter(0, slot, srt)[:u_pad]  # slot u_pad: discarded
    uids = torch.where(uniq == sent, -2, uniq).to(torch.int32)
    valid = tids >= 0
    pos = torch.searchsorted(uniq, tids.clamp(min=0))
    cols = torch.where(valid, pos, u_pad)
    rows = torch.arange(B, device=dev)[:, None]
    w = torch.zeros(2 * B * (u_pad + 1), dtype=torch.float32, device=dev)
    w.scatter_add_(0, (rows * (u_pad + 1) + cols).reshape(-1),
                   torch.where(valid, qtf.float(), 0.0).reshape(-1))
    w.scatter_reduce_(0, ((B + rows) * (u_pad + 1) + cols).reshape(-1),
                      valid.float().reshape(-1), "amax")
    return uids, w.reshape(2 * B, u_pad + 1)[:, :u_pad].contiguous()


# ---- plain versions (the CPU path; the card's yardstick) -------------------


def _keyed(score: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.where((count > 0) & (score >= 0), score, -1.0)


def _row_chunks(S: int, cols: int, width: int, budget: int = 1 << 25):
    """Row ranges of one stride class so a [width, n_g, rows, cols]
    temporary stays under ``budget`` elements."""
    step = max(1, budget // max(width * cols, 1))
    return [(r, min(r + step, S)) for r in range(0, S, step)]


def slots_plain(slot_terms, slot_impact, tids, qtf) -> torch.Tensor:
    """Plain version of kernel 1: keyed [B, sum n_g * COLS]."""
    tids = torch.where(tids < 0, -2, tids)  # pad -1 -> -2
    B, T = tids.shape
    parts = []
    for terms, impact in zip(slot_terms, slot_impact):
        n_g, S, cols = terms.shape
        s = torch.zeros(B, n_g, cols, dtype=torch.float32, device=terms.device)
        c = torch.zeros_like(s)
        for r0, r1 in _row_chunks(S, n_g * cols, B):
            tr = terms[None, :, r0:r1, :]
            m = torch.zeros(
                (B, n_g, r1 - r0, cols), dtype=torch.float32,
                device=terms.device,
            )
            for t in range(T):
                hit = tr == tids[:, t, None, None, None]
                m += torch.where(hit, qtf[:, t, None, None, None], 0.0)
            s += (m * impact[None, :, r0:r1, :]).sum(2)
            c += (m > 0).float().sum(2)
        parts.append(_keyed(s, c).reshape(B, n_g * cols))
    return torch.cat(parts, dim=1)


def slots_udedup_plain(slot_terms, slot_impact, uids, w, variant: str):
    """Plain version of the U-dedup kernels 2 ("sublane"), 3 ("i8"), 6
    ("wide", "wide_i8") and 5 ("acc", ``_acc_plain``): the TPU kernels'
    arithmetic as written — a 0/1 match matrix against the U distinct ids,
    weights cast to bf16 or int8, ``mw = w[:B] @ mu`` — then keyed.  The
    product is taken in f32, which is exact for these small-integer
    weights (the int8 variants' s8 x s8 -> s32 product has the same
    value).  "wide" fuses the TPU's per-sublane products into one, which
    changes no value, so it shares the arithmetic of "sublane" (and
    "wide_i8" that of "i8")."""
    if variant == "acc":
        return _acc_plain(slot_terms, slot_impact, uids, w)
    if variant not in ("sublane", "i8", "wide", "wide_i8"):
        raise ValueError(f"unknown U-dedup variant {variant!r}")
    B = w.shape[0] // 2
    U = uids.shape[0]
    cast = torch.bfloat16 if variant in ("sublane", "wide") else torch.int8
    wq = w[:B].to(cast).to(torch.float32)  # [B, U]
    parts = []
    for terms, impact in zip(slot_terms, slot_impact):
        n_g, S, cols = terms.shape
        s = torch.zeros(B, n_g, cols, dtype=torch.float32, device=terms.device)
        c = torch.zeros_like(s)
        for r0, r1 in _row_chunks(S, n_g * cols, max(U, B)):
            tr = terms[None, :, r0:r1, :]
            mu = (uids[:, None, None, None] == tr).to(torch.float32)
            mw = (wq @ mu.reshape(U, -1)).reshape(B, n_g, r1 - r0, cols)
            s += (mw * impact[None, :, r0:r1, :]).sum(2)
            c += (mw > 0).float().sum(2)
        parts.append(_keyed(s, c).reshape(B, n_g * cols))
    return torch.cat(parts, dim=1)


def _split3(x: torch.Tensor):
    """The TPU kernel's 3-way bf16 split of f32 ``x``
    (``bm25_pallas.py:434-437``), each part back in f32."""
    x1 = x.to(torch.bfloat16)
    r1 = x - x1.float()
    x2 = r1.to(torch.bfloat16)
    x3 = (r1 - x2.float()).to(torch.bfloat16)
    return x1.float(), x2.float(), x3.float()


def _acc_plain(slot_terms, slot_impact, uids, w):
    """Plain version of kernel 5 ("acc"): per class, X[u, col] = the summed
    impact of distinct id u in doc column col and P[u, col] its match
    count, over all rows; then ``S = wq@x1 + wq@x2 + wq@x3`` (X split three
    ways into bf16) and ``C = wp@P`` with ``wq = bf16(w[:B])`` and
    ``wp = bf16(w[B:2B])``, the presence rows; keyed on (C, S)."""
    B = w.shape[0] // 2
    U = uids.shape[0]
    wq = w[:B].to(torch.bfloat16).float()
    wp = w[B:].to(torch.bfloat16).float()
    parts = []
    for terms, impact in zip(slot_terms, slot_impact):
        n_g, S, cols = terms.shape
        X = torch.zeros(U, n_g, cols, dtype=torch.float32, device=terms.device)
        P = torch.zeros_like(X)
        for r0, r1 in _row_chunks(S, n_g * cols, U):
            mu = uids[:, None, None, None] == terms[None, :, r0:r1, :]
            X += torch.where(mu, impact[None, :, r0:r1, :], 0.0).sum(2)
            P += mu.float().sum(2)
        x1, x2, x3 = _split3(X.reshape(U, -1))
        s = wq @ x1 + wq @ x2 + wq @ x3
        c = wp @ P.reshape(U, -1).to(torch.bfloat16).float()
        parts.append(_keyed(s, c).reshape(B, n_g * cols))
    return torch.cat(parts, dim=1)


# ---- kernel wrappers --------------------------------------------------------


def uid_table_scratch(U: int, device):
    """Device-memory hash table the U-dedup kernels (2, 3 and 8) fill and
    probe when U exceeds SMEM_MAX_U: int32 [2 * 2^bits] with 2^bits >= 2U
    (csrc/uid_table.cuh ``global_bits``); None below that.  The wrapper may
    drop it right after the launch: PyTorch's caching allocator hands the
    memory only to work queued later on the same stream."""
    if U <= SMEM_MAX_U:
        return None
    bits = 11
    while (1 << bits) < 2 * U:
        bits += 1
    return torch.empty(2 << bits, dtype=torch.int32, device=device)


def slots_table_words(B: int, T: int) -> int:
    """int32 words of device-memory scratch kernel 1 needs for B queries of
    T term slots: 0 up to SMEM_MAX_T (its tables live in shared memory),
    else one query table per 16-query chunk (2^bits keys, 2^bits ids with
    2^bits >= 2 x term slots, and a [term slots, 16] f32 weight table;
    csrc/uid_table.cuh ``query_table_words``), as ``mse_bm25_slots``
    checks."""
    if T <= SMEM_MAX_T:
        return 0
    n_ids = min(B, PLAIN_CHUNK) * T
    bits = max(1, (2 * n_ids - 1).bit_length())
    return -(-B // PLAIN_CHUNK) * (2 * (1 << bits) + n_ids * PLAIN_CHUNK)


def table_args(table):
    """(pointer, length) launcher arguments for ``uid_table_scratch``."""
    return (0, 0) if table is None else (table.data_ptr(), table.numel())


def weight_scratch_bytes(variant: str, B: int, U: int) -> int:
    """Bytes of the A fragments a tensor-core U-dedup kernel packs
    (csrc/bm25_slots.cu ``pack_afrag_kernel``): 512 for each m16 tile of
    the queries and k block of the ids (16 ids in bf16, 32 in int8), of
    bf16 ``w[:B]`` ("wide"), int8 ``w[:B]`` ("wide_i8"), or bf16 ``w[:B]``
    and ``w[B:2B]`` ("acc"); 0 for the lookup kernels."""
    if variant not in _MMA_OPERANDS:
        return 0
    ops, k = _MMA_OPERANDS[variant]
    return ops * 512 * -(-B // 16) * -(-U // k)


def _check_stream(stream: SlotStream, dev) -> None:
    cuda_lib.check(stream.terms, "slot terms", torch.int32, dev, 1)
    cuda_lib.check(stream.impact, "slot impact", torch.float32, dev, 1)
    cuda_lib.check(stream.group_off, "group_off", torch.int64, dev, 1)
    cuda_lib.check(stream.group_rows, "group_rows", torch.int32, dev, 1)
    cuda_lib.check(stream.group_order, "group_order", torch.int32, dev, 1)


def _stream_args(stream: SlotStream):
    """(group_order pointer, slot count) launcher arguments of kernels 1-3
    and 5-6, which stream the term ids in the deepest-first group order."""
    return stream.group_order.data_ptr(), stream.terms.numel()


def slots_keyed(stream: SlotStream, slot_terms, slot_impact, tids, qtf):
    """Kernel 1: keyed scores [B, n_groups * COLS] in class-concatenated
    column order.  ``slot_terms``/``slot_impact`` are the per-class views
    of ``stream`` (what the plain version reads)."""
    if tids.device.type == "cpu":
        return slots_plain(slot_terms, slot_impact, tids, qtf)
    dev = tids.device
    _check_stream(stream, dev)
    cuda_lib.check(tids, "tids", torch.int32, dev, 2)
    cuda_lib.check(qtf, "qtf", torch.float32, dev, 2)
    B, T = tids.shape
    if qtf.shape != tids.shape or T < 1:
        raise ValueError(f"tids/qtf {tuple(tids.shape)}/{tuple(qtf.shape)}")
    out = torch.empty(B, stream.n_cols, dtype=torch.float32, device=dev)
    if B and stream.n_groups:
        words = slots_table_words(B, T)
        tables = (torch.empty(words, dtype=torch.int32, device=dev)
                  if words else None)
        SLOTS_KERNEL.launch(
            dev,
            stream.terms.data_ptr(), stream.impact.data_ptr(),
            stream.group_off.data_ptr(), stream.group_rows.data_ptr(),
            stream.n_groups, tids.data_ptr(), qtf.data_ptr(), B, T,
            out.data_ptr(), stream.n_cols, *_stream_args(stream),
            *table_args(tables),
        )
    return out


def slots_udedup_keyed(
    stream: SlotStream, slot_terms, slot_impact, uids, w, variant: str
):
    """The U-dedup kernels ("sublane", "i8", "wide", "wide_i8", "acc"):
    keyed scores [B, n_groups * COLS].  ``uids`` [U] int32 holds distinct
    real ids (any order, any count) and pads -2, as ``dedup_query_terms``
    makes it; ``w`` is [2B, U] f32 with small-integer weights in rows
    [0, B) and presence in rows [B, 2B)."""
    if uids.device.type == "cpu":
        return slots_udedup_plain(slot_terms, slot_impact, uids, w, variant)
    if variant not in UDEDUP_KERNELS:
        raise ValueError(f"unknown U-dedup variant {variant!r}")
    dev = uids.device
    _check_stream(stream, dev)
    cuda_lib.check(uids, "uids", torch.int32, dev, 1)
    cuda_lib.check(w, "w", torch.float32, dev, 2)
    U = uids.shape[0]
    B = w.shape[0] // 2
    if w.shape != (2 * B, U) or U < 1:
        raise ValueError(f"uids/w {tuple(uids.shape)}/{tuple(w.shape)}")
    out = torch.empty(B, stream.n_cols, dtype=torch.float32, device=dev)
    if B and stream.n_groups:
        table = uid_table_scratch(U, dev)
        args = [
            stream.terms.data_ptr(), stream.impact.data_ptr(),
            stream.group_off.data_ptr(), stream.group_rows.data_ptr(),
            stream.n_groups, uids.data_ptr(), U, w.data_ptr(), B,
            out.data_ptr(), stream.n_cols,
        ]
        if variant in _MMA_OPERANDS:  # kernels 5-6
            n = weight_scratch_bytes(variant, B, U)
            scratch = torch.empty(n, dtype=torch.uint8, device=dev)
            args += [*table_args(table), *_stream_args(stream),
                     scratch.data_ptr(), n]
        else:  # kernels 2-3
            args += [*_stream_args(stream), *table_args(table)]
        UDEDUP_KERNELS[variant].launch(dev, *args)
    return out


# ---- keyed scores in dense doc order ----------------------------------------


def _slots_key(keyed: torch.Tensor, col_unperm: torch.Tensor, B: int):
    """Kernel-keyed scores (slot column order) -> dense doc order, plus the
    -1 sentinel column: [B, n_docs_pad + 1].

    The slot layout only reorders WHOLE groups (within a group the 512 doc
    columns stay consecutive), so the un-permutation is a gather along the
    group axis."""
    n_dense = col_unperm.shape[0]
    if keyed.shape[1] % SLOT_COLS == 0 and n_dense >= SLOT_COLS:
        n_groups_dense = -(-n_dense // SLOT_COLS)
        group_perm = (col_unperm[::SLOT_COLS] // SLOT_COLS).long()
        k3 = keyed.reshape(B, keyed.shape[1] // SLOT_COLS, SLOT_COLS)
        keyed = k3.index_select(1, group_perm).reshape(
            B, n_groups_dense * SLOT_COLS
        )[:, :n_dense]
    else:  # tiny corpora (< one group): plain elementwise gather
        keyed = keyed.index_select(1, col_unperm.long())
    sentinel = torch.full((B, 1), -1.0, dtype=keyed.dtype, device=keyed.device)
    return torch.cat([keyed, sentinel], dim=1)


def bm25_score_slots(didx, term_ids, qtf) -> torch.Tensor:
    """Keyed BM25 scores [B, n_docs_pad + 1] through kernel 1."""
    full = slots_keyed(
        didx.slot_stream, didx.slot_terms, didx.slot_impact, term_ids, qtf
    )
    return _slots_key(full, didx.col_unperm, term_ids.shape[0])


def bm25_score_slots_udedup(
    didx, uids, w, variant: str = None, *, acc: bool = True
) -> torch.Tensor:
    """Keyed BM25 scores [B, n_docs_pad + 1] through a U-dedup kernel.
    ``variant`` names it; when None, the legacy ``acc`` flag picks "acc"
    (True, the reference's default) or "sublane" (False)."""
    if variant is None:
        variant = "acc" if acc else "sublane"
    full = slots_udedup_keyed(
        didx.slot_stream, didx.slot_terms, didx.slot_impact, uids, w, variant
    )
    return _slots_key(full, didx.col_unperm, w.shape[0] // 2)
