"""BM25 over the doc-slot layout: kernels 1-3 of the query path.

Counterpart of the slot half of the reference package's
``retrieval/bm25_pallas.py``.  Three TPU kernels score the slot postings
there; here each is a hand-written CUDA kernel (``csrc/bm25_slots.cu``)
with a plain PyTorch version beside its wrapper:

  * ``slots_keyed``          <- ``_kernel_slots``, every query matched
    against its own T term ids;
  * ``slots_udedup_keyed(variant="sublane" | "i8")`` <-
    ``_kernel_slots_udedup`` / ``_kernel_slots_udedup_i8``, postings matched
    once against the batch's distinct term ids, per-query weights recovered
    from the ``[2B, U]`` weight matrix.

A wrapper takes the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises.

Keyed contract (as in the reference): a column holds the doc's score when
the doc matched and the score is >= 0, else -1; ``_slots_key`` maps the
class-concatenated columns to dense doc order and appends a -1 sentinel
column.  All three are exact: integer weights, f32 sums.
"""

from __future__ import annotations

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    SLOT_COLS,
    SlotStream,
)

MAX_T = 64  # query term slots the plain kernel takes (csrc kMaxT)
MAX_U = 1024  # distinct batch terms the U-dedup kernels take (csrc kMaxU)

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
}


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
    """Plain version of kernels 2 ("sublane") and 3 ("i8"): the TPU
    kernels' arithmetic as written — a 0/1 match matrix against the U
    distinct ids, weights cast to bf16 or int8, ``mw = w[:B] @ mu`` —
    then keyed.  The product is taken in f32, which is exact for these
    small-integer weights (the int8 variant's s8 x s8 -> s32 product has
    the same value)."""
    if variant not in ("sublane", "i8"):
        raise ValueError(f"unknown U-dedup variant {variant!r}")
    B = w.shape[0] // 2
    U = uids.shape[0]
    cast = torch.bfloat16 if variant == "sublane" else torch.int8
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


# ---- kernel wrappers --------------------------------------------------------


def _check_stream(stream: SlotStream, dev) -> None:
    cuda_lib.check(stream.terms, "slot terms", torch.int32, dev, 1)
    cuda_lib.check(stream.impact, "slot impact", torch.float32, dev, 1)
    cuda_lib.check(stream.group_off, "group_off", torch.int64, dev, 1)
    cuda_lib.check(stream.group_rows, "group_rows", torch.int32, dev, 1)


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
    if qtf.shape != tids.shape or not 1 <= T <= MAX_T:
        raise ValueError(f"tids/qtf {tuple(tids.shape)}/{tuple(qtf.shape)}")
    out = torch.empty(B, stream.n_cols, dtype=torch.float32, device=dev)
    if B and stream.n_groups:
        SLOTS_KERNEL.launch(
            dev,
            stream.terms.data_ptr(), stream.impact.data_ptr(),
            stream.group_off.data_ptr(), stream.group_rows.data_ptr(),
            stream.n_groups, tids.data_ptr(), qtf.data_ptr(), B, T,
            out.data_ptr(), stream.n_cols,
        )
    return out


def slots_udedup_keyed(
    stream: SlotStream, slot_terms, slot_impact, uids, w, variant: str
):
    """Kernels 2 ("sublane") and 3 ("i8"): keyed scores [B, n_groups *
    COLS].  ``uids`` [U] int32 holds distinct real ids (any order) and
    pads -2, as ``dedup_query_terms`` makes it; ``w`` is [2B, U] f32 with
    small-integer weights in rows [0, B)."""
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
    if w.shape != (2 * B, U) or not 1 <= U <= MAX_U:
        raise ValueError(f"uids/w {tuple(uids.shape)}/{tuple(w.shape)}")
    out = torch.empty(B, stream.n_cols, dtype=torch.float32, device=dev)
    if B and stream.n_groups:
        UDEDUP_KERNELS[variant].launch(
            dev,
            stream.terms.data_ptr(), stream.impact.data_ptr(),
            stream.group_off.data_ptr(), stream.group_rows.data_ptr(),
            stream.n_groups, uids.data_ptr(), U, w.data_ptr(), B,
            out.data_ptr(), stream.n_cols,
        )
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


def bm25_score_slots_udedup(didx, uids, w, variant: str) -> torch.Tensor:
    """Keyed BM25 scores [B, n_docs_pad + 1] through kernel 2 or 3."""
    full = slots_udedup_keyed(
        didx.slot_stream, didx.slot_terms, didx.slot_impact, uids, w, variant
    )
    return _slots_key(full, didx.col_unperm, w.shape[0] // 2)
