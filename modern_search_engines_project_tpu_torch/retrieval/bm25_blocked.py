"""BM25 over the doc-major blocked layout: kernels 7 and 8.

Counterpart of the blocked half of the reference package's
``retrieval/bm25_pallas.py`` (``bm25_score_blocked``,
``bm25_score_blocked_udedup``).  Two TPU kernels score the blocked
postings there; here each is a hand-written CUDA kernel
(``csrc/bm25_blocked.cu``) with a plain PyTorch version beside its wrapper:

  * ``bm25_score_blocked``        <- ``_kernel``: every query matched
    against its own T term ids;
  * ``bm25_score_blocked_udedup`` <- ``_kernel_udedup``: postings matched
    once against the batch's distinct term ids, per-query weights and
    presence read from the ``[2B, U]`` weight matrix (cast to bf16, as the
    TPU kernel casts it).

A wrapper takes the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises.

Keyed contract (as in the reference): ``[B, n_docs_pad + 1]`` f32 in the
layout's (permuted) doc order; a column holds the doc's score when some
query term matched it and the score is >= 0, else -1; the last column is
a -1 sentinel.  The kernels sum each doc's matched postings in f32 in
posting order (the TPU's compensated bf16x2 one-hot product approximates
that sum to ~2^-16 relative per posting), so blocked and slot scores agree
to float rounding.
"""

from __future__ import annotations

import torch

from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    table_args,
    uid_table_scratch,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    DOC_BLOCK,
    BlockedPostings,
)

BLOCKED_KERNEL = cuda_lib.register(
    cuda_lib.CudaKernel(
        "bm25_blocked",
        "mse_bm25_blocked",
        "modern_search_engines_project_tpu_torch/csrc/bm25_blocked.cu",
        "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:48",
    )
)
BLOCKED_UDEDUP_KERNEL = cuda_lib.register(
    cuda_lib.CudaKernel(
        "bm25_blocked_udedup",
        "mse_bm25_blocked_udedup",
        "modern_search_engines_project_tpu_torch/csrc/bm25_blocked.cu",
        "modern_search_engines_project_tpu/retrieval/bm25_pallas.py:104",
    )
)


# Kernel 7 keeps a query chunk's distinct-id table in shared memory up to
# this many term slots (32 queries x T); see csrc/bm25_blocked.cu.
SMEM_TABLE_IDS = 1024


def blocked_table_words(B: int, T: int) -> int:
    """int32 words of device-memory scratch kernel 7 needs for B queries
    of T term slots: 0 when each chunk's table fits shared memory, else
    one table per 32-query chunk (2^bits keys, 2^bits ids with
    2^bits >= 2 x term slots, and a [term slots, 32] f32 weight table),
    as ``mse_bm25_blocked`` checks."""
    n_ids = min(B, 32) * T
    if n_ids <= SMEM_TABLE_IDS:
        return 0
    bits = max(1, (2 * n_ids - 1).bit_length())
    return -(-B // 32) * (2 * (1 << bits) + n_ids * 32)


def blocked_udedup_gate(u_pad: int, B: int, T: int) -> bool:
    """Whether a batch takes the U-dedup kernel on the blocked layout: the
    reference engine's gate ``4 * u_pad <= B * T`` (fitted on a TPU v5e
    and kept so both packages dispatch alike).  ``bm25_udedup="always"``
    does not pin it, as in the reference."""
    return 4 * u_pad <= B * T


# ---- plain versions (the CPU path; the card's yardstick) -------------------


def _blocked_reduce(blk: BlockedPostings, B: int, width: int,
                    posting_weights):
    """Per-doc keyed reduction shared by both plain versions.

    ``posting_weights(rows)`` gives (m, present), each [B, R, p_blk], for a
    slice of rows: a posting's score is m * impact, and ``present`` says
    whether it counts as a match.  A slot's doc comes from the row's doc
    offsets, as in the kernels: doc j owns ``[doc_off[i, j],
    doc_off[i, j + 1])`` and the slots from ``doc_off[i, 128]`` on are pads,
    which add neither score nor presence.  Rows go ``step`` at a time so a
    [width, R, p_blk] temporary stays under 2^24 elements."""
    n_blocks, p_blk = blk.terms.shape
    dev = blk.terms.device
    s = torch.zeros(B, n_blocks * DOC_BLOCK, dtype=torch.float32, device=dev)
    c = torch.zeros_like(s)
    pos = torch.arange(p_blk, dtype=torch.int32, device=dev)
    step = max(1, (1 << 24) // max(width * p_blk, 1))
    for r0 in range(0, n_blocks, step):
        r1 = min(r0 + step, n_blocks)
        m, present = posting_weights(slice(r0, r1))
        loc = torch.searchsorted(
            blk.doc_off[r0:r1, 1:].contiguous(),
            pos.expand(r1 - r0, p_blk).contiguous(), right=True,
        )
        real = loc < DOC_BLOCK
        rows = torch.arange(r0, r1, device=dev)[:, None] * DOC_BLOCK
        doc = (loc.clamp(max=DOC_BLOCK - 1) + rows).reshape(-1)
        v = torch.where(real, m * blk.impact[r0:r1], 0.0)
        s.index_add_(1, doc, v.reshape(B, -1))
        c.index_add_(1, doc, (present & real).to(torch.float32).reshape(B, -1))
    keyed = torch.where((c > 0) & (s >= 0), s, -1.0)
    sentinel = torch.full((B, 1), -1.0, dtype=torch.float32, device=dev)
    return torch.cat([keyed, sentinel], dim=1)


def blocked_plain(blk: BlockedPostings, tids, qtf):
    """Plain version of kernel 7: keyed [B, n_docs_pad + 1].  Query pads
    -1 are remapped to -2 so they never meet the posting pads (-1); a
    posting counts as a match when its weight m > 0, as on the TPU."""
    tids = torch.where(tids < 0, -2, tids)
    B, T = tids.shape

    def weights(rows):
        t = blk.terms[None, rows]
        m = torch.zeros((B,) + t.shape[1:], dtype=torch.float32,
                        device=t.device)
        for j in range(T):
            m += torch.where(
                t == tids[:, j, None, None], qtf[:, j, None, None], 0.0
            )
        return m, m > 0

    return _blocked_reduce(blk, B, B, weights)


def blocked_udedup_plain(blk: BlockedPostings, uids, w):
    """Plain version of kernel 8: the TPU kernel's arithmetic — a 0/1
    match matrix against the U distinct ids, all of ``w`` cast to bf16,
    ``mw = w @ mu`` (in f32, exact for these small-integer weights) —
    then keyed: rows [0, B) of mw weigh the postings, and rows [B, 2B),
    the presence rows, say which count as matches (mw > 0)."""
    B = w.shape[0] // 2
    U = uids.shape[0]
    wb = w.to(torch.bfloat16).to(torch.float32)

    def weights(rows):
        t = blk.terms[rows]
        mu = (uids[:, None, None] == t[None]).to(torch.float32)
        mw = (wb @ mu.reshape(U, -1)).reshape((2 * B,) + t.shape)
        return mw[:B], mw[B:] > 0

    return _blocked_reduce(blk, B, max(2 * B, U), weights)


# ---- kernel wrappers --------------------------------------------------------


def _check_blocked(blk: BlockedPostings, dev) -> None:
    cuda_lib.check(blk.terms, "blk_terms", torch.int32, dev, 2)
    cuda_lib.check(blk.impact, "blk_impact", torch.float32, dev, 2)
    cuda_lib.check(blk.doc_off, "blk_doc_off", torch.int32, dev, 2)
    if blk.impact.shape != blk.terms.shape or blk.doc_off.shape != (
        blk.n_blocks, DOC_BLOCK + 1
    ):
        raise ValueError("blocked postings: inconsistent shapes")


def bm25_score_blocked(blk: BlockedPostings, term_ids, qtf) -> torch.Tensor:
    """Kernel 7: keyed BM25 scores [B, n_docs_pad + 1] (any T)."""
    if term_ids.device.type == "cpu":
        return blocked_plain(blk, term_ids, qtf)
    dev = term_ids.device
    _check_blocked(blk, dev)
    cuda_lib.check(term_ids, "tids", torch.int32, dev, 2)
    cuda_lib.check(qtf, "qtf", torch.float32, dev, 2)
    B, T = term_ids.shape
    if qtf.shape != term_ids.shape or T < 1:
        raise ValueError(f"tids/qtf {tuple(term_ids.shape)}/{tuple(qtf.shape)}")
    out = torch.empty(B, blk.n_docs_pad + 1, dtype=torch.float32, device=dev)
    if B:
        words = blocked_table_words(B, T)
        tables = (torch.empty(words, dtype=torch.int32, device=dev)
                  if words else None)
        BLOCKED_KERNEL.launch(
            dev,
            blk.terms.data_ptr(), blk.impact.data_ptr(),
            blk.doc_off.data_ptr(), blk.n_blocks, blk.p_blk,
            term_ids.data_ptr(), qtf.data_ptr(), B, T,
            out.data_ptr(), out.shape[1], *table_args(tables),
        )
    return out


def bm25_score_blocked_udedup(blk: BlockedPostings, uids, w) -> torch.Tensor:
    """Kernel 8: keyed BM25 scores [B, n_docs_pad + 1].  ``uids`` [U] int32
    holds distinct real ids (any order, any count) and pads -2, as
    ``dedup_query_terms`` makes it; ``w`` is [2B, U] f32 with
    small-integer weights in rows [0, B) and presence rows [B, 2B)."""
    if uids.device.type == "cpu":
        return blocked_udedup_plain(blk, uids, w)
    dev = uids.device
    _check_blocked(blk, dev)
    cuda_lib.check(uids, "uids", torch.int32, dev, 1)
    cuda_lib.check(w, "w", torch.float32, dev, 2)
    U = uids.shape[0]
    B = w.shape[0] // 2
    if w.shape != (2 * B, U) or U < 1:
        raise ValueError(f"uids/w {tuple(uids.shape)}/{tuple(w.shape)}")
    out = torch.empty(B, blk.n_docs_pad + 1, dtype=torch.float32, device=dev)
    if B:
        # the kernel's packed weights: one int32 per (u, query), the queries
        # rounded up to 32 (see pack_weights_kernel in csrc/bm25_blocked.cu)
        wpack = torch.empty(U * -(-B // 32) * 32, dtype=torch.int32,
                            device=dev)
        table = uid_table_scratch(U, dev)
        BLOCKED_UDEDUP_KERNEL.launch(
            dev,
            blk.terms.data_ptr(), blk.impact.data_ptr(),
            blk.doc_off.data_ptr(), blk.n_blocks, blk.p_blk,
            uids.data_ptr(), U, w.data_ptr(), B,
            out.data_ptr(), out.shape[1], wpack.data_ptr(), wpack.numel(),
            *table_args(table),
        )
    return out
