"""Fused per-document dense statistics over the bucket banks: kernel 4.

Counterpart of the reference package's ``retrieval/dense_pallas.py``.  The
TPU kernel ``_stats_kernel`` becomes the CUDA kernel in
``csrc/dense_stats.cu``; its plain PyTorch version is the einsum-then-
streaming-top-2 formulation of the reference ``ops.bucket_doc_stats``.

Per bucket ``[n, cnt, dim]`` (slot-major) and queries ``[B, dim]`` both
return ``(v1, v2, w1, w2, vmin)``, each ``[B, cnt]``: a document's two
largest raw chunk similarities with their slots, and its smallest.
"""

from __future__ import annotations

import torch

from modern_search_engines_project_tpu_torch.retrieval import cuda_lib

STATS_KERNEL = cuda_lib.register(
    cuda_lib.CudaKernel(
        "dense_stats",
        "mse_dense_stats",
        "modern_search_engines_project_tpu_torch/csrc/dense_stats.cu",
        "modern_search_engines_project_tpu/retrieval/dense_pallas.py:55",
    )
)
DIM_MULTIPLE = 32  # the kernel stages the dim axis in chunks of 32


def bucket_sims(emb: torch.Tensor, qvec: torch.Tensor) -> torch.Tensor:
    """[B, n, cnt] f32 similarities of the bank-dtype query and bank, as
    the reference computes them (inputs in the bank dtype, f32 sums)."""
    q = qvec.to(emb.dtype).to(torch.float32)
    return torch.einsum("bd,ncd->bnc", q, emb.to(torch.float32))


def stats_plain(emb: torch.Tensor, qvec: torch.Tensor):
    """Plain version of kernel 4: sims, then the streaming top-2 / min."""
    return slot_top2(bucket_sims(emb, qvec))


def slot_top2(sims: torch.Tensor):
    """Streaming top-2 and min over the slot axis of sims [B, n, cnt] ->
    (v1, v2, w1, w2, vmin), each [B, cnt].

    Strict ``>`` keeps the LOWEST slot on ties (a duplicate of the max
    lands in v2); v2 starts at -inf; single-chunk docs give
    (v1, v1, 0, 0, v1)."""
    n = sims.shape[1]
    v1 = sims[:, 0, :]
    w1 = torch.zeros_like(v1, dtype=torch.int32)
    if n == 1:
        return v1, v1, w1, w1, v1
    v2 = torch.full_like(v1, float("-inf"))
    w2 = torch.zeros_like(w1)
    vm = v1
    for s in range(1, n):
        x = sims[:, s, :]
        is1 = x > v1
        is2 = ~is1 & (x > v2)
        v2 = torch.where(is1, v1, torch.where(is2, x, v2))
        w2 = torch.where(is1, w1, torch.where(is2, s, w2))
        v1 = torch.where(is1, x, v1)
        w1 = torch.where(is1, s, w1)
        vm = torch.minimum(vm, x)
    return v1, v2, w1, w2, vm


def stats_max_abs_err(got, want, sims: torch.Tensor) -> float:
    """Largest disagreement between two stats tuples of one bucket.

    Values (v1, v2, vmin) are compared directly.  Slots may differ where
    two chunk sims lie within rounding of each other, so a slot counts by
    the value it points at: ``sims`` [B, n, cnt] (the reference sims) at
    the other tuple's slot must equal this tuple's value."""
    err = 0.0
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[4], want[4])):
        err = max(err, (a - b).abs().max().item())
    for slot, val in ((got[2], want[0]), (got[3], want[1])):
        at = sims.gather(1, slot.long()[:, None, :])[:, 0, :]
        err = max(err, (at - val).abs().max().item())
    return err


def bucket_stats(emb: torch.Tensor, qvec: torch.Tensor):
    """Kernel 4 for ONE bucket bank: (v1, v2, w1, w2, vmin), each [B, cnt].
    CPU tensors take the plain version; on the card the bank must be bf16
    with ``dim`` a multiple of 32."""
    if emb.device.type == "cpu":
        return stats_plain(emb, qvec)
    dev = emb.device
    cuda_lib.check(emb, "bank", torch.bfloat16, dev, 3)
    n, cnt, dim = emb.shape
    if n > 0xFFFF:
        raise ValueError(f"bank: {n} slots, the kernel packs a slot in 16 bits")
    if dim % DIM_MULTIPLE or emb.data_ptr() % 16:
        raise ValueError(
            f"bank: dim {dim} must be a multiple of {DIM_MULTIPLE} and the "
            "data 16-byte aligned"
        )
    q = qvec.to(torch.bfloat16).contiguous()
    cuda_lib.check(q, "queries", torch.bfloat16, dev, 2)
    if q.data_ptr() % 16:
        q = q.clone()  # the kernel copies query rows 16 bytes at a time
    if q.shape[1] != dim:
        raise ValueError(f"queries {tuple(q.shape)} vs bank {tuple(emb.shape)}")
    B = q.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    v1, v2, vm = (torch.empty(B, cnt, **f32) for _ in range(3))
    w1, w2 = (torch.empty(B, cnt, **i32) for _ in range(2))
    if B and cnt:
        STATS_KERNEL.launch(
            dev, q.data_ptr(), emb.data_ptr(), B, n, cnt, dim,
            v1.data_ptr(), v2.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            vm.data_ptr(),
        )
    return v1, v2, w1, w2, vm
