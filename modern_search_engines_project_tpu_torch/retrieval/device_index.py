"""Device-resident hybrid index for the slot-layout query path, in torch.

Counterpart of the reference package's ``retrieval/device_index.py``,
restricted to what ``SearchEngine.search_batch`` drives in its default
configuration (``bm25_layout="slots"``): the doc-slot BM25 postings and the
slot-major bucketed chunk bank, both in the bucketed (permuted) doc order.
The numpy builders are copies of the reference's, so both packages build
bit-identical layouts from the same ``IndexArtifacts``.

Padding scheme (as in the reference):
  * docs -> permuted so docs with the same chunk count are contiguous; each
    bucket holds a 128-aligned number of doc slots; the doc axis is a
    multiple of 128.
  * slot postings -> column ``d % 512`` of group ``d // 512`` holds doc d's
    postings stacked vertically; groups are classed by row stride.

The slot classes are stored as views into ONE flat buffer (``SlotStream``)
so the CUDA slot kernels walk every group of every class in one launch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index.builder import IndexArtifacts


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sort_by_load(idxs: np.ndarray, load: np.ndarray) -> np.ndarray:
    """Order ``idxs`` by descending ``load`` (posting count)."""
    return idxs[np.argsort(-load[idxs], kind="stable")]


DOC_BLOCK = 128  # doc-axis alignment of the bucketed layout
SLOT_COLS = 512  # doc columns per slot-layout group


def build_slot_postings(
    indptr: np.ndarray,
    post_docs: np.ndarray,
    post_impact: np.ndarray,
    n_docs_pad: int,
    cols: int = SLOT_COLS,
    S_g: Optional[np.ndarray] = None,
):
    """Term-major CSR -> doc-slot layout for the slot kernels.

    Column ``d % cols`` of group ``d // cols`` holds doc d's postings stacked
    vertically, so the per-doc reduction is a straight sum over rows.
    Groups are classed by quantized row stride so each class is one
    rectangular ``[n_groups, stride, cols]`` array; docs arrive pre-sorted
    by posting count (the bucket permutation), keeping within-group stride
    spread — and therefore padding — small.

    Returns ``(slot_terms, slot_impact, col_unperm)``:
      * slot_terms / slot_impact — tuples of ``[n_g, S, cols]`` arrays
        (terms int32 pad -1, impact f32 pad 0), one per stride class.
      * col_unperm — int32 [n_docs_pad]: dense doc idx -> column in the
        class-concatenated kernel output.
    """
    V = indptr.shape[0] - 1
    nnz = post_docs.shape[0]
    n_slots = _round_up(max(n_docs_pad, cols), cols)
    n_groups = n_slots // cols

    term_of_post = np.repeat(np.arange(V, dtype=np.int32), np.diff(indptr))
    order = np.argsort(post_docs, kind="stable")
    d = post_docs[order].astype(np.int64)
    t = term_of_post[order]
    im = post_impact[order]
    counts = np.bincount(d, minlength=n_slots)
    starts = np.concatenate([[0], np.cumsum(counts)])
    row = np.arange(nnz, dtype=np.int64) - starts[d]

    # per-group stride: max posting count rounded to 8, then snapped to at
    # most 16 quantile levels (narrow count distributions get near-exact
    # strides).  A caller may pass shared ``S_g``.
    if S_g is None:
        gmax = np.maximum.reduceat(counts, np.arange(0, n_slots, cols))
        S_g = _stride_classes(gmax)

    classes = np.unique(S_g)
    class_of_group = np.searchsorted(classes, S_g)
    rank_in_class = np.zeros(n_groups, np.int64)
    group_pos = np.zeros(n_groups, np.int64)  # position in concat output
    slot_terms, slot_impact = [], []
    offset = 0
    for ci, S in enumerate(classes):
        gsel = np.nonzero(class_of_group == ci)[0]
        rank_in_class[gsel] = np.arange(len(gsel))
        group_pos[gsel] = offset + np.arange(len(gsel))
        offset += len(gsel)
        terms = np.full((len(gsel), int(S), cols), -1, np.int32)
        impact = np.zeros((len(gsel), int(S), cols), np.float32)
        slot_terms.append(terms)
        slot_impact.append(impact)

    # vectorized scatter of every posting into its class array
    g = d // cols
    col = d % cols
    ci_p = class_of_group[g]
    flat_idx = (rank_in_class[g] * classes[ci_p] + row) * cols + col
    for ci in range(len(classes)):
        sel = ci_p == ci
        if sel.any():
            slot_terms[ci].reshape(-1)[flat_idx[sel]] = t[sel]
            slot_impact[ci].reshape(-1)[flat_idx[sel]] = im[sel]

    dd = np.arange(n_docs_pad, dtype=np.int64)
    col_unperm = (group_pos[dd // cols] * cols + dd % cols).astype(np.int32)
    return tuple(slot_terms), tuple(slot_impact), col_unperm


def _round_up_arr(x: np.ndarray, m: int) -> np.ndarray:
    return ((x + m - 1) // m) * m


def _stride_classes(gmax: np.ndarray, max_classes: int = 16) -> np.ndarray:
    """Snap per-group max posting counts to <= max_classes stride levels.

    Levels are right-edge quantiles of the observed strides (always
    including the max): any multiple of 8 up to 512, multiples of 512
    beyond (the reference kernel's row-chunk rule, kept so both packages
    build the same layout)."""
    stride = np.maximum(_round_up_arr(gmax.astype(np.int64), 8), 8)

    def _snap(s: int) -> int:
        return int(s) if s <= 512 else int(_round_up_arr(np.int64(s), 512))

    snapped = np.array([_snap(s) for s in stride], np.int64)
    uniq = np.unique(snapped)
    if len(uniq) > max_classes:
        qi = np.ceil((np.arange(max_classes) + 1) * len(uniq) / max_classes)
        uniq = uniq[qi.astype(np.int64) - 1]
    return uniq[np.searchsorted(uniq, snapped)]


def build_index_fields(art: IndexArtifacts, config: Optional[Config] = None):
    """Host (numpy) construction of every array the slot path reads.

    Same arithmetic as the reference ``DeviceIndex.from_artifacts`` with
    ``bm25_layout="slots"``; returns the dict ``device_index_from_numpy``
    takes (bucket banks in f32)."""
    cfg = config or art.config
    n_docs = art.n_docs
    n_docs_pad = max(_round_up(n_docs, 128), 128)
    n_chunks = art.n_chunks
    n_chunks_pad = max(_round_up(n_chunks, 128), 128)
    if not n_chunks:
        raise NotImplementedError(
            "an index without chunk embeddings has no dense buckets; the "
            "reference serves it on the blocked BM25 layout, not ported yet"
        )

    # --- bucketed dense layout + doc permutation (may grow n_docs_pad) ----
    dnc = np.minimum(
        np.asarray(art.doc_n_chunks)[:n_docs], cfg.max_chunks_per_doc
    ).astype(np.int64)
    starts_all = np.asarray(art.doc_chunk_start)[:n_docs]
    dim = art.chunk_emb.shape[1]
    order = np.argsort(dnc, kind="stable")  # docs grouped by n
    distinct = sorted(set(int(x) for x in dnc)) or [1]
    post_load = np.bincount(
        np.asarray(art.post_docs), minlength=n_docs
    ).astype(np.int64)
    # within a chunk-count bucket, docs sorted by posting count: the slot
    # layout's padding is the within-group stride spread
    idxs_per = [
        _sort_by_load(order[dnc[order] == n], post_load) for n in distinct
    ]
    # 128-aligned bucket capacities; the rounding of the doc axis to a
    # DOC_BLOCK multiple goes to the smallest-stride bucket
    pads = [_round_up(max(len(ix), 8), 128) for ix in idxs_per]
    total = sum(pads)
    pads[0] += max(_round_up(total, DOC_BLOCK), DOC_BLOCK) - total
    buckets, bucket_emb, bucket_valid, bucket_start, perm_parts = (
        [], [], [], [], []
    )
    for n, idxs, cnt_pad in zip(distinct, idxs_per, pads):
        cnt = len(idxs)
        # SLOT-MAJOR bank [n, cnt_pad, dim]: slot s of every doc is a
        # contiguous (cnt_pad, dim) plane
        emb = np.zeros((n, cnt_pad, dim), np.float32)
        valid = np.zeros(cnt_pad, bool)
        bstart = np.zeros(cnt_pad, np.int32)
        if cnt:
            src = starts_all[idxs][None, :] + np.arange(n)[:, None]
            emb[:, :cnt] = art.chunk_emb[src]
            valid[:cnt] = True
            bstart[:cnt] = starts_all[idxs]
        buckets.append((int(n), int(cnt_pad)))
        bucket_emb.append(emb)
        bucket_valid.append(valid)
        bucket_start.append(bstart)
        pp = np.full(cnt_pad, -1, np.int64)
        pp[:cnt] = idxs
        perm_parts.append(pp)
    doc_perm = np.concatenate(perm_parts)
    n_docs_pad = max(int(doc_perm.shape[0]), n_docs_pad)
    inv = np.zeros(n_docs, np.int32)
    real = doc_perm >= 0
    inv[doc_perm[real]] = np.nonzero(real)[0].astype(np.int32)

    slot_terms, slot_impact, col_unperm = build_slot_postings(
        np.asarray(art.indptr),
        inv[np.asarray(art.post_docs)],
        np.asarray(art.post_impact),
        n_docs_pad,
    )
    return {
        "slot_terms": slot_terms,
        "slot_impact": slot_impact,
        "col_unperm": col_unperm,
        "buckets": tuple(buckets),
        "bucket_emb": tuple(bucket_emb),
        "bucket_valid": tuple(bucket_valid),
        "bucket_start": tuple(bucket_start),
        "doc_perm": doc_perm,
        "n_docs": n_docs,
        "n_docs_pad": n_docs_pad,
        "n_chunks_pad": n_chunks_pad,
        "n_terms": art.n_terms,
        "nnz": int(art.post_docs.shape[0]),
    }


@dataclasses.dataclass
class SlotStream:
    """Every stride class of the slot postings as one flat stream.

    Group ``g`` (class-concatenated order, i.e. the kernel's output column
    block ``g``) occupies ``rows[g] * SLOT_COLS`` elements of ``terms`` /
    ``impact`` starting at ``group_off[g]``, row-major ``[rows, SLOT_COLS]``.
    """

    terms: torch.Tensor  # int32 [total], pad -1
    impact: torch.Tensor  # float32 [total], pad 0
    group_off: torch.Tensor  # int64 [n_groups]
    group_rows: torch.Tensor  # int32 [n_groups]

    @property
    def n_groups(self) -> int:
        return int(self.group_off.shape[0])

    @property
    def n_cols(self) -> int:
        return self.n_groups * SLOT_COLS


def pack_slot_classes(slot_terms, slot_impact, device):
    """Per-class numpy arrays -> (per-class tensor views, SlotStream).

    One device buffer per operand; the per-class ``[n_g, S, cols]`` tensors
    the plain versions read are views into it, so nothing is stored twice.
    """
    sizes = [int(t.size) for t in slot_terms]
    terms = torch.from_numpy(
        np.concatenate([np.ravel(t) for t in slot_terms])
    ).to(device)
    impact = torch.from_numpy(
        np.concatenate([np.ravel(t) for t in slot_impact])
    ).to(device)
    views_t, views_i, offs, rows = [], [], [], []
    off = 0
    for t, size in zip(slot_terms, sizes):
        n_g, S, cols = t.shape
        views_t.append(terms[off : off + size].view(n_g, S, cols))
        views_i.append(impact[off : off + size].view(n_g, S, cols))
        offs.extend(off + g * S * cols for g in range(n_g))
        rows.extend([S] * n_g)
        off += size
    stream = SlotStream(
        terms=terms,
        impact=impact,
        group_off=torch.tensor(offs, dtype=torch.int64, device=device),
        group_rows=torch.tensor(rows, dtype=torch.int32, device=device),
    )
    return tuple(views_t), tuple(views_i), stream


@dataclasses.dataclass
class DeviceIndex:
    # BM25, doc-slot layout (stride classes; see build_slot_postings)
    slot_terms: tuple  # per class: int32 [n_g, S, SLOT_COLS] (views)
    slot_impact: tuple  # per class: float32 [n_g, S, SLOT_COLS] (views)
    slot_stream: SlotStream  # the same postings as one flat stream
    col_unperm: torch.Tensor  # int32 [n_docs_pad]
    # dense, bucketed exact-stride layout (docs permuted by chunk count)
    buckets: tuple  # ((n, cnt_pad), ...)
    bucket_emb: tuple  # per bucket: bank dtype [n, cnt_pad, dim] slot-major
    bucket_valid: tuple  # per bucket: bool [cnt_pad] (real doc?)
    bucket_start: tuple  # per bucket: int32 [cnt_pad] packed chunk start
    doc_perm: np.ndarray  # host: new doc idx -> artifact doc idx (-1 pad)
    n_docs: int
    n_docs_pad: int
    n_chunks_pad: int
    n_terms: int
    nnz: int
    device: torch.device

    @classmethod
    def from_artifacts(
        cls,
        art: IndexArtifacts,
        config: Optional[Config] = None,
        bank_dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "DeviceIndex":
        """Build the slot-path index on ``device`` (the card by default).
        The bank is bf16 on the card and f32 on the CPU unless
        ``bank_dtype`` says otherwise."""
        dev = resolve_device(device)
        return device_index_from_numpy(
            build_index_fields(art, config), dev, bank_dtype
        )

    def resident_bytes(self) -> int:
        """Bytes of every tensor this index holds on its device."""
        ts = [
            self.slot_stream.terms,
            self.slot_stream.impact,
            self.slot_stream.group_off,
            self.slot_stream.group_rows,
            self.col_unperm,
            *self.bucket_emb,
            *self.bucket_valid,
            *self.bucket_start,
        ]
        return sum(t.numel() * t.element_size() for t in ts)


def device_index_from_numpy(
    fields: dict, device=None, bank_dtype: Optional[torch.dtype] = None
) -> DeviceIndex:
    """Index state carried across: numpy arrays -> the port's DeviceIndex.

    ``fields`` holds the slot-path arrays by their ``DeviceIndex`` field
    names (``build_index_fields`` output, or the reference index's arrays
    converted to numpy), so both packages can serve bit-identical layouts.
    """
    dev = resolve_device(device)
    if bank_dtype is None:
        bank_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    slot_terms, slot_impact, stream = pack_slot_classes(
        [np.asarray(t, np.int32) for t in fields["slot_terms"]],
        [np.asarray(t, np.float32) for t in fields["slot_impact"]],
        dev,
    )

    def put(x, dtype):
        # a writable C-ordered array (copied only when it is not one)
        x = np.require(x, requirements=["C", "W"])
        return torch.from_numpy(x).to(dev, dtype)

    return DeviceIndex(
        slot_terms=slot_terms,
        slot_impact=slot_impact,
        slot_stream=stream,
        col_unperm=put(fields["col_unperm"], torch.int32),
        buckets=tuple((int(n), int(c)) for n, c in fields["buckets"]),
        bucket_emb=tuple(
            put(np.asarray(e, np.float32), bank_dtype)
            for e in fields["bucket_emb"]
        ),
        bucket_valid=tuple(put(v, torch.bool) for v in fields["bucket_valid"]),
        bucket_start=tuple(
            put(s, torch.int32) for s in fields["bucket_start"]
        ),
        doc_perm=np.asarray(fields["doc_perm"], np.int64),
        n_docs=int(fields["n_docs"]),
        n_docs_pad=int(fields["n_docs_pad"]),
        n_chunks_pad=int(fields["n_chunks_pad"]),
        n_terms=int(fields["n_terms"]),
        nnz=int(fields["nnz"]),
        device=dev,
    )
