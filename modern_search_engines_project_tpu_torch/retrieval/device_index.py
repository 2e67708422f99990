"""Device-resident hybrid index for the torch query path.

Counterpart of the reference package's ``retrieval/device_index.py``: the
BM25 postings in ONE of two layouts (doc-slot, the default, or doc-major
blocked), the slot-major bucketed chunk bank, both in the bucketed
(permuted) doc order, and for an index with no chunk buckets (an empty
corpus) the packed arrays the no-bucket tail reads.  The numpy builders
are copies of the reference's, so both packages build bit-identical
layouts from the same ``IndexArtifacts``.

Padding scheme (as in the reference):
  * docs -> permuted so docs with the same chunk count are contiguous; each
    bucket holds a 128-aligned number of doc slots; the doc axis is a
    multiple of 128.  Within a bucket the slot layout sorts docs by
    posting count, the blocked layout deals them so 128-doc blocks carry
    balanced posting sums (``balance_by_load``).
  * slot postings -> column ``d % 512`` of group ``d // 512`` holds doc d's
    postings stacked vertically; groups are classed by row stride.
  * blocked postings -> row i holds the postings of docs ``[128i, 128i+128)``
    sorted by doc, then pads (term -1, impact 0, local id 0) to a common
    multiple of ``POSTING_CHUNK``.

The slot classes are stored as views into ONE flat buffer (``SlotStream``)
so the CUDA slot kernels walk every group of every class in one launch;
the blocked rows carry per-doc posting offsets (``BlockedPostings``) so the
blocked kernels read only real postings.
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


def upload(a, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  To the card it goes as one
    pinned, non-blocking copy, which does not make the host wait for the
    work queued before it (a pageable copy synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def balance_by_load(
    idxs: np.ndarray, load: np.ndarray, block: int = 128
) -> np.ndarray:
    """Reorder ``idxs`` so consecutive ``block``-sized windows carry roughly
    equal total ``load`` (posting count).

    The blocked layout pads every 128-doc block to the HEAVIEST block's
    posting count, so clustering heavy docs (which the chunk-count
    bucketing naturally does: long docs have both more chunks and more
    postings) multiplies padding.  Sort by load descending and deal
    round-robin into ceil(n/block) piles: each pile sums to ~total/piles.
    """
    n = len(idxs)
    if n <= block:
        return idxs
    order = np.argsort(-load[idxs], kind="stable")
    n_piles = -(-n // block)
    pile = np.arange(n) % n_piles
    slot = np.arange(n) // n_piles
    # concatenate piles in order: position = pile * (pile size) + slot,
    # with ragged pile sizes handled by lexsort
    final = np.lexsort((slot, pile))
    return idxs[order][final]


def _sort_by_load(idxs: np.ndarray, load: np.ndarray) -> np.ndarray:
    """Order ``idxs`` by descending ``load`` (posting count)."""
    return idxs[np.argsort(-load[idxs], kind="stable")]


DOC_BLOCK = 128  # docs per blocked-layout row; doc-axis alignment
POSTING_CHUNK = 2048  # blocked rows are padded to a multiple of this
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


def build_blocked_postings(
    indptr: np.ndarray,
    post_docs: np.ndarray,
    post_impact: np.ndarray,
    n_docs_pad: int,
    posting_chunk: int = POSTING_CHUNK,
):
    """Term-major CSR -> doc-major blocked layout for the blocked kernels.

    Returns (blk_terms, blk_impact, blk_local) of shape
    ``[n_blocks, p_blk]`` where block i holds the postings of docs
    ``[i*128, (i+1)*128)`` sorted by doc (within a doc in CSR order), then
    pads to a common multiple of posting_chunk.  Pad terms are -1 (query
    term ids are >= 0, so they never match), pad impacts 0, pad local ids
    0.
    """
    V = indptr.shape[0] - 1
    term_of_post = np.repeat(np.arange(V, dtype=np.int32), np.diff(indptr))
    order = np.argsort(post_docs, kind="stable")
    d_sorted = post_docs[order]
    t_sorted = term_of_post[order]
    i_sorted = post_impact[order]

    n_blocks = n_docs_pad // DOC_BLOCK
    bounds = np.searchsorted(
        d_sorted, np.arange(0, n_docs_pad + 1, DOC_BLOCK)
    )
    sizes = np.diff(bounds)
    p_blk = int(max(sizes.max() if len(sizes) else 0, 1))
    p_blk = ((p_blk + posting_chunk - 1) // posting_chunk) * posting_chunk

    blk_terms = np.full((n_blocks, p_blk), -1, np.int32)
    blk_impact = np.zeros((n_blocks, p_blk), np.float32)
    blk_local = np.zeros((n_blocks, p_blk), np.int32)
    for i in range(n_blocks):
        s, e = bounds[i], bounds[i + 1]
        n = e - s
        if n:
            blk_terms[i, :n] = t_sorted[s:e]
            blk_impact[i, :n] = i_sorted[s:e]
            blk_local[i, :n] = d_sorted[s:e] - i * DOC_BLOCK
    return blk_terms, blk_impact, blk_local


def build_index_fields(
    art: IndexArtifacts,
    config: Optional[Config] = None,
    bm25_layout: str = "slots",
):
    """Host (numpy) construction of every array the query path reads.

    Same arithmetic as the reference ``DeviceIndex.from_artifacts`` with
    ``build_unused_layout=False``: ``bm25_layout`` ("slots" or "blocked")
    picks the one BM25 layout that is built, and the doc order inside a
    chunk-count bucket that suits it.  An index without chunk embeddings
    has no buckets: it is always blocked, keeps the artifact doc order
    (``doc_perm`` None) and carries the packed chunk arrays of the
    no-bucket tail.  Returns the dict ``device_index_from_numpy`` takes
    (banks in f32); the fields of the layout not built are None."""
    cfg = config or art.config
    n_docs = art.n_docs
    n_docs_pad = max(_round_up(n_docs, 128), 128)
    n_chunks = art.n_chunks
    n_chunks_pad = max(_round_up(n_chunks, 128), 128)

    # --- bucketed dense layout + doc permutation (may grow n_docs_pad) ----
    buckets, bucket_emb, bucket_valid, bucket_start = [], [], [], []
    doc_perm = inv = None
    if n_chunks:
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
        # within a chunk-count bucket, order docs to suit the BM25 layout:
        # slots wants posting counts sorted (its padding is the
        # within-group stride spread); blocked wants per-block SUMS
        # balanced (its padding is the largest block sum)
        if bm25_layout == "slots":
            idxs_per = [
                _sort_by_load(order[dnc[order] == n], post_load)
                for n in distinct
            ]
        else:
            idxs_per = [
                balance_by_load(order[dnc[order] == n], post_load, DOC_BLOCK)
                for n in distinct
            ]
        # 128-aligned bucket capacities; the rounding of the doc axis to a
        # DOC_BLOCK multiple goes to the smallest-stride bucket
        pads = [_round_up(max(len(ix), 8), 128) for ix in idxs_per]
        total = sum(pads)
        pads[0] += max(_round_up(total, DOC_BLOCK), DOC_BLOCK) - total
        perm_parts = []
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

    fields = {
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

    # --- exactly one BM25 layout, in the (permuted) doc order -------------
    post_docs = np.asarray(art.post_docs)
    if inv is not None:
        post_docs = inv[post_docs]
    csr = (np.asarray(art.indptr), post_docs, np.asarray(art.post_impact))
    # the no-bucket tail reads only the blocked layout
    if (bm25_layout if buckets else "blocked") == "slots":
        slot_terms, slot_impact, col_unperm = build_slot_postings(
            *csr, n_docs_pad
        )
        fields.update(
            slot_terms=slot_terms, slot_impact=slot_impact,
            col_unperm=col_unperm,
        )
    else:
        blk_terms, blk_impact, blk_local = build_blocked_postings(
            *csr, n_docs_pad
        )
        fields.update(
            blk_terms=blk_terms, blk_impact=blk_impact, blk_local=blk_local
        )

    # --- packed chunk arrays (ARTIFACT doc order) for the no-bucket tail --
    if not buckets:
        chunk_emb = np.zeros((n_chunks_pad, art.chunk_emb.shape[1]), np.float32)
        chunk_emb[:n_chunks] = art.chunk_emb
        chunk_doc = np.full(n_chunks_pad, n_docs_pad, np.int32)
        chunk_doc[:n_chunks] = art.chunk_doc
        doc_chunk_start = np.zeros(n_docs_pad + 1, np.int32)
        doc_chunk_start[:n_docs] = art.doc_chunk_start
        doc_n_chunks = np.ones(n_docs_pad + 1, np.int32)
        doc_n_chunks[:n_docs] = art.doc_n_chunks
        fields.update(
            chunk_emb=chunk_emb, chunk_doc=chunk_doc,
            doc_chunk_start=doc_chunk_start, doc_n_chunks=doc_n_chunks,
        )
    return fields


@dataclasses.dataclass
class SlotStream:
    """Every stride class of the slot postings as one flat stream.

    Group ``g`` (class-concatenated order, i.e. the kernel's output column
    block ``g``) occupies ``rows[g] * SLOT_COLS`` elements of ``terms`` /
    ``impact`` starting at ``group_off[g]``, row-major ``[rows, SLOT_COLS]``.
    ``group_order`` lists the groups deepest first (ties in group order):
    the order in which the slot kernels start them.
    """

    terms: torch.Tensor  # int32 [total], pad -1
    impact: torch.Tensor  # float32 [total], pad 0
    group_off: torch.Tensor  # int64 [n_groups]
    group_rows: torch.Tensor  # int32 [n_groups]
    group_order: torch.Tensor  # int32 [n_groups]

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
        group_order=torch.from_numpy(
            np.argsort(-np.asarray(rows, np.int64), kind="stable").astype(
                np.int32
            )
        ).to(device),
    )
    return tuple(views_t), tuple(views_i), stream


@dataclasses.dataclass
class BlockedPostings:
    """The doc-major blocked postings plus where each doc's run starts.

    Row i holds docs ``[128i, 128i+128)``; doc j of row i owns entries
    ``[doc_off[i, j], doc_off[i, j + 1])`` of the row (its real postings,
    in order), and ``doc_off[i, 128]`` is the row's real count, after
    which come the pads.  The kernels and their plain versions find a
    posting's doc from ``doc_off``; the per-slot local ids stay on the
    host."""

    terms: torch.Tensor  # int32 [n_blocks, p_blk], pad -1
    impact: torch.Tensor  # float32 [n_blocks, p_blk], pad 0
    doc_off: torch.Tensor  # int32 [n_blocks, DOC_BLOCK + 1]

    @property
    def n_blocks(self) -> int:
        return int(self.terms.shape[0])

    @property
    def p_blk(self) -> int:
        return int(self.terms.shape[1])

    @property
    def n_docs_pad(self) -> int:
        return self.n_blocks * DOC_BLOCK


def blocked_doc_offsets(blk_terms: np.ndarray, blk_local: np.ndarray):
    """Per-row doc offsets [n_blocks, DOC_BLOCK + 1] of a blocked layout.

    Raises unless every row holds its real postings (term >= 0) first,
    sorted by a local doc id in [0, DOC_BLOCK), then only pads: the
    layout ``build_blocked_postings`` makes and the kernels rely on."""
    n_blocks, p_blk = blk_terms.shape
    real = blk_terms >= 0
    n_real = real.sum(axis=1)
    lead = np.arange(p_blk)[None, :] < n_real[:, None]
    loc = np.where(real, blk_local, 0)
    if (
        not np.array_equal(real, lead)
        or (loc < 0).any() or (loc >= DOC_BLOCK).any()
        or (np.diff(loc, axis=1)[lead[:, 1:]] < 0).any()
    ):
        raise ValueError(
            "blocked postings: each row must hold its real postings first, "
            "sorted by local doc id in [0, 128), then pads with term -1"
        )
    rows = np.nonzero(real)[0]
    counts = np.bincount(
        rows * DOC_BLOCK + loc[real], minlength=n_blocks * DOC_BLOCK
    ).reshape(n_blocks, DOC_BLOCK)
    off = np.zeros((n_blocks, DOC_BLOCK + 1), np.int32)
    np.cumsum(counts, axis=1, out=off[:, 1:])
    return off


def pack_blocked(blk_terms, blk_impact, blk_local, device) -> BlockedPostings:
    """numpy blocked arrays -> BlockedPostings on ``device`` (the local ids
    become the per-row doc offsets)."""

    def host(x, dtype):  # writable and C-ordered, copied only if needed
        return np.require(x, dtype, ["C", "W"])

    terms = host(blk_terms, np.int32)
    off = blocked_doc_offsets(terms, np.asarray(blk_local, np.int32))
    return BlockedPostings(
        terms=torch.from_numpy(terms).to(device),
        impact=torch.from_numpy(host(blk_impact, np.float32)).to(device),
        doc_off=torch.from_numpy(off).to(device),
    )


@dataclasses.dataclass
class DeviceIndex:
    # BM25, doc-slot layout (stride classes; see build_slot_postings);
    # None when the blocked layout is resident
    slot_terms: Optional[tuple]  # per class: int32 [n_g, S, SLOT_COLS] (views)
    slot_impact: Optional[tuple]  # per class: float32 [n_g, S, SLOT_COLS]
    slot_stream: Optional[SlotStream]  # the same postings as one flat stream
    col_unperm: Optional[torch.Tensor]  # int32 [n_docs_pad]
    # BM25, doc-major blocked layout; None when the slot layout is resident
    blocked: Optional[BlockedPostings]
    # dense, packed (artifact doc order); only for an index with no buckets
    chunk_emb: Optional[torch.Tensor]  # bank dtype [n_chunks_pad, dim]
    chunk_doc: Optional[torch.Tensor]  # int32 [n_chunks_pad] (pad: n_docs_pad)
    doc_chunk_start: Optional[torch.Tensor]  # int32 [n_docs_pad + 1]
    doc_n_chunks: Optional[torch.Tensor]  # int32 [n_docs_pad + 1]
    # dense, bucketed exact-stride layout (docs permuted by chunk count)
    buckets: tuple  # ((n, cnt_pad), ...)
    bucket_emb: tuple  # per bucket: bank dtype [n, cnt_pad, dim] slot-major
    bucket_valid: tuple  # per bucket: bool [cnt_pad] (real doc?)
    bucket_start: tuple  # per bucket: int32 [cnt_pad] packed chunk start
    doc_perm: Optional[np.ndarray]  # host: new doc idx -> artifact doc idx
    n_docs: int
    n_docs_pad: int
    n_chunks_pad: int
    n_terms: int
    nnz: int
    device: torch.device

    @property
    def bm25_layout(self) -> str:
        """The resident BM25 layout: "slots" or "blocked"."""
        return "slots" if self.slot_stream is not None else "blocked"

    @classmethod
    def from_artifacts(
        cls,
        art: IndexArtifacts,
        config: Optional[Config] = None,
        bank_dtype: Optional[torch.dtype] = None,
        device=None,
        bm25_layout: str = "slots",
    ) -> "DeviceIndex":
        """Build the index on ``device`` (the card by default) with the
        ``bm25_layout`` postings resident.  The banks are bf16 on the card
        and f32 on the CPU unless ``bank_dtype`` says otherwise."""
        dev = resolve_device(device)
        return device_index_from_numpy(
            build_index_fields(art, config, bm25_layout), dev, bank_dtype
        )

    def resident_bytes(self) -> int:
        """Bytes of every tensor this index holds on its device."""
        ts = [
            self.col_unperm,
            self.chunk_emb,
            self.chunk_doc,
            self.doc_chunk_start,
            self.doc_n_chunks,
            *self.bucket_emb,
            *self.bucket_valid,
            *self.bucket_start,
        ]
        if self.slot_stream is not None:
            st = self.slot_stream
            ts += [st.terms, st.impact, st.group_off, st.group_rows,
                   st.group_order]
        if self.blocked is not None:
            b = self.blocked
            ts += [b.terms, b.impact, b.doc_off]
        return sum(t.numel() * t.element_size() for t in ts if t is not None)


def device_index_from_numpy(
    fields: dict, device=None, bank_dtype: Optional[torch.dtype] = None
) -> DeviceIndex:
    """Index state carried across: numpy arrays -> the port's DeviceIndex.

    ``fields`` holds the arrays by their reference ``DeviceIndex`` field
    names (``build_index_fields`` output, or the reference index's arrays
    converted to numpy): the slot layout (``slot_terms``, ``slot_impact``,
    ``col_unperm``) or the blocked one (``blk_terms``, ``blk_impact``,
    ``blk_local``), the buckets, and for an index without buckets the
    packed ``chunk_emb``, ``chunk_doc``, ``doc_chunk_start`` and
    ``doc_n_chunks``; so both packages can serve bit-identical layouts.
    """
    dev = resolve_device(device)
    if bank_dtype is None:
        bank_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    def put(x, dtype):
        # a writable C-ordered array (copied only when it is not one)
        if x is None:
            return None
        x = np.require(x, requirements=["C", "W"])
        return torch.from_numpy(x).to(dev, dtype)

    slot_terms = slot_impact = stream = blocked = None
    if fields.get("slot_terms") is not None:
        slot_terms, slot_impact, stream = pack_slot_classes(
            [np.asarray(t, np.int32) for t in fields["slot_terms"]],
            [np.asarray(t, np.float32) for t in fields["slot_impact"]],
            dev,
        )
    elif fields.get("blk_terms") is not None:
        blocked = pack_blocked(
            fields["blk_terms"], fields["blk_impact"], fields["blk_local"],
            dev,
        )
    else:
        raise ValueError("fields hold neither the slot nor the blocked layout")
    chunk_emb = fields.get("chunk_emb")
    doc_perm = fields.get("doc_perm")
    return DeviceIndex(
        slot_terms=slot_terms,
        slot_impact=slot_impact,
        slot_stream=stream,
        col_unperm=put(fields.get("col_unperm"), torch.int32),
        blocked=blocked,
        chunk_emb=(
            None if chunk_emb is None
            else put(np.asarray(chunk_emb, np.float32), bank_dtype)
        ),
        chunk_doc=put(fields.get("chunk_doc"), torch.int32),
        doc_chunk_start=put(fields.get("doc_chunk_start"), torch.int32),
        doc_n_chunks=put(fields.get("doc_n_chunks"), torch.int32),
        buckets=tuple((int(n), int(c)) for n, c in fields["buckets"]),
        bucket_emb=tuple(
            put(np.asarray(e, np.float32), bank_dtype)
            for e in fields["bucket_emb"]
        ),
        bucket_valid=tuple(put(v, torch.bool) for v in fields["bucket_valid"]),
        bucket_start=tuple(
            put(s, torch.int32) for s in fields["bucket_start"]
        ),
        doc_perm=None if doc_perm is None else np.asarray(doc_perm, np.int64),
        n_docs=int(fields["n_docs"]),
        n_docs_pad=int(fields["n_docs_pad"]),
        n_chunks_pad=int(fields["n_chunks_pad"]),
        n_terms=int(fields["n_terms"]),
        nnz=int(fields["nnz"]),
        device=dev,
    )
