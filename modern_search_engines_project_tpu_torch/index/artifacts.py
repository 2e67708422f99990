"""Index artifact persistence: a directory of npz arrays and JSON metadata.

Counterpart of the reference package's ``index/artifacts.py``, with the
same layout (``arrays.npz``, ``vocab.json``, ``meta.json``) and the same
atomic save (written to a private directory, then renamed into place), so
an index that either package wrote loads in the other.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index.builder import IndexArtifacts
from modern_search_engines_project_tpu_torch.index.vocab import TermDictionary

_ARRAY_FIELDS = [
    "indptr",
    "post_docs",
    "post_impact",
    "idf",
    "df",
    "doc_len",
    "chunk_emb",
    "chunk_doc",
    "doc_chunk_start",
    "doc_n_chunks",
]
_META_FIELDS = ["doc_ids", "urls", "titles", "domains", "snippets", "window_texts"]


def save_artifacts(art: IndexArtifacts, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path)
    try:
        np.savez(
            os.path.join(tmp, "arrays.npz"),
            **{f: getattr(art, f) for f in _ARRAY_FIELDS},
        )
        art.vocab.save(os.path.join(tmp, "vocab.json"))
        meta = {f: getattr(art, f) for f in _META_FIELDS}
        meta["avgdl"] = art.avgdl
        meta["config"] = art.config.__dict__
        meta["encoder"] = art.encoder_meta
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        for name in ("arrays.npz", "vocab.json", "meta.json"):
            os.replace(os.path.join(tmp, name), os.path.join(path, name))
    finally:
        for leftover in os.listdir(tmp):
            os.unlink(os.path.join(tmp, leftover))
        os.rmdir(tmp)


def load_artifacts(path: str) -> IndexArtifacts:
    arrays = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = Config(**meta["config"])
    return IndexArtifacts(
        **{f: arrays[f] for f in _ARRAY_FIELDS},
        avgdl=float(meta["avgdl"]),
        vocab=TermDictionary.load(os.path.join(path, "vocab.json")),
        **{f: meta[f] for f in _META_FIELDS},
        config=cfg,
        encoder_meta=meta.get("encoder", {}),
    )
