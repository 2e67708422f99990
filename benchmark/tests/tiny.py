"""A tiny cell of each plane, for CPU runs of the harness in the tests."""

from __future__ import annotations

import copy

from benchmark import cells

ENCODER = {"vocab_size": 512, "dim": 64, "n_layers": 2, "n_heads": 2,
           "mlp_ratio": 2, "max_len": 64, "dtype": "bfloat16",
           "rope_base": 10000.0}
CROSS = dict(ENCODER, dim=32, n_layers=1, max_len=48)
CORPUS = {"n_docs": 3000, "n_terms": 2000, "zipf": 0.7, "nnz_target": 60000,
          "avg_chunks": 3.0, "max_chunks": 10, "dim": 64,
          "bank_dtype": "float32", "n_domains": 200, "window_words": 24}


def cell(plane: str = "data", loop: str = "open") -> dict:
    """A cell on the CPU: one of the benchmark's configurations and mixes
    at a small size."""
    name = "tue-web-100k" if plane == "data" else "tue-web-100k-ui"
    cfg = copy.deepcopy(cells.load_json(cells.HERE / "configs" / f"{name}.json"))
    cfg["corpus"] = dict(CORPUS)
    cfg["encoder"] = dict(ENCODER)
    cfg["engine"]["embedding_dim"] = CORPUS["dim"]
    cfg["correct"]["sample"] = 16
    if plane != "data":
        cfg["cross_encoder"] = dict(CROSS)
    mix = {"open": "steady_api", "closed": "closed256"}[loop]
    traffic = copy.deepcopy(cells.load_json(cells.HERE / "traffic" / f"{mix}.json"))
    traffic["warm"] = {"batch_sizes": [1, 4], "repeats": 1}
    if loop == "open":
        traffic["rate_qps"] = 20.0
    else:
        traffic["connections"] = 8
    traffic["drain_s"] = 20
    spec = cells.spec()
    return {"name": "tiny", "chips": 1, "config": cfg, "traffic": traffic,
            "end_to_end": spec["end_to_end"], "per_layer": spec["per_layer"]}
