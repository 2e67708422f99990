"""Multi-process sharded serving on ``torch.distributed``.

Counterpart of the reference package's ``parallel/multihost.py``.  N
processes join one process group over a ``tcp://`` rendezvous; each holds
its own run of the index's shards (flat shard id ``rank * n_local +
local``, host-major) and ranks every query of the batch against them, and
the sharded backend's collectives cross the processes: the candidate
gather as ``dist.all_gather_into_tensor`` of the packed ``vals ++ ids``
tensor, the maxes as ``dist.all_reduce(MAX)``.  The flat mesh gathers
every shard's set across processes; ``hierarchical=True`` merges within
the process first and sends one merged set a process.

Backends: NCCL where every process owns its own cards, gloo on the CPU
and where processes share a card (NCCL refuses two ranks on one GPU);
gloo takes CUDA tensors for both collectives.  A collective that fails
raises; nothing falls back.

Run one process a "host" (all on one box for the demo):

    python -m modern_search_engines_project_tpu_torch.parallel.multihost \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0 &
    python -m modern_search_engines_project_tpu_torch.parallel.multihost \\
        --coordinator localhost:29500 --num-processes 2 --process-id 1

(``--device cpu`` for CPU shards.)  Each process prints one JSON line with
its ranking as its last line; the batch is the same everywhere and the
merges are global, so every process prints the same ranking.
"""

from __future__ import annotations

import argparse
import datetime
import json
import time

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.parallel.sharding import Mesh

RENDEZVOUS_TIMEOUT_S = 300  # a peer that never arrives fails the run


def init_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    devices_per_process: int = 1,
    backend: str = None,
    device=None,
) -> np.ndarray:
    """Join the process group at ``tcp://{coordinator}`` and return the
    global device layout, the same in every process: an object array
    [num_processes, devices_per_process] of ``torch.device``.

    ``device``: "cuda" (default; raises without a card) or "cpu".  On the
    card, flat shard f of the n = num_processes * devices_per_process sits
    on card ``f * n_cards // n`` (contiguous runs).  ``backend``: None
    picks gloo on the CPU or where two processes share a card, else NCCL;
    naming NCCL for a shared card raises."""
    kind = torch.device("cuda" if device is None else device).type
    n = num_processes * devices_per_process
    if kind == "cpu":
        flat = [torch.device("cpu")] * n
    else:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n_cards:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' for CPU "
                "shards")
        flat = [torch.device("cuda", f * n_cards // n) for f in range(n)]
    grid = np.empty((num_processes, devices_per_process), dtype=object)
    for f, dev in enumerate(flat):
        grid[f // devices_per_process, f % devices_per_process] = dev
    owners = {}
    for p in range(num_processes):
        for dev in set(grid[p]):
            owners.setdefault(dev, set()).add(p)
    shared = kind == "cuda" and any(len(o) > 1 for o in owners.values())
    if backend is None:
        backend = "gloo" if kind == "cpu" or shared else "nccl"
    if backend == "nccl" and (shared or kind == "cpu"):
        raise ValueError("NCCL needs every process on cards of its own; "
                         "pass backend='gloo'")
    if kind == "cuda":
        torch.cuda.set_device(grid[process_id, 0])
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
    )
    return grid


def make_multihost_mesh(devices: np.ndarray, axis: str = "shard",
                        hierarchical: bool = False) -> Mesh:
    """The mesh over every process's devices (``init_multihost``'s
    layout).  Flat: one ``(axis,)`` row, rank-major.  ``hierarchical``
    (more than one device a process and more than one process): a
    ``("host", axis)`` mesh whose rows are the processes, so candidates
    merge within a process first and one merged set a process crosses."""
    grid = np.asarray(devices, dtype=object)
    world, n_local = grid.shape
    owner = np.repeat(np.arange(world)[:, None], n_local, axis=1)
    if hierarchical and world > 1 and n_local > 1:
        return Mesh(grid, ("host", axis), owner=owner)
    return Mesh(grid.reshape(-1), (axis,), owner=owner.reshape(-1))


def demo_corpus(n_docs: int = 64):
    """The reference's deterministic corpus: every process builds the same
    artifacts."""
    from modern_search_engines_project_tpu_torch.index.builder import Document

    words = [
        "tuebingen", "castle", "neckar", "university", "research", "law",
        "faculty", "ai", "cyber", "valley", "museum", "river", "town",
        "student", "library", "science", "history", "bridge",
    ]
    docs = []
    for i in range(n_docs):
        body = " ".join(
            words[(i * 7 + j * 3) % len(words)] for j in range(40)
        )
        docs.append(
            Document(
                doc_id=i + 1,
                url=f"https://host{i % 4}.example.org/page/{i}",
                title=f"Document {i}",
                text=f"{words[i % len(words)]} {body}",
            )
        )
    return docs


QUERIES = ["castle neckar", "university research law", "ai cyber valley"]
DEMO_CONFIG = dict(embedding_dim=32, window_size=32, step_size=25,
                   top_k_retrieval=32, top_k_reranking=8, max_query_terms=8)


def run_demo(devices, n_docs: int = 64, time_repeats: int = 5,
             hierarchical: bool = False):
    """Shard the demo index over the global mesh and rank the demo
    queries.  Returns ([[doc_id, score], ...] a query, the best warm
    ``search_batch`` wall ms, and that call's host ms inside the
    cross-process collectives)."""
    from modern_search_engines_project_tpu_torch.config import Config
    from modern_search_engines_project_tpu_torch.index import IndexBuilder
    from modern_search_engines_project_tpu_torch.models import HashingEncoder
    from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

    cfg = Config(**DEMO_CONFIG)
    enc = HashingEncoder(dim=32)
    art = IndexBuilder(enc, cfg).build(demo_corpus(n_docs))
    engine = SearchEngine.sharded(
        art, enc, make_multihost_mesh(devices, hierarchical=hierarchical),
        cfg)
    out = [[[d.doc_id, round(d.similarity_score, 4)] for d in ranked]
           for ranked in engine.search_batch(QUERIES, top_k=5)]
    best = None
    for _ in range(max(1, time_repeats)):
        t0 = time.perf_counter()
        engine.search_batch(QUERIES, top_k=5)  # ends in a copy to the host
        dt = (time.perf_counter() - t0) * 1e3
        if best is None or dt < best[0]:
            best = (dt, engine._backend.cross_ms)
    return out, best[0], best[1]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default="localhost:29500")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--docs", type=int, default=64)
    p.add_argument(
        "--hierarchical", action="store_true",
        help="2-level (host, shard) mesh: merge within the process first, "
             "then one merged set a process crosses")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="shards on the card (default; raises without one) "
                        "or on the CPU")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="process-group backend (default: gloo on the CPU "
                        "or where processes share a card, else NCCL)")
    args = p.parse_args(argv)

    devices = init_multihost(
        args.coordinator, args.num_processes, args.process_id,
        devices_per_process=args.devices_per_process, backend=args.backend,
        device=args.device,
    )
    try:
        results, rank_ms, cross_ms = run_demo(
            devices, args.docs, hierarchical=args.hierarchical)
        print(json.dumps({
            "process_id": args.process_id,
            "process_count": torch.distributed.get_world_size(),
            "global_devices": int(devices.size),
            "local_devices": int(devices.shape[1]),
            "hierarchical": args.hierarchical,
            "backend": torch.distributed.get_backend(),
            "device": str(devices[args.process_id, 0]),
            "rank_ms_per_batch": rank_ms,
            "collective_ms_per_batch": cross_ms,
            "results": results,
        }), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
