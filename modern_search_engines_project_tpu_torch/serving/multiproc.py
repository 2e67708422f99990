"""Multi-process serving: N workers sharing one port (SO_REUSEPORT).

Counterpart of the reference package's ``serving/multiproc.py``.  Each
worker process builds its own engine (on the card unless ``--device
cpu``), its own single-worker device executor and its own control plane
(``serving/http.py``), and listens with ``reuse_port`` so the kernel
balances connections across workers; responses carry ``X-Worker``.  The
workers are started with the ``spawn`` method, never forked: a forked
child of a process that has touched CUDA cannot use it.

The supervisor is also the failure detector: a worker that dies is
restarted with bounded backoff; SIGTERM/SIGINT tears the fleet down.

Used via:  python -m modern_search_engines_project_tpu_torch.serving --workers N
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import signal
import time

log = logging.getLogger("serving.multiproc")


def _worker_main(args, worker_idx: int) -> None:
    """One serving process: build an engine + service, serve with
    reuse_port so siblings share the address."""
    import importlib

    cli = importlib.import_module(
        "modern_search_engines_project_tpu_torch.serving.__main__"
    )
    from modern_search_engines_project_tpu_torch.serving import http as web
    from modern_search_engines_project_tpu_torch.serving.api import (
        SearchService,
    )

    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {worker_idx}] %(levelname)s %(message)s",
    )
    engine = cli.build_engine_from_args(args)
    if args.warmup:
        engine.warmup()
    service = SearchService(
        engine,
        queries_path=args.queries,
        query_cache_size=args.query_cache,
        trace_root=os.path.join(args.trace_root, f"worker{worker_idx}"),
        admin_token=args.admin_token,
    )
    app = service.build_app()

    async def tag_worker(request, handler):
        resp = await handler(request)
        resp.headers["X-Worker"] = str(worker_idx)
        return resp

    app.middlewares.append(tag_worker)
    fast = None
    if args.fastpath_port:
        from modern_search_engines_project_tpu_torch.serving.fastpath import (
            serve_fastpath,
        )

        # the C++ listener also sets SO_REUSEPORT: every worker binds the
        # same fastpath port and the kernel fans connections out
        fast = serve_fastpath(
            engine, args.fastpath_port, n_threads=args.fastpath_threads
        )
    try:
        web.run_app(
            app,
            host=args.host,
            port=args.port,
            reuse_port=True,
            handle_signals=False,
        )
    finally:
        if fast is not None:
            fast.stop()


def serve_workers(args) -> None:
    """Spawn + supervise ``args.workers`` serving processes."""
    ctx = mp.get_context("spawn")
    procs: dict = {}
    restarts: dict = {}
    stopping = {"flag": False}

    def start(idx: int):
        p = ctx.Process(
            target=_worker_main, args=(args, idx), daemon=False
        )
        p.start()
        procs[idx] = p
        log.info("worker %d started (pid %d)", idx, p.pid)

    def shutdown(*_sig):
        stopping["flag"] = True
        for p in procs.values():
            if p.is_alive():
                p.terminate()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    for i in range(args.workers):
        start(i)
    try:
        while not stopping["flag"]:
            time.sleep(0.5)
            for idx, p in list(procs.items()):
                if p.is_alive() or stopping["flag"]:
                    continue
                n = restarts.get(idx, 0)
                if n >= 5:
                    log.error(
                        "worker %d died %d times; not restarting", idx, n
                    )
                    continue
                restarts[idx] = n + 1
                delay = min(2.0 ** n * 0.5, 10.0)
                log.warning(
                    "worker %d exited (code %s); restart #%d in %.1fs",
                    idx, p.exitcode, n + 1, delay,
                )
                time.sleep(delay)
                start(idx)
    finally:
        shutdown()
        for p in procs.values():
            p.join(timeout=10)
