"""Start W worker processes on one host, as torchrun would, and bring
back each rank's result: the harness of the multi-process CPU tests and
of ``chip_smoke.py``'s ranks sharing one card.

``spawn(fn, W, args)`` starts W processes by ``multiprocessing``'s spawn
method. Each gets torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` = 127.0.0.1, ``MASTER_PORT`` = a free
port) plus ``env``, and, as torchrun gives ranks that share a host,
one intra-op thread unless ``OMP_NUM_THREADS`` says otherwise; it joins
the group through ``mesh.distributed_init``,
runs ``fn(*args)``, sends back what it returns (picklable: numpy, not CUDA
tensors) and destroys the group. ``fn`` must be importable by its module
path, which spawn needs; it lives in this package so that spawn can
import the worker entry.

A rank that raises, or a run that outlasts ``timeout_s``, kills every
worker and raises here: one rank that left early would otherwise hang the
others in their next collective.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn, rank: int, world: int, port: int, args, env, device: str,
            backend: Optional[str], out) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port), **env})
    import torch
    import torch.distributed as dist

    from .mesh import distributed_init
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    try:
        distributed_init(device, backend=backend)
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *,
          timeout_s: float = 300.0, device: str = "cpu",
          backend: Optional[str] = None,
          env: Optional[Dict[str, str]] = None) -> List[Any]:
    """``fn(*args)`` on ``world`` ranks; returns their results by rank.
    ``device`` and ``backend`` go to ``distributed_init`` (``cpu``: gloo;
    ``cuda``: nccl unless ``backend`` says ``gloo``); ``env`` is added to
    each worker's environment (e.g. ``LOCAL_RANK`` 0 for every rank of
    ranks that share one GPU)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world, port, tuple(args),
                               dict(env or {}), device, backend, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks: {sorted(results)} "
                                   f"finished within {timeout_s} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(world)]
