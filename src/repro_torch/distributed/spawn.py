"""Run a function on the ranks of a gloo process group, one process a rank.

Nothing on the card's machine announces a cluster, so :func:`run_ranks`
makes one: it spawns ``world_size`` processes (the ``spawn`` start method),
joins them in a ``gloo`` group through a ``file://`` rendezvous in a
directory it is given (or a temporary one), calls ``fn(rank, world_size,
*args)`` in each and returns their results in rank order.  Gloo moves host
tensors, so several ranks may share one card, each with its own CUDA
context (NCCL refuses two ranks on one device).  A rank that fails to join
the group, raises, or exits non-zero makes :func:`run_ranks` stop every
rank and raise; nothing falls back to fewer ranks.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable


def _rank_main(fn: Callable[..., Any], rank: int, world_size: int, init: str, out: Any,
               args: tuple, timeout_s: float) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    out.put((rank, True, result))


def run_ranks(fn: Callable[..., Any], world_size: int, *args: Any,
              init_dir: str | Path | None = None, timeout_s: float = 900.0) -> list[Any]:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]``, each
    run in its own process of one gloo group.  ``fn`` and ``args`` must be
    picklable (``fn`` importable by module path); so must each result."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init, out, args, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results: dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world_size:
                try:
                    rank, ok, value = out.get(timeout=5.0)
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in results]
                    if dead:
                        raise RuntimeError(f"rank(s) exited without a result: {dead}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks gave no result in {timeout_s} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
            for p in procs:
                p.join(timeout=timeout_s)
            bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"rank(s) exited non-zero: {bad}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
    return [results[r] for r in range(world_size)]


__all__ = ["run_ranks"]
