"""Start ranks on this host without a launcher.

:func:`spawn` runs ``fn(rank, world_size, *args)`` in ``world_size`` fresh
processes (the ``spawn`` start method: a child imports torch and the port,
nothing of its parent), each in a default process group that meets
through a ``FileStore`` in a temporary directory: gloo on the CPU, NCCL on
``cuda:{rank}``.  It returns the ranks' results in rank order, and raises
with the traceback of the first rank that failed, or when the ranks have
not all finished within ``join_timeout_s``.  Every process it starts has
ended when it returns.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import backend_for, check_device_count


def _rank_main(rank, world_size, store_path, device, timeout_s, threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        backend = backend_for(device)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size), rank=rank,
                                world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(
    fn: Callable,
    world_size: int,
    args: Sequence = (),
    *,
    device: str | torch.device = "cpu",
    timeout_s: float = 60.0,
    join_timeout_s: Optional[float] = None,
    threads: Optional[int] = 1,
) -> List:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new ranks and
    return their results in rank order.

    ``fn``, ``args`` and the results are pickled (``fn`` by its import
    path; return tensors as numpy arrays: torch sends a tensor as shared
    memory, which does not outlive its rank);
    ``timeout_s`` bounds each collective's wait, ``join_timeout_s`` the
    whole run (None: unbounded), and ``threads`` sets each rank's torch
    threads (None: torch's default).
    """
    check_device_count(world_size, device)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, os.path.join(tmp, "store"), str(torch.device(device)),
                               timeout_s, threads, fn, tuple(args), results))
             for r in range(world_size)]
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            wait = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            try:
                rank, ok, value = results.get(timeout=wait)
            except queue.Empty:
                raise TimeoutError(f"{world_size - len(out)} of {world_size} ranks did not finish "
                                   f"within {join_timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
