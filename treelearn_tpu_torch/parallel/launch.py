"""A launcher for data-parallel ranks on one host, joined through a file
store instead of a TCP port (torchrun's ``env://`` needs one).

    spawn_ranks(fn, 2, store_dir, *args)

starts ``world`` processes by the ``spawn`` method; each sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` as a launcher does and calls
``fn(init_method, *args)``, where ``init_method`` is
``file://<store_dir>/dp_store`` for :func:`parallel.mesh.init_dp` (or
``--dist_url`` of ``tools/train.py``).  ``fn`` must be importable by name
(a module-level function).  A rank that fails or outlives ``timeout``
fails the call; no process outlives it.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import torch.multiprocessing as mp


def _rank_entry(fn, rank: int, world: int, init_method: str, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    fn(init_method, *args)


def spawn_ranks(fn, world: int, store_dir: str, *args,
                timeout: float = 600.0) -> None:
    os.makedirs(store_dir, exist_ok=True)
    init_method = "file://" + osp.join(osp.abspath(store_dir), "dp_store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, init_method, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise RuntimeError(f"spawn_ranks: exit codes {codes}, ranks past the "
                           f"{timeout:.0f} s limit {hung}")
