"""Run a function on G ranks joined in one ``torch.distributed`` group.

    from repro_torch.launch.ranks import run_ranks
    results = run_ranks(my_rank_fn, 2, args=(path,))                  # NCCL, a card each
    results = run_ranks(my_rank_fn, 2, backend="gloo", device="cpu")  # on the host

``run_ranks`` spawns ``world`` processes (``torch.multiprocessing``, start
method ``spawn``), joins them in a process group through a file under a
temporary directory, calls ``fn(rank, world, *args)`` in each, and returns
the ranks' return values in rank order (each one pickled through a file).
``fn`` must be importable by the children: a module-level function; it
sets any environment it needs itself.  Each rank runs the cores shared out
among the ranks as its intra-op threads.

Every wait is bounded.  The group gets ``timeout`` seconds, so a collective
that a failed rank never joins raises instead of hanging; the parent waits
at most ``timeout`` seconds for the whole run, then kills every rank and
raises ``TimeoutError``.  A rank that raises fails the run: the others are
killed and the parent raises with that rank's traceback.

On the card (``device="cuda"``) rank r uses card ``r % device_count``.
NCCL takes one rank per card; G ranks sharing one card use gloo, which
stages CUDA tensors through the host (``core.distributed.ShardComm``); for
DTensor's functional collectives each such rank installs the host-staged
CUDA kernels of ``distributed/host_staged.py`` before it joins.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _rank_main(rank: int, fn: Callable, world: int, args: tuple, backend: str, device: str,
               timeout: float, workdir: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "gloo" and device.startswith("cuda"):
        from ..distributed.host_staged import register

        register()  # DTensor's collectives on CUDA tensors, staged through the host
    if device.startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'pg')}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(
    fn: Callable,
    world: int,
    *,
    args: Sequence[Any] = (),
    backend: str = "nccl",
    device: str = "cuda",
    timeout: float = 300.0,
    tmp_dir: Optional[str] = None,
) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    on its own spawned rank (see the module doc).  The group's init file
    and the results go to a new directory under ``tmp_dir`` (default: the
    system's temporary directory)."""
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_", dir=tmp_dir)
    try:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world, tuple(args), backend, device, float(timeout), workdir),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
