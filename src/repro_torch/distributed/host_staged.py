"""Host-staged collectives for ranks that share one card.

NCCL takes one rank per card, so ranks sharing a card join a gloo group.
DTensor moves its shards with PyTorch's functional collectives
(``torch.ops._c10d_functional``), and gloo cannot run those on CUDA tensors:
two gloo ranks on one H100 stopped with a segmentation fault in DTensor's
first collective (PyTorch 2.11), and a ``torch.distributed`` backend written
in Python is not reached there (the functional collectives look the group's
CUDA backend up in C++ and find none).  :func:`register` therefore installs,
for the CUDA dispatch key of each functional collective, an implementation
that stages the operands through the host: copy to host memory, run the
same collective on the host copies (gloo, on the same group), copy the
result back onto the card.  The compute stays on the card; only the
transport goes through the host, as ``core.distributed.ShardComm`` stages
its own gloo all-gathers.

    from repro_torch.distributed import host_staged
    host_staged.register()          # once per process, before any collective
    dist.init_process_group("gloo", ...)

Host copies are pinned.  Reduce-scatter runs as gloo's own on the host
where the installed gloo has it, else as an all-reduce that keeps this
rank's chunk; all-to-all runs as an all-gather on the host (equal splits,
the only ones DTensor issues).  Every staged call completes before it
returns.  ``calls`` counts them by name and ``seconds["total"]`` sums their
host-clock time (a staged call synchronizes: its copy to the host waits
for the card), process-wide.  Register only in processes whose CUDA
collectives all run on gloo groups: the NCCL kernels of the same operators
are replaced too.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["register", "calls", "seconds", "reset", "STAGED_OPS"]

STAGED_OPS = (
    "all_gather_into_tensor",
    "all_gather_into_tensor_coalesced",
    "reduce_scatter_tensor",
    "reduce_scatter_tensor_coalesced",
    "all_reduce",
    "all_reduce_coalesced",
    "all_to_all_single",
    "broadcast",
)

calls: Dict[str, int] = {}
seconds = {"total": 0.0}
_LIB = None


def _fc():
    return torch.ops._c10d_functional


def _group(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _fc().wait_tensor.default(t)


def _count(name: str) -> None:
    calls[name] = calls.get(name, 0) + 1


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory when ``t`` is on a card (the
    copies both ways run at the link's rate)."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _all_gather(inp: torch.Tensor, group_size: int, group_name: str) -> torch.Tensor:
    host = _wait(_fc().all_gather_into_tensor.default(_host(inp), group_size, group_name))
    return host.to(inp.device)


def _all_reduce_host(inp: torch.Tensor, reduce_op: str, group_name: str) -> torch.Tensor:
    return _wait(_fc().all_reduce.default(_host(inp), reduce_op, group_name))


_NATIVE_REDUCE_SCATTER = [True]


def _reduce_scatter(inp, reduce_op, group_size, group_name):
    import torch.distributed as dist

    host = _host(inp)
    if _NATIVE_REDUCE_SCATTER[0]:
        try:
            out = _wait(_fc().reduce_scatter_tensor.default(host, reduce_op, group_size,
                                                             group_name))
            return out.to(inp.device)
        except (RuntimeError, NotImplementedError):  # gloo without reduce-scatter
            _NATIVE_REDUCE_SCATTER[0] = False
    total = _wait(_fc().all_reduce.default(host, reduce_op, group_name))
    rank = dist.get_rank(_group(group_name))
    return total.chunk(group_size)[rank].contiguous().to(inp.device)


def all_gather_into_tensor(inp, group_size, group_name):
    _count("all_gather_into_tensor")
    return _all_gather(inp, group_size, group_name)


def all_gather_into_tensor_coalesced(inputs, group_size, group_name):
    _count("all_gather_into_tensor_coalesced")
    return [_all_gather(t, group_size, group_name) for t in inputs]


def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
    _count("reduce_scatter_tensor")
    return _reduce_scatter(inp, reduce_op, group_size, group_name)


def reduce_scatter_tensor_coalesced(inputs, reduce_op, group_size, group_name):
    _count("reduce_scatter_tensor_coalesced")
    return [_reduce_scatter(t, reduce_op, group_size, group_name) for t in inputs]


def all_reduce(inp, reduce_op, group_name):
    _count("all_reduce")
    return _all_reduce_host(inp, reduce_op, group_name).to(inp.device)


def all_reduce_coalesced(inputs, reduce_op, group_name):
    _count("all_reduce_coalesced")
    return [_all_reduce_host(t, reduce_op, group_name).to(t.device) for t in inputs]


def all_to_all_single(inp, output_split_sizes, input_split_sizes, group_name):
    import torch.distributed as dist

    _count("all_to_all_single")
    pg = _group(group_name)
    g, rank = dist.get_world_size(pg), dist.get_rank(pg)
    for sizes in (output_split_sizes, input_split_sizes):
        if sizes is not None and len({int(s) for s in sizes}) > 1:
            raise NotImplementedError("host-staged all-to-all takes equal splits only")
    everyone = _all_gather(inp, g, group_name)  # rank r's whole input is block r
    return torch.cat([b.chunk(g)[rank] for b in everyone.chunk(g)]).contiguous()


def broadcast(inp, src, group_name):
    _count("broadcast")
    host = _wait(_fc().broadcast.default(_host(inp), src, group_name))
    return host.to(inp.device)


def reset() -> None:
    calls.clear()
    seconds["total"] = 0.0


def _timed(fn):
    import functools
    import time

    @functools.wraps(fn)
    def run(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds["total"] += time.perf_counter() - t0

    return run


def register() -> None:
    """Install the host-staged CUDA kernels of :data:`STAGED_OPS` in this
    process (idempotent)."""
    global _LIB
    if _LIB is not None:
        return
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    impls = globals()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "overriding a previously registered kernel"
        for name in STAGED_OPS:
            lib.impl(name, _timed(impls[name]), "CUDA")
    _LIB = lib
