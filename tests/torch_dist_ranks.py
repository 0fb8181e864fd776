"""Rank functions of ``tests/test_torch_distributed.py``.

Imported by the ranks that ``repro_torch.launch.ranks.run_ranks`` spawns,
so it imports the port only (no ``jax``, no ``repro``).  Each function runs
one scenario on every rank (gloo, CPU) and returns what the test compares:
across ranks (bit-identical results), against the reference, and against
budgets.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

import repro_torch
from repro_torch.core.distributed import ShardComm
from repro_torch.core.lanczos import NumericalBreakdown
from repro_torch.core.operators import ChunkedOperator
from repro_torch.kernels import engine as keng
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.spmv_bsr import check_bsr_operands
from repro_torch.testing import faults

K = 4
ITERS = 24
SEED = 1
FAULT_ITERS = 20
CHUNK_NNZ = 512
UPDATE_MODES = ("unfused", "fused", "fused_spmv")
REORTHS = ("none", "full")


def _mesh(world: int):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", list(range(world)), mesh_dim_names=("data",))


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _result(res) -> dict:
    return {
        "eigenvalues": res.eigenvalues.clone(),
        "eigenvectors": res.eigenvectors.clone(),
        "residuals": np.asarray(res.residuals),
        "alpha": res.tridiag.alpha.clone(),
        "beta": res.tridiag.beta.clone(),
        "backend": res.backend,
        "num_devices": res.num_devices,
        "spmv_format": res.spmv_format,
        "partition": res.partition,
    }


def _solve(csr, world: int, **kw) -> dict:
    repro_torch.session_cache_clear()
    ShardComm.reset_calls()
    kw.setdefault("num_iters", ITERS)
    kw.setdefault("reorth", "full")
    res = repro_torch.eigsh(csr, K, backend="distributed", seed=SEED, device="cpu", **kw)
    out = _result(res)
    out["calls"] = dict(ShardComm.calls)
    return out


class _KernelRoute:
    """Route the kernel wrappers as on the card (``ops.on_cpu`` False) into
    counting wrappers of the plain versions, so a CPU run shows which
    kernels a path launches.  The BSR wrapper runs the kernel's operand
    check first."""

    NAMES = ("spmv_ell", "spmv_ell_alpha", "lanczos_update", "spmv_bsr", "spmv_ell_packed")

    def __init__(self):
        self.launches = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        def count(name, fn):
            def call(*args, accum_dtype, **kw):
                self.launches[name] += 1
                return fn(*args, accum_dtype, **kw)
            return call

        def bsr(val, bcol, x, accum_dtype, n_cols=None):
            check_bsr_operands(val, bcol, x, n_cols)
            return ref.spmv_bsr_ref(val, bcol, x, accum_dtype)

        self._saved = {n: getattr(kops, f"{n}_kernel_call") for n in self.NAMES}
        self._on_cpu = kops.on_cpu
        kops.on_cpu = lambda t: False
        kops.spmv_ell_kernel_call = count("spmv_ell", ref.spmv_ell_ref)
        kops.spmv_ell_alpha_kernel_call = count("spmv_ell_alpha", ref.spmv_ell_alpha_ref)
        kops.lanczos_update_kernel_call = count("lanczos_update", ref.lanczos_update_ref)
        kops.spmv_bsr_kernel_call = count("spmv_bsr", bsr)
        kops.spmv_ell_packed_kernel_call = count("spmv_ell_packed", ref.spmv_ell_packed_ref)
        return self

    def __exit__(self, *exc):
        kops.on_cpu = self._on_cpu
        for n, fn in self._saved.items():
            setattr(kops, f"{n}_kernel_call", fn)
        return False


def solves(rank: int, world: int, mats: dict) -> dict:
    """The distributed solves: each matrix under ``format="auto"`` (through
    the counting kernel route), road through an explicit ``DeviceMesh``,
    ``backend="auto"``, and the collective budget per update mode and
    re-orthogonalization."""
    out = {}
    for name, csr in mats.items():
        with _KernelRoute() as route:
            out[name] = _solve(csr, world)
        out[name]["launches"] = dict(route.launches)
    mesh = _mesh(world)
    out["road_mesh"] = _solve(mats["road"], world, mesh=mesh)
    repro_torch.session_cache_clear()
    out["auto_backend"] = repro_torch.eigsh(mats["road"], K, num_iters=ITERS, seed=SEED,
                                            device="cpu").backend
    out["budget"] = {}
    for mode in UPDATE_MODES:
        for reorth in REORTHS:
            with _env("REPRO_ITER_UPDATE", mode), _KernelRoute() as route:
                r = _solve(mats["road"], world, reorth=reorth, num_iters=12)
            out["budget"][mode, reorth] = {"calls": r["calls"], "launches": dict(route.launches),
                                          "eigenvalues": r["eigenvalues"]}
    return out


def _breakdown(csr, spec: str, **kw):
    repro_torch.session_cache_clear()
    try:
        with faults.inject(spec):
            res = repro_torch.eigsh(csr, K, backend="distributed", policy="FFF",
                                    num_iters=FAULT_ITERS, device="cpu", **kw)
    except NumericalBreakdown as exc:
        return {"kind": exc.kind, "iteration": exc.iteration, "policy": exc.policy}
    return {"trail": res.recovery_trail, "eigenvalues": res.eigenvalues.clone()}


def fault_runs(rank: int, world: int, web) -> dict:
    """Typed breakdowns and ``recovery="auto"`` on the distributed backend
    (the reference's ``tests/test_faults.py`` cases)."""
    return {
        "spmv_nan": _breakdown(web, "spmv_nan@iter=3", recovery="raise"),
        "beta_collapse": _breakdown(web, "beta_collapse@iter=2", recovery="raise"),
        "auto_nan": _breakdown(web, "spmv_nan@iter=3", recovery="auto"),
        "auto_beta": _breakdown(web, "beta_collapse@iter=2", recovery="auto"),
    }


def _chunked_ops(csr, mesh, staging: str):
    eng = keng.make_engine(csr, "ell", accum_dtype=torch.float64, allowed=("coo", "ell"),
                           storage_dtype=torch.float32, device="cpu")
    return ChunkedOperator(csr, chunk_nnz=CHUNK_NNZ, engine=eng, staging=staging, device="cpu",
                           mesh=mesh)


def chunked_runs(rank: int, world: int, csr) -> dict:
    """The sharded chunk path against the unsharded one: matvecs under f32
    and bf16 staging (through the counting kernel route), and the chunked
    ``eigsh`` with and without ``mesh=``."""
    mesh = _mesh(world)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(csr.n)).to(torch.float32)
    out = {}
    for staging in ("f32", "bf16"):
        sharded, plain = _chunked_ops(csr, mesh, staging), _chunked_ops(csr, None, staging)
        ShardComm.reset_calls()
        with _KernelRoute() as route:
            y = sharded.matvec(x, accum_dtype=torch.float64)
        out[staging] = {
            "sharded": y, "plain": plain.matvec(x, accum_dtype=torch.float64),
            "launches": dict(route.launches), "calls": dict(ShardComm.calls),
            "chunks": sharded.num_chunks, "bytes_staged": sharded.staging["bytes_staged"],
            "plain_bytes_staged": plain.staging["bytes_staged"],
        }
    for tag, kw in (("sharded", {"mesh": mesh}), ("plain", {})):
        repro_torch.session_cache_clear()
        res = repro_torch.eigsh(csr, K, backend="chunked", format="ell", chunk_nnz=CHUNK_NNZ,
                                num_iters=20, seed=SEED, device="cpu", **kw)
        out["eigsh_" + tag] = _result(res)
    return out


def everything(rank: int, world: int, mats: dict, web_fault, chunk_csr) -> dict:
    """Every scenario of one world size, on one spawn."""
    return {
        "solves": solves(rank, world, mats),
        "faults": fault_runs(rank, world, web_fault),
        "chunked": chunked_runs(rank, world, chunk_csr),
    }


def _kernel_counters() -> dict:
    from repro_torch.kernels import lanczos_fused, lanczos_update, spmv_bsr, spmv_ell
    from repro_torch.kernels import spmv_ell_packed

    return {"spmv_ell": spmv_ell.spmv_ell_kernel_call,
            "spmv_ell_alpha": lanczos_fused.spmv_ell_alpha_kernel_call,
            "lanczos_update": lanczos_update.lanczos_update_kernel_call,
            "spmv_bsr": spmv_bsr.spmv_bsr_kernel_call,
            "spmv_ell_packed": spmv_ell_packed.spmv_ell_packed_kernel_call}


def gpu_runs(rank: int, world: int, road, block, v_road, v_block, k: int) -> dict:
    """On the card: the distributed solves of ``road`` (ELL) and ``block``
    (BSR) with the CUDA kernels' own launch counts, and the sharded chunk
    matvec against the unsharded one under f32 and bf16 staging."""
    from torch.distributed.device_mesh import DeviceMesh

    counters = _kernel_counters()
    out = {}
    for name, csr, v, kw in (("road", road, v_road, {}), ("block", block, v_block,
                                                          {"format": "bsr"})):
        repro_torch.session_cache_clear()
        for fn in counters.values():
            fn.launches = 0
        ShardComm.reset_calls()
        res = repro_torch.eigsh(csr, k, backend="distributed", v0=v, device="cuda", **kw)
        out[name] = {"eigenvalues": res.eigenvalues.cpu(), "eigenvectors": res.eigenvectors.cpu(),
                     "spmv_format": res.spmv_format, "calls": dict(ShardComm.calls),
                     "launches": {n: fn.launches for n, fn in counters.items()}}
    mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("data",))
    x = torch.from_numpy(v_road).to(device="cuda", dtype=torch.float32)
    for staging in ("f32", "bf16"):
        eng = keng.make_engine(road, "ell", accum_dtype=torch.float64, allowed=("coo", "ell"),
                               storage_dtype=torch.float32, device="cuda")
        ops = {tag: ChunkedOperator(road, chunk_nnz=1 << 14, engine=eng, staging=staging,
                                    device="cuda", mesh=m)
               for tag, m in (("sharded", mesh), ("plain", None))}
        for fn in counters.values():
            fn.launches = 0
        y = ops["sharded"].matvec(x, accum_dtype=torch.float64).cpu()
        out["chunk_" + staging] = {
            "sharded": y, "chunks": ops["sharded"].num_chunks,
            "launches": {n: fn.launches for n, fn in counters.items()},
            "plain": ops["plain"].matvec(x, accum_dtype=torch.float64).cpu(),
        }
    return out
