"""The port's public surface against the reference's, and the device rule.

* Every module of ``src/repro`` that has a counterpart in ``src/repro_torch``
  is read as an AST on both sides: every public top-level name, public
  method and parameter of the reference exists in the port, or stands in
  ``BY_DESIGN`` with its reason (the list ROADMAP.md carries), and every
  entry of ``BY_DESIGN`` is still missing, so the list stays exact.
* With no card visible, the public functions that place data raise the
  device resolver's error, and ``python -m repro_torch.analysis`` without
  ``--device`` exits non-zero with it: nothing falls back to the host.
* The device formats' ``matvec`` (and the reference-style
  ``hybrid_matvec`` / ``spmv_bsr`` arguments) agree with the reference's on
  the CPU.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse.formats as jfmt
from repro.sparse import generate as jax_generate

REPO_ROOT = Path(__file__).resolve().parents[1]
REF = REPO_ROOT / "src" / "repro"
PORT = REPO_ROOT / "src" / "repro_torch"

_PYTREE = "JAX pytree registration; the port's containers are dataclasses of tensors"
_INTERPRET = "no interpret mode: a CPU tensor takes the plain version"
_TILES = ("a Pallas tile argument, a TPU layout rule the port excludes; each Hopper kernel "
          "picks its own launch shape")
_KW = "forwards only `interpret=` and the Pallas tile arguments"
_KEY = "`key` -> `gen`: the inits draw from a torch.Generator"
_VMEM = ("the Pallas VMEM budget and lowering checks (rule K003, REPRO_ANALYSIS_VMEM_MB, "
         "REPRO_PALLAS_LOWER_CHECK): the card has no VMEM; K003 reads the built kernels' "
         "resources")
_JAXPR = "the P-rule finders take the conversions and counts a run measured, not a jaxpr"
_XLA = ("an XLA number of the dry-run (HLO text, CPU upcast copies): the port's dry-run runs "
        "each cell eagerly on meta tensors and compiles nothing")

# "module::name" (a missing name) or "module::name(param)" (a missing
# parameter) -> why the port has no counterpart.  ROADMAP.md's "not ported,
# by design" list is this one.
BY_DESIGN = {
    "analysis/jaxpr_tools.py": "renamed: analysis/op_count.py counts executed aten ops",
    **{f"sparse/formats.py::{c}.{m}": _PYTREE
       for c in ("DeviceCOO", "DeviceELL", "DeviceHybrid", "DeviceBSR")
       for m in ("tree_flatten", "tree_unflatten")},
    "models/common.py::Leaf.tree_flatten": _PYTREE,
    "models/common.py::Leaf.tree_unflatten": _PYTREE,
    "core/partition.py::PartitionedMatrix.tree_flatten": _PYTREE,
    "core/partition.py::PartitionedMatrix.tree_unflatten": _PYTREE,
    "core/precision.py::x64_enabled": "torch always has float64",
    "core/operators.py::chunk_rows_pad(storage_dtype)": "the TPU sublane minimums of a chunk",
    "core/operators.py::chunk_rows_pad(row_multiple)": "the TPU sublane minimums of a chunk",
    "kernels/engine.py::select_tiles(n_rows)": "the TPU tile table; Hopper takes the BSR edge",
    "kernels/engine.py::select_tiles(width)": "the TPU tile table; Hopper takes the BSR edge",
    "kernels/engine.py::select_tiles(dtype)": "the TPU tile table; Hopper takes the BSR edge",
    **{f"kernels/engine.py::{f}(interpret)": _INTERPRET
       for f in ("select_tiles", "tuned_tiles", "table_update_mode", "resolve_iteration_plan",
                 "make_engine")},
    "kernels/ops.py::default_interpret": _INTERPRET,
    **{f"kernels/ops.py::{f}(**kw)": _KW
       for f in ("spmv_ell", "spmv_ell_alpha", "spmv_ell_packed", "spmv_bsr", "mixed_dot",
                 "lanczos_update")},
    **{f"kernels/{m}::{f}(interpret)": _INTERPRET
       for m, f in (("spmv_ell.py", "spmv_ell_kernel_call"),
                    ("lanczos_fused.py", "spmv_ell_alpha_kernel_call"),
                    ("lanczos_update.py", "lanczos_update_kernel_call"),
                    ("mixed_dot.py", "mixed_dot_kernel_call"),
                    ("spmv_bsr.py", "spmv_bsr_kernel_call"),
                    ("spmv_ell_packed.py", "spmv_ell_packed_kernel_call"))},
    "kernels/spmv_ell.py::spmv_ell_kernel_call(block_r)": _TILES,
    "kernels/spmv_ell.py::spmv_ell_kernel_call(block_w)": _TILES,
    "kernels/lanczos_fused.py::spmv_ell_alpha_kernel_call(block_r)": _TILES,
    "kernels/lanczos_fused.py::spmv_ell_alpha_kernel_call(block_w)": _TILES,
    "kernels/lanczos_update.py::lanczos_update_kernel_call(block)": _TILES,
    "kernels/spmv_ell_packed.py::spmv_ell_packed_kernel_call(block_r)": _TILES,
    **{f"models/{m}::{f}(key)": _KEY
       for m, f in (("attention.py", "init_attention"), ("common.py", "dense_init"),
                    ("mlp.py", "init_mlp"), ("mlp.py", "init_moe"), ("model.py", "init_model"),
                    ("rglru.py", "init_rglru_block"), ("ssd.py", "init_ssd_block"))},
    "analysis/__init__.py::run_checks(vmem_budget_mb)": _VMEM,
    "analysis/kernel_check.py::run(vmem_budget_mb)": _VMEM,
    **{f"analysis/kernel_check.py::{n}": _VMEM
       for n in ("PARALLEL_DIMS", "vmem_budget_bytes", "pallas_eqns", "check_pallas_eqn",
                 "check_kernel_trace")},
    **{f"analysis/precision_flow.py::{f}(jaxpr)": _JAXPR
       for f in ("find_upcasts", "find_double_rounding", "find_phase_leaks")},
    "launch/dryrun.py::collective_bytes(hlo_text)": _XLA,
    "launch/dryrun.py::cpu_upcast_artifact_bytes": _XLA,
}


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def surface(path: Path, imports: bool = False) -> dict:
    """{public name: parameter names, or None for a class, a variable or an
    import} of one module: top-level defs, classes, their public methods and
    properties, names assigned at top level, ``__all__``, and the names a
    package ``__init__`` (or, with ``imports``, any module) imports.  A def
    wins over a later rebinding."""
    out: dict = {}

    def add(name, params):
        if name.split(".")[-1].startswith("_") and not name.endswith(".__init__"):
            return
        if out.get(name) is not None and params is None:
            return
        out[name] = params

    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(node.name, _params(node))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            add(node.name, None)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(f"{node.name}.{sub.name}", _params(sub))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ([t] if isinstance(t, ast.Name) else getattr(t, "elts", [])):
                    if isinstance(n, ast.Name) and n.id != "__all__":
                        add(n.id, None)
                    elif isinstance(n, ast.Name):
                        for name in ast.literal_eval(node.value):
                            add(name, None)
        elif isinstance(node, ast.ImportFrom) and (imports or path.name == "__init__.py"):
            for alias in node.names:
                add(alias.asname or alias.name, None)
    return out


def missing_from_port(rel: str) -> list:
    """The reference module's names and parameters its counterpart lacks."""
    ref, port = surface(REF / rel), surface(PORT / rel, imports=True)
    out = []
    for name, params in ref.items():
        if name not in port:
            out.append(f"{rel}::{name}")
        elif params is not None and port[name] is not None:
            out += [f"{rel}::{name}({p})" for p in params if p not in port[name]]
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
SHARED = [m for m in REF_MODULES if (PORT / m).exists()]


@pytest.mark.parametrize("rel", SHARED)
def test_public_surface_matches_reference(rel):
    missing = [m for m in missing_from_port(rel) if m not in BY_DESIGN]
    assert not missing, f"missing from src/repro_torch/{rel} and not by design: {missing}"


def test_by_design_list_is_exact():
    """Every by-design entry is still missing (a name ported later leaves the
    list) and has its reason; the only reference file without a counterpart
    is listed."""
    missing = {m for rel in SHARED for m in missing_from_port(rel)}
    unshared = {m for m in REF_MODULES if m not in SHARED}
    stale = [k for k in BY_DESIGN if k not in missing and k not in unshared]
    assert not stale, f"ported now, drop from BY_DESIGN and ROADMAP.md: {stale}"
    assert unshared <= set(BY_DESIGN), unshared - set(BY_DESIGN)
    assert all(isinstance(r, str) and r for r in BY_DESIGN.values())


# ---------------------------------------------------------- the device rule


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _placements():
    """One call per public function that places data, with no device."""
    from repro_torch.analysis import kernel_check, resolve_device
    from repro_torch.api.coerce import coerce_input
    from repro_torch.configs import get_config
    from repro_torch.core.operators import CallableOperator
    from repro_torch.core.partition import partition_matrix
    from repro_torch.models import attention, rglru, ssd
    from repro_torch.models.common import make_positions
    from repro_torch.models.model import params_from_numpy
    from repro_torch.sparse import formats as tfmt
    from repro_torch.sparse import generate
    from repro_torch.training import DataConfig, data_stream, synthetic_batch

    csr = generate("road", 64, 2.1, seed=0)
    splits = np.array([0, 32, 64])
    qwen = get_config("qwen3-0.6b", smoke=True)
    dc = DataConfig(batch=1, seq_len=4)
    return {
        "to_device_coo": lambda: tfmt.to_device_coo(csr),
        "to_device_ell": lambda: tfmt.to_device_ell(csr),
        "to_device_hybrid": lambda: tfmt.to_device_hybrid(csr),
        "to_device_bsr": lambda: tfmt.to_device_bsr(csr),
        "from_reference": lambda: tfmt.from_reference({"val": np.zeros((8, 8), np.float32),
                                                       "col": np.zeros((8, 8), np.int32)}),
        "shard_to_ell": lambda: tfmt.shard_to_ell(csr, splits, 32),
        "shard_to_blocked_ell": lambda: tfmt.shard_to_blocked_ell(csr, splits, 32),
        "shard_to_hybrid": lambda: tfmt.shard_to_hybrid(csr, splits, 32),
        "coerce_input": lambda: coerce_input(np.eye(4)),
        "CallableOperator": lambda: CallableOperator(fn=lambda x: x, n=4),
        "partition_matrix": lambda: partition_matrix(csr, 2),
        "make_positions": lambda: make_positions(1, 4),
        "params_from_numpy": lambda: params_from_numpy({"w": np.ones(2, np.float32)}),
        "init_cache": lambda: attention.init_cache(qwen, 1, 4),
        "init_rglru_state": lambda: rglru.init_rglru_state(get_config("recurrentgemma-2b",
                                                                      smoke=True), 1),
        "init_ssd_state": lambda: ssd.init_ssd_state(get_config("mamba2-130m", smoke=True), 1),
        "synthetic_batch": lambda: synthetic_batch(qwen, dc, 0),
        "data_stream": lambda: next(data_stream(qwen, dc)),
        "kernel_check.run": lambda: kernel_check.run(),
        "analysis.resolve_device": lambda: resolve_device(None),
    }


PLACEMENTS = ["to_device_coo", "to_device_ell", "to_device_hybrid", "to_device_bsr",
              "from_reference", "shard_to_ell", "shard_to_blocked_ell", "shard_to_hybrid",
              "coerce_input", "CallableOperator", "partition_matrix", "make_positions",
              "params_from_numpy", "init_cache", "init_rglru_state", "init_ssd_state",
              "synthetic_batch", "data_stream", "kernel_check.run", "analysis.resolve_device"]


@pytest.mark.parametrize("name", PLACEMENTS)
def test_public_functions_default_to_the_card(name, monkeypatch):
    """Without a visible card the default raises the resolver's error; the
    same call with ``device="cpu"`` is what the tests make."""
    calls = _placements()
    assert sorted(calls) == sorted(PLACEMENTS)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device is visible; pass device='cpu'"):
        calls[name]()


def test_analysis_cli_without_a_device_fails_loudly():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO_ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--check", "kernels"],
                         cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is visible; pass device='cpu'" in out.stderr
    assert "[kernels]" not in out.stdout  # no pass ran on the host


# ------------------------------------------- ported methods and signatures


def _pair(seed=1):
    ref = jax_generate("web", 1024, 6.0, seed=seed, values="normalized")
    return ref, torch.from_numpy(np.random.default_rng(seed).standard_normal(ref.n))


def _port(container) -> object:
    from repro_torch.sparse import formats as tfmt

    arrays = {f.name: (np.asarray(getattr(container, f.name))
                       if f.name not in ("n_rows", "n_cols") else getattr(container, f.name))
              for f in dataclasses.fields(container)}
    return tfmt.from_reference(arrays, device="cpu")


CONVERT = {
    "ell": lambda c: jfmt.to_device_ell(c, slot_tile=8),
    "hybrid": jfmt.to_device_hybrid,
    "bsr": jfmt.to_device_bsr,
    "coo": jfmt.to_device_coo,
}


@pytest.mark.parametrize("acc", ["storage", "f64"])
@pytest.mark.parametrize("fmt", list(CONVERT))
def test_device_format_matvec_matches_reference(fmt, acc):
    """``DeviceX.matvec(x, accum_dtype)`` of both packages on one container:
    f32 storage, accumulation in the storage dtype (the default) or f64."""
    ref, x = _pair()
    jc = CONVERT[fmt](ref)
    mat = _port(jc)
    jacc, tacc = (None, None) if acc == "storage" else (jnp.float64, torch.float64)
    want = np.asarray(jc.matvec(jnp.asarray(x.numpy(), jnp.float32), accum_dtype=jacc))
    got = mat.matvec(x.to(torch.float32), accum_dtype=tacc)
    assert got.shape == (ref.n,) and got.dtype == (tacc or torch.float32)
    tol = 1e-12 if acc == "f64" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_layout_properties_match_reference():
    ref, _ = _pair()
    coo, hyb, bsr = (_port(jfmt.to_device_coo(ref)), _port(jfmt.to_device_hybrid(ref)),
                     _port(jfmt.to_device_bsr(ref)))
    jhyb, jbsr = jfmt.to_device_hybrid(ref), jfmt.to_device_bsr(ref)
    assert coo.nnz == jfmt.to_device_coo(ref).nnz == ref.nnz
    assert hyb.tail_slots == jhyb.tail_slots
    assert (bsr.block_size, bsr.slots) == (jbsr.block_size, jbsr.slots)
    from repro_torch.sparse import formats as tfmt

    port_csr = tfmt.CSR(indptr=np.asarray(ref.indptr), indices=np.asarray(ref.indices),
                        data=np.asarray(ref.data), shape=ref.shape)
    np.testing.assert_array_equal(port_csr.toarray(), ref.toarray())


def test_reference_style_arguments_match_the_ports_own():
    """``SpmvEngine.hybrid_matvec`` on the reference's arrays, ``ops.spmv_bsr``
    on a ``(val, bcol, n_rows)`` tuple, ``SpmvStats.as_dict`` and
    ``PrecisionPolicy.short``."""
    from repro.core.precision import POLICIES as JPOL
    from repro_torch.core.precision import POLICIES
    from repro_torch.kernels import engine as teng
    from repro_torch.kernels import ops

    ref, x = _pair(2)
    xs = x.to(torch.float32)
    eng = teng.SpmvEngine(format="hybrid", accum_dtype=torch.float64, device="cpu")
    hyb = _port(jfmt.to_device_hybrid(ref))
    got = eng.hybrid_matvec(hyb.ell_val, hyb.ell_col, hyb.tail_row, hyb.tail_col, hyb.tail_val,
                            xs, hyb.n_rows)
    assert torch.equal(got, eng.hybrid_matvec(hyb, xs))
    bsr = _port(jfmt.to_device_bsr(ref))
    assert torch.equal(ops.spmv_bsr((bsr.val, bsr.bcol, bsr.n_rows), xs, torch.float64),
                       ops.spmv_bsr(bsr, xs, torch.float64))
    stats = teng.matrix_stats(
        jfmt.CSR(indptr=ref.indptr, indices=ref.indices, data=ref.data, shape=ref.shape))
    assert stats.as_dict() == dataclasses.asdict(stats)
    assert {n: p.short() for n, p in POLICIES.items()} == {n: p.short() for n, p in JPOL.items()}


def test_analysis_takes_the_references_arguments():
    """``fused=`` spells ``mode``, ``run(modes=)`` picks the update modes,
    ``measure_session_ops`` counts one solve of an operator and
    ``kernel_check.run`` takes the sweep's rows, width and dtypes."""
    from repro_torch.analysis import kernel_check, precision_flow
    from repro_torch.core.eigensolver import solve_fixed
    from repro_torch.core.operators import make_operator
    from repro_torch.core.precision import POLICIES
    from repro_torch.sparse import generate

    kw = dict(n=32, m=4, k=2, device="cpu")
    assert (precision_flow.trace_phases("FFF", fused=True, **kw)
            == precision_flow.trace_phases("FFF", mode="fused", **kw))
    assert precision_flow.run(rungs=["FFF"], engines=["single"], modes=(False,), n=32, m=4,
                              k=2, device="cpu") == []
    op = make_operator(generate("road", 64, 2.1, seed=0), device="cpu")
    counts = precision_flow.measure_session_ops("FDF", op, backend="single", m=4, k=2,
                                                reorth="full")
    _, solved = precision_flow.measure_solve(solve_fixed, op, 2, POLICIES["FDF"], reorth="full",
                                             num_iters=4)
    assert counts == solved and counts["float64"] > 0
    assert kernel_check.run("cpu", rows=960, width=48,
                            dtypes=(torch.float32, torch.bfloat16)) == []
