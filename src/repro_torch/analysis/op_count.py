"""Counting what a run executes, per float dtype: the port's counterpart of
the reference's ``jaxpr_tools.py``.

The reference traces the solver to jaxprs and counts their equations; the
port runs eagerly, so it counts the aten ops a run dispatches, under a
``TorchDispatchMode`` (:class:`OpCounter`).  Two products, as there:

  * element-op counts per float dtype (:func:`count_ops_by_dtype`), with the
    reference's conventions: elementwise arithmetic counts its output size
    in the output dtype; a matmul (``mm``, ``mv``, ``bmm``, ``dot`` and their
    ``add*`` forms) counts its multiply-accumulates (``M * N * K``) in the
    output dtype; a reduction counts its operand size in the operand dtype.
    Conversions, layout ops, selects and integer index arithmetic are not
    "work";
  * every float -> float conversion (``aten._to_copy``, ``aten.to``, a
    dtype-changing ``copy_``) as a :class:`Conversion` ``(src, dst,
    prev_src)`` (:func:`conversions`), where ``prev_src`` is the dtype the
    operand held before the conversion that produced it (tracked per tensor
    through a weak map), the raw material of the double-rounding rule.

**The kernels.**  The six CUDA kernels are loaded through ``ctypes``, so a
dispatch mode sees none of their arithmetic.  Each kernel wrapper
(``kernels/ops.py``) therefore runs inside :func:`kernel_scope`: the aten ops
inside (the plain version on the CPU, the wrapper's allocations on the card)
are hidden from the counter, and the kernel's declared op contract (the
``*_contract`` functions beside each kernel) is recorded instead through
:func:`record_kernel`, once per call.  The same convention on both devices,
so a CPU count and a card count of the same solve are comparable.  The
counterpart of the reference scaling a Pallas body by its grid steps.

**The host.**  Host work of a solve that the reference runs in NumPy, outside
its traces (the f64 staging copies of the host Jacobi, the health probe,
the out-of-core chunk build), runs inside :func:`host_scope`: hidden, and
recorded as nothing.

Counting is per thread (dispatch modes are thread-local), and every hook is
a no-op unless a counter is active on the calling thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

__all__ = [
    "ARITH_OPS",
    "REDUCE_OPS",
    "MATMUL_OPS",
    "Conversion",
    "OpCounter",
    "count_ops_by_dtype",
    "conversions",
    "measure",
    "widened",
    "dtype_name",
    "record_kernel",
    "kernel_scope",
    "host_scope",
]

# Elementwise float arithmetic counted as work (output-size ops), by the
# aten overload packet's name without a trailing "_" (in-place forms).
ARITH_OPS = frozenset(
    {
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn", "sqrt",
        "rsqrt", "exp", "log", "log1p", "expm1", "pow", "reciprocal", "tanh",
        "sigmoid", "atan2", "erf", "square", "maximum", "minimum", "clamp_min",
        "clamp_max", "fmod", "remainder", "addcmul", "addcdiv", "lerp", "hypot",
    }
)
# Reductions counted as operand-size ops in the operand dtype ("max" and
# "min" with one tensor operand; with two they are elementwise).
REDUCE_OPS = frozenset(
    {"sum", "prod", "mean", "amax", "amin", "cumsum", "cumprod", "linalg_vector_norm",
     "norm", "max", "min"}
)
# Matrix products: multiply-accumulates in the output dtype.  The value is
# the position of the left operand among the positional arguments.
MATMUL_OPS = {
    "mm": 0, "mv": 0, "bmm": 0, "dot": 0, "vdot": 0,
    "addmm": 1, "addmv": 1, "baddbmm": 1, "addbmm": 1,
}
_CONVERT_OPS = frozenset({"_to_copy", "to"})


class Conversion(NamedTuple):
    """One float -> float conversion: src -> dst, with the dtype its operand
    held before the conversion that produced it (None if it was not one)."""

    src: str
    dst: str
    prev_src: Optional[str]


def dtype_name(dt: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``."""
    return str(dt).replace("torch.", "")


def widened(dst: torch.dtype, *srcs: torch.dtype) -> List[Conversion]:
    """The conversions of a kernel contract that widens each operand of
    dtype ``srcs[i]`` to ``dst`` in registers (none where they match)."""
    return [Conversion(dtype_name(s), dtype_name(dst), None) for s in srcs if s != dst]


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype.is_floating_point


_TLS = threading.local()


def _active() -> List["OpCounter"]:
    """The counters active on this thread, outermost first."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class OpCounter(TorchDispatchMode):
    """Counts the float arithmetic and conversions the aten ops of a run
    execute (see the module docstring).  Use as a context manager; counters
    nest (each sees every op).

    ``ops`` maps dtype name -> element ops; ``conversions`` lists every
    conversion in order; ``cast_elements`` maps ``(src, dst)`` -> elements
    written by materialized casts (a kernel's in-register widening writes
    none); ``kernels`` maps kernel name -> ``{"calls", "ops",
    "conversions"}`` of the contracts recorded for it.
    """

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}
        self.conversions: List[Conversion] = []
        self.cast_elements: Dict[Tuple[str, str], int] = {}
        self.kernels: Dict[str, dict] = {}
        self._hidden = 0
        self._produced = WeakIdKeyDictionary()  # tensor -> dtype before its conversion

    def __enter__(self):
        _active().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _active().remove(self)

    # -- results -----------------------------------------------------------

    def ops_by_dtype(self) -> Dict[str, int]:
        return {dt: int(n) for dt, n in sorted(self.ops.items()) if n}

    def conversion_counts(self) -> Dict[Tuple[str, str], int]:
        out: Dict[Tuple[str, str], int] = {}
        for cv in self.conversions:
            out[(cv.src, cv.dst)] = out.get((cv.src, cv.dst), 0) + 1
        return out

    # -- recording ---------------------------------------------------------

    def _add(self, dtype: str, n: int) -> None:
        if n:
            self.ops[dtype] = self.ops.get(dtype, 0) + int(n)

    def _convert(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        s, d = dtype_name(src.dtype), dtype_name(dst.dtype)
        self.conversions.append(Conversion(s, d, self._produced.get(src)))
        self._produced[dst] = s
        self.cast_elements[(s, d)] = self.cast_elements.get((s, d), 0) + dst.numel()

    def _record_kernel(self, name: str, ops: Dict[str, int], convs: Iterable[Conversion]) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "ops": {}, "conversions": 0})
        rec["calls"] += 1
        for dt, n in ops.items():
            self._add(dt, n)
            rec["ops"][dt] = rec["ops"].get(dt, 0) + int(n)
        for cv in convs:
            self.conversions.append(cv)
            rec["conversions"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._hidden:
            self._count(func, args, out)
        return out

    def _count(self, func, args, out) -> None:
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.endswith("__"):
            name = name[:-1]  # in-place form
        if name in _CONVERT_OPS:
            src = args[0] if args else None
            if _is_float(src) and _is_float(out) and src.dtype != out.dtype:
                self._convert(src, out)
            return
        if name == "copy":  # copy_(dst, src): a conversion when the dtypes differ
            if len(args) >= 2 and _is_float(args[0]) and _is_float(args[1]) \
                    and args[0].dtype != args[1].dtype:
                self._convert(args[1], args[0])
            return
        res = out[0] if isinstance(out, (tuple, list)) and out else out
        if name in MATMUL_OPS:
            lhs = args[MATMUL_OPS[name]]
            if _is_float(res):
                k = lhs.numel() if name in ("dot", "vdot") else lhs.shape[-1]
                self._add(dtype_name(res.dtype), max(res.numel(), 1) * int(k))
            return
        n_tensors = sum(isinstance(a, torch.Tensor) for a in args)
        if name in REDUCE_OPS and not (name in ("max", "min") and n_tensors >= 2):
            if _is_float(args[0]):
                self._add(dtype_name(args[0].dtype), args[0].numel())
            return
        if name in ARITH_OPS or name in ("max", "min"):
            if _is_float(res):
                self._add(dtype_name(res.dtype), res.numel())


# --------------------------------------------------------------------- hooks


def record_kernel(name: str, ops_by_dtype: Dict[str, int],
                  conversions: Iterable[Conversion] = ()) -> None:
    """Record one call of kernel ``name`` with its declared element ops per
    dtype and conversions, in every counter active on this thread; a no-op
    when none is."""
    convs = tuple(conversions)
    for c in _active():
        c._record_kernel(name, ops_by_dtype, convs)


@contextlib.contextmanager
def _hidden():
    counters = list(_active())
    for c in counters:
        c._hidden += 1
    try:
        yield counters
    finally:
        for c in counters:
            c._hidden -= 1


@contextlib.contextmanager
def kernel_scope(name: str, contract: Callable[[], Tuple[Dict[str, int], list]]):
    """Run one kernel call: its aten ops hidden from the active counters,
    then ``contract()`` (``(ops_by_dtype, conversions)``) recorded through
    :func:`record_kernel`.  ``contract`` is only called when a counter is
    active; nothing is recorded if the call raises."""
    with _hidden() as counters:
        yield
    if counters:
        ops, convs = contract()
        record_kernel(name, ops, convs)


@contextlib.contextmanager
def host_scope():
    """Hide host work (NumPy staging, the host Jacobi's copies) from the
    active counters; it records nothing."""
    with _hidden():
        yield


# ----------------------------------------------------------------- measuring


def measure(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCounter]:
    """``fn(*args, **kwargs)`` under a fresh counter: ``(result, counter)``."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter


def count_ops_by_dtype(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Float element ops per dtype name that ``fn(*args, **kwargs)`` runs."""
    return measure(fn, *args, **kwargs)[1].ops_by_dtype()


def conversions(fn: Callable, *args, **kwargs) -> List[Conversion]:
    """Every float -> float conversion ``fn(*args, **kwargs)`` runs, in order."""
    return list(measure(fn, *args, **kwargs)[1].conversions)
