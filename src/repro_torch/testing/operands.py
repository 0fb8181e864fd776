"""Operands the kernel wrappers' rule must take (``kernels/ops.py``:
``conform``), as checks to run on the card.

:func:`rule_cases` gives, for each of the seven wrappers, a call with an
operand in a dtype its kernel does not pair with the others, one with a
strided operand and one with an operand one element into its buffer,
beside the plain version (``kernels.ref``) on the same operands as given.
:func:`run_rule_case` runs one through the wrapper while every plain
version refuses a CUDA tensor, and checks that the wrapper's kernel
launched once and agrees with the plain version.  :func:`gather_bits`
holds the ``<S, X = A, A>`` instantiations of the gathering kernels to the
bits of the ``<S, S, A>`` ones.  ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` phase 2 run them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List

import torch

from .._device import resolve_device

__all__ = ["RTOL", "RuleCase", "RULE_WRAPPERS", "rule_cases", "plain_refuses_cuda",
           "run_rule_case", "gather_bits", "GATHER_TRIPLES"]

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # by accum dtype: sum order only
F32, F64, BF16, F16 = torch.float32, torch.float64, torch.bfloat16, torch.float16
# (storage, accum) pairs with an <S, X = A, A> instantiation in the gathering kernels.
GATHER_TRIPLES = ((F32, F64), (BF16, F32), (F16, F32))
# The wrappers of kernels/ops.py the cases call, by the names the cases carry.
RULE_WRAPPERS = ("ell_matvec", "spmv_ell_alpha", "bsr_matvec BS 4", "bsr_matvec BS 8",
                 "bsr_matvec BS 16", "packed_ell_matvec", "lanczos_update",
                 "lanczos_update_multi", "mixed_dot")


@dataclasses.dataclass
class RuleCase:
    """One wrapper call: ``call()`` through ``kernels.ops``, ``plain()``
    the plain version's answer, each a tuple of tensors; ``kernel`` the
    kernel call whose counter the wrapper advances; ``rtol`` and
    ``scales`` (one a result, None: max |plain|) the tolerance."""

    wrapper: str
    variant: str
    kernel: str
    call: Callable[[], tuple]
    plain: Callable[[], tuple]
    rtol: tuple
    scales: tuple = (None, None)


def _randn(shape, dtype, g, device, scale=1.0):
    return (torch.randn(shape, generator=g, dtype=F64) * scale).to(dtype).to(device)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values as every other element of a buffer twice as long."""
    out = torch.stack([t, torch.zeros_like(t)], -1)[..., 0]
    assert not out.is_contiguous() and torch.equal(out, t)
    return out


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values one element into a buffer: contiguous, with a base
    that no 16-byte vector load takes."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    out = buf[1:].view(t.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 and torch.equal(out, t)
    return out


def _ell(rows, width, n, g, device):
    val = torch.randn(rows, width, generator=g, dtype=F64)
    col = torch.randint(0, n, (rows, width), generator=g, dtype=torch.int32)
    val[::3, width // 2:], col[::3, width // 2:] = 0.0, 0  # zero-padded rows
    return val.to(device), col.to(device)


def rule_cases(device="cuda", seed: int = 0, n: int = 20_011) -> List[RuleCase]:
    """The cases, on ``device``: for ``ell_matvec``, ``spmv_ell_alpha``
    and ``bsr_matvec`` an f16 ``x`` over f32 storage under f64 accumulation
    and an f64 ``x`` over bf16 under f32 (both: the ``<S, X = A, A>``
    kernels), a strided ``x`` and an offset ``x`` (for BSR an offset
    ``val`` too); for ``packed_ell_matvec`` an f64 ``x`` under f32
    accumulation; for the update, its batched launch and the dot, mixed
    dtypes, strided and offset operands.  ``n``: the vectors' length."""
    from ..kernels import ops, ref
    from ..kernels.spmv_ell_packed import pack_ell_chunk

    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    out: List[RuleCase] = []
    x64 = torch.randn(n, generator=g, dtype=F64)
    ell_val, col = _ell(n, 8, n, g, dev)
    gathers = {"dtype": (F32, F16, F64), "dtype-bf16": (BF16, F64, F32),
               "strided": (F32, F32, F64), "offset": (F32, F32, F64)}

    def layout(t, variant):
        return _strided(t) if variant == "strided" else _offset(t) if variant == "offset" else t

    for variant, (S, X, A) in gathers.items():
        val = layout(ell_val.to(S), "offset" if variant == "offset" else "")
        c = layout(col, "offset" if variant == "offset" else "")
        x = layout(x64.to(X).to(dev), variant)
        mat = _device_ell(val, c, n)
        out.append(RuleCase(
            "ell_matvec", variant, "spmv_ell",
            lambda val=val, c=c, x=x, A=A: (ops.ell_matvec(val, c, x, A),),
            lambda val=val, c=c, x=x, A=A: (ref.spmv_ell_ref(val, c, x, A),),
            (RTOL[A],)))
        v = layout(_randn(n, A, g, dev), variant)
        out.append(RuleCase(
            "spmv_ell_alpha", variant, "spmv_ell_alpha",
            lambda mat=mat, x=x, v=v, A=A: ops.spmv_ell_alpha(mat, x, v, A),
            lambda val=val, c=c, x=x, v=v, A=A: ref.spmv_ell_alpha_ref(val, c, x, v, A),
            (RTOL[A], RTOL[A]),
            (None, float((v.double().abs() * ref.spmv_ell_alpha_ref(
                val, c, x, v, A)[0].double().abs()).sum()))))
    for bs in (4, 8, 16):
        nbr = -(-n // bs) // 4
        bval = torch.randn(nbr, 5, bs, bs, generator=g, dtype=F64).to(dev)
        bcol = torch.randint(0, nbr, (nbr, 5), generator=g, dtype=torch.int32).to(dev)
        bx = torch.randn(nbr * bs, generator=g, dtype=F64)
        for variant, (S, X, A) in gathers.items():
            val = layout(bval.to(S), "offset" if variant == "offset" else "")
            x = layout(bx.to(X).to(dev), variant)
            out.append(RuleCase(
                f"bsr_matvec BS {bs}", variant, "spmv_bsr",
                lambda val=val, x=x, A=A, bcol=bcol: (ops.bsr_matvec(val, bcol, x, A),),
                lambda val=val, x=x, A=A, bcol=bcol: (ref.spmv_bsr_ref(val, bcol, x, A),),
                (RTOL[A],)))
    pv, pc = _ell(2048, 8, n, g, "cpu")
    pc = pc.sort(dim=1).values
    packed = [t.to(dev) for t in pack_ell_chunk(pv.float().numpy(), pc.numpy(), "bf16")]
    for variant, (X, A) in {"dtype": (F64, F32), "strided": (F32, F64),
                            "offset": (F32, F64)}.items():
        x = layout(x64.to(X).to(dev), variant)
        out.append(RuleCase(
            "packed_ell_matvec", variant, "spmv_ell_packed",
            lambda x=x, A=A: (ops.packed_ell_matvec(*packed, x, A),),
            lambda x=x, A=A: (ref.spmv_ell_packed_ref(*packed, x, A),),
            (RTOL[A],)))
    b = 3
    for variant, dts in {"dtype": (F32, F64, BF16), "strided": (F64,) * 3,
                         "offset": (F64,) * 3}.items():
        A = F64
        w, v, vp = (layout(_randn(n, dt, g, dev, s), variant) for dt, s in zip(dts, (2.0, 1, .5)))
        al, be = torch.tensor(0.37, dtype=A, device=dev), torch.tensor(1.21, dtype=A, device=dev)
        u_tol = max(RTOL[A], float(torch.finfo(dts[0]).eps))
        out.append(RuleCase(
            "lanczos_update", variant, "lanczos_update",
            lambda w=w, v=v, vp=vp, al=al, be=be: ops.lanczos_update(w, v, vp, al, be, A),
            lambda w=w, v=v, vp=vp, al=al, be=be: ref.lanczos_update_ref(w, v, vp, al, be, A),
            (u_tol, RTOL[A])))
        wm, vm, pm = (layout(_randn((b, n // 4), dt, g, dev, s), variant)
                      for dt, s in zip(dts, (2.0, 1, .5)))
        alm = _randn(b, A, g, dev)
        bem = _randn(b, A, g, dev).abs()
        out.append(RuleCase(
            "lanczos_update_multi", variant, "lanczos_update_multi",
            lambda w=wm, v=vm, vp=pm, al=alm, be=bem: ops.lanczos_update_multi(w, v, vp, al,
                                                                               be, A),
            lambda w=wm, v=vm, vp=pm, al=alm, be=bem: ref.lanczos_update_multi_ref(
                w, v, vp, al, be, A),
            (u_tol, RTOL[A])))
        a_, b_ = (layout(_randn(n, dt, g, dev, 3.0), variant) for dt in dts[:2])
        block = 4096
        out.append(RuleCase(
            "mixed_dot", variant, "mixed_dot",
            lambda a_=a_, b_=b_: (ops.mixed_dot(a_, b_, A),),
            lambda a_=a_, b_=b_: (ref.mixed_dot_ref(*(torch.nn.functional.pad(
                t, (0, (-n) % block)) for t in (a_, b_)), A, block=block).sum(),),
            (RTOL[A],),
            (float((a_.double() * b_.double()).abs().sum()),)))
    return out


def _device_ell(val: torch.Tensor, col: torch.Tensor, n: int):
    """A ``DeviceELL`` over ``val`` and ``col`` as they are (any layout)."""
    from ..sparse.formats import DeviceELL

    return DeviceELL(val=val, col=col, n_rows=n, n_cols=n)


_PLAIN = ("spmv_ell_ref", "spmv_ell_alpha_ref", "lanczos_update_ref", "lanczos_update_multi_ref",
          "spmv_bsr_ref", "spmv_ell_packed_ref", "mixed_dot_ref")


@contextlib.contextmanager
def plain_refuses_cuda():
    """Every plain version in ``kernels.ref`` raises on a CUDA tensor while
    the context is open: a wrapper that reached one on the card fails."""
    from ..kernels import ref

    saved = {name: getattr(ref, name) for name in _PLAIN}

    def guard(name, fn):
        def call(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"kernels.ref.{name} reached with a CUDA tensor")
            return fn(*args, **kw)
        return call

    try:
        for name, fn in saved.items():
            setattr(ref, name, guard(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def _kernel_calls() -> dict:
    from ..kernels import lanczos_fused, lanczos_update, mixed_dot, spmv_bsr, spmv_ell
    from ..kernels import spmv_ell_packed

    return {"spmv_ell": spmv_ell.spmv_ell_kernel_call,
            "spmv_ell_alpha": lanczos_fused.spmv_ell_alpha_kernel_call,
            "spmv_bsr": spmv_bsr.spmv_bsr_kernel_call,
            "spmv_ell_packed": spmv_ell_packed.spmv_ell_packed_kernel_call,
            "lanczos_update": lanczos_update.lanczos_update_kernel_call,
            "lanczos_update_multi": lanczos_update.lanczos_update_multi_kernel_call,
            "mixed_dot": mixed_dot.mixed_dot_kernel_call}


def run_rule_case(case: RuleCase) -> float:
    """Run ``case`` on the card: its kernel launches once, no plain version
    runs, and each result agrees with the plain version's within its
    tolerance.  Returns the largest error over the scale it is held to."""
    want = case.plain()
    fn = _kernel_calls()[case.kernel]
    before = fn.launches
    with plain_refuses_cuda():
        got = case.call()
    if got[0].is_cuda:
        torch.cuda.synchronize()
    what = f"{case.wrapper} ({case.variant})"
    assert fn.launches == before + 1, f"{what}: {fn.launches - before} launches of {case.kernel}"
    worst = 0.0
    for gt, wt, rtol, scale in zip(got, want, case.rtol, case.scales):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape, \
            f"{what}: {gt.dtype} {tuple(gt.shape)} against {wt.dtype} {tuple(wt.shape)}"
        s = float(wt.double().abs().max()) if scale is None else scale
        err = float((gt.double() - wt.double()).abs().max()) / max(s, 1e-300)
        assert err <= rtol, f"{what}: error {err:.3e} of the scale > {rtol:.0e}"
        worst = max(worst, err)
    return worst


def gather_bits(device="cuda", seed: int = 1) -> List[str]:
    """Each ``<S, X = A, A>`` instantiation of ``spmv_ell`` (vector, wide,
    split and scalar paths), ``spmv_ell_alpha`` and ``spmv_bsr`` (BS 4, 8,
    16) on an ``x`` that ``S`` holds exactly, widened to ``A``, gives the bits of
    the ``<S, S, A>`` kernel on that ``x`` in ``S``: the same products in
    the same order.  On the scalar path, whose lanes and order do not
    depend on the element size, also those of ``<A, A, A>`` on
    ``val.to(A)``.  ``spmv_ell_alpha``'s ``w`` is ``spmv_ell``'s ``y`` under
    alpha's plan (alpha never splits).  Returns one line a check."""
    from ..kernels.lanczos_fused import spmv_ell_alpha_kernel_call
    from ..kernels.spmv_bsr import spmv_bsr_kernel_call
    from ..kernels.spmv_ell import (SPLIT_ROWS_PER_SM, ell_launch_plan, lane_plan, sm_count,
                                    spmv_ell_kernel_call)
    from ..kernels.spmv_ell import launch as spmv_ell_launch

    dev = resolve_device(device)
    sms = sm_count(dev) if dev.type == "cuda" else 132  # an H100's, off the card
    g = torch.Generator().manual_seed(seed)
    lines = []

    def same(a, b, what):
        assert torch.equal(a, b), f"{what}: the bits differ"
        lines.append(f"{what}: equal")

    for S, A in GATHER_TRIPLES:
        tag = f"<{str(S)[6:]}, X = {str(A)[6:]}, {str(A)[6:]}>"
        # spmv_ell's vector, wide, split and scalar paths (the wide path needs
        # enough wide rows to fill the card: fewer split)
        for rows, width in ((1003, 8), (SPLIT_ROWS_PER_SM * sms, 520), (251, 1040), (1003, 37)):
            n = 4001
            val, col = _ell(rows, width, n, g, dev)
            val = val.to(S)
            xs = _randn(n, S, g, dev)
            xa = xs.to(A)
            path = ell_launch_plan(width, val.element_size(), True, rows, sms)[1]
            y = spmv_ell_kernel_call(val, col, xa, accum_dtype=A)
            same(y, spmv_ell_kernel_call(val, col, xs, accum_dtype=A),
                 f"spmv_ell {tag} {path} ({rows} x {width})")
            if path == "scalar":
                same(y, spmv_ell_kernel_call(val.to(A), col, xa, accum_dtype=A),
                     f"spmv_ell {tag} scalar against <A, A, A> on val.to(A)")
        # spmv_ell_alpha's vector, wide and scalar paths at 1,003 rows (a grid
        # the rows bound, so every instantiation has the same one): w is
        # spmv_ell's y under the same plan (alpha never splits)
        for width in (8, 520, 37):
            rows, n = 1003, 4001
            val, col = _ell(rows, width, n, g, dev)
            val = val.to(S)
            xs = _randn(n, S, g, dev)
            xa = xs.to(A)
            lanes, path = lane_plan(width, 16 // val.element_size(), True)
            v = _randn(rows - 3, A, g, dev)
            w, alpha = spmv_ell_alpha_kernel_call(val, col, xa, v, accum_dtype=A)
            same(w, spmv_ell_launch(val, col, xa, A, (lanes, path, 0)),
                 f"spmv_ell_alpha {tag} {path}: w")
            same(alpha, spmv_ell_alpha_kernel_call(val, col, xs, v, accum_dtype=A)[1],
                 f"spmv_ell_alpha {tag} {path}: alpha")
        for bs in (4, 8, 16):
            nbr = 301
            bval = _randn((nbr, 5, bs, bs), S, g, dev)
            bcol = torch.randint(0, nbr, (nbr, 5), generator=g, dtype=torch.int32).to(dev)
            xs = _randn(nbr * bs, S, g, dev)
            same(spmv_bsr_kernel_call(bval, bcol, xs.to(A), accum_dtype=A),
                 spmv_bsr_kernel_call(bval, bcol, xs, accum_dtype=A), f"spmv_bsr {tag} BS {bs}")
    torch.cuda.synchronize()
    return lines
