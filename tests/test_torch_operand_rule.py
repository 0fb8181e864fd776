"""The kernel wrappers' operand rule (``repro_torch.kernels.ops.conform``)
against the reference, on the CPU.

Each case makes its inputs from a seed with numpy and runs them through the
reference (``repro``: the formats' ``matvec`` and ``repro.kernels.ops``, its
Pallas kernels in interpret mode, as its own tests run them) and through the
port on the host: vectors in a dtype the kernel does not pair with the
stored values (f64, bf16 and f16 over f32 storage), operands of mixed
dtypes, a strided ``x`` (a column of an ``(n, 2)`` array) and ``buf[1:]``.

Tolerances: rel 1e-12 of max |y| under f64 accumulation; under f32 an f32
sum-order bound of 1e-5 of max |y| (the arithmetic is the same, the sums
run in another order).  Dots against the sum of |a_i b_i|, the scale of
their rounding; ``u`` of the Lanczos update allows one rounding of its
dtype on top.  The rest of the file holds the rule's own promises: an
operand that fits is passed on as the same object, a foreign one is cast
once to the accum dtype, and the op counter records the same on both
paths.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.spmv_ell_packed import pack_ell_chunk as jax_pack_ell_chunk
from repro.sparse import generate, to_device_bsr, to_device_ell
from repro.sparse.formats import to_device_hybrid
from repro_torch.analysis.op_count import measure
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.spmv_bsr import bsr_x_bytes, spmv_bsr_kernel_call
from repro_torch.kernels.spmv_ell import spmv_ell_kernel_call
from repro_torch.sparse.formats import from_reference

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# name -> (jax dtype, torch dtype)
DTYPES = {
    "f64": (jnp.float64, torch.float64),
    "f32": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "f16": (jnp.float16, torch.float16),
}
ACCS = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
FORMATS = ("ell", "hybrid", "bsr4", "bsr8", "bsr16")
LAYOUTS = ("contiguous", "strided", "offset")
N = 512


def _t(a_jax) -> torch.Tensor:
    """A reference array as a CPU tensor (bf16 bits carried over exactly)."""
    a = np.asarray(a_jax)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _laid_out(x: torch.Tensor, layout: str) -> torch.Tensor:
    """``x``'s values as a contiguous tensor, a column of an ``(n, 2)``
    tensor, or ``buf[1:]`` of a buffer one element longer."""
    if layout == "strided":
        out = torch.stack([x, torch.zeros_like(x)], 1)[:, 0]
        assert not out.is_contiguous()
    elif layout == "offset":
        buf = torch.zeros(x.shape[0] + 1, dtype=x.dtype)
        buf[1:] = x
        out = buf[1:]
        assert out.storage_offset() == 1
    else:
        out = x.clone()
    assert torch.equal(out, x)
    return out


def _close(got: torch.Tensor, want, rtol: float, scale=None) -> None:
    want = np.asarray(want, dtype=np.float64)
    got = got.double().numpy()
    s = max(float(np.abs(want).max()) if scale is None else float(scale), 1e-300)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * s)


@functools.lru_cache(maxsize=None)
def _csr():
    return generate("road", N, 2.1, seed=3)


@functools.lru_cache(maxsize=None)
def _reference_format(fmt: str):
    csr = _csr()
    if fmt == "ell":
        return to_device_ell(csr, dtype=jnp.float32)
    if fmt == "hybrid":  # a cap of 2: most rows spill into the tail
        return to_device_hybrid(csr, dtype=jnp.float32, width_cap=2)
    return to_device_bsr(csr, block_size=int(fmt[3:]), dtype=jnp.float32)


def _x(dt: str, seed: int = 11):
    jdt, _ = DTYPES[dt]
    return jnp.asarray(np.random.default_rng(seed).standard_normal(_csr().n) * 3.0, dtype=jdt)


@functools.lru_cache(maxsize=None)
def _reference_matvec(fmt: str, dt: str, acc: str) -> np.ndarray:
    return np.asarray(_reference_format(fmt).matvec(_x(dt), accum_dtype=ACCS[acc][0]),
                      dtype=np.float64)


def _port_format(fmt: str):
    ref_mat = _reference_format(fmt)
    arrays = {f.name: np.asarray(getattr(ref_mat, f.name)) for f in dataclasses.fields(ref_mat)}
    return from_reference(arrays, device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("acc", list(ACCS))
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_format_matvec_takes_the_reference_vectors(fmt, dt, acc, layout):
    """``DeviceELL``, ``DeviceHybrid`` and ``DeviceBSR`` ``.matvec`` over
    f32 storage take every ``x`` the reference's take: f64, f32, bf16 and
    f16, contiguous, strided or one element into its buffer."""
    tacc = ACCS[acc][1]
    x = _laid_out(_t(_x(dt)), layout)
    got = _port_format(fmt).matvec(x, accum_dtype=tacc)
    assert got.dtype == tacc
    _close(got, _reference_matvec(fmt, dt, acc), RTOL[tacc])


@pytest.mark.parametrize("acc", list(ACCS))
@pytest.mark.parametrize("da,db", [("f32", "f64"), ("f32", "bf16"), ("bf16", "f16"),
                                   ("f64", "f16")])
@pytest.mark.parametrize("compensated", [False, True])
def test_mixed_dot_takes_mixed_operands(da, db, acc, compensated):
    jacc, tacc = ACCS[acc]
    rng = np.random.default_rng(5)
    n = 3 * 4096 + 17
    a_j = jnp.asarray(rng.standard_normal(n) * 3.0, dtype=DTYPES[da][0])
    b_j = jnp.asarray(rng.standard_normal(n) * 3.0, dtype=DTYPES[db][0])
    want = float(jax_ops.mixed_dot(a_j, b_j, accum_dtype=jacc, compensated=compensated,
                                   interpret=True))
    got = ops.mixed_dot(_t(a_j), _t(b_j), accum_dtype=tacc, compensated=compensated)
    assert got.dtype == tacc and got.dim() == 0
    terms = float(np.sum(np.abs(np.asarray(a_j, np.float64) * np.asarray(b_j, np.float64))))
    assert abs(float(got) - want) <= RTOL[tacc] * terms


UPDATE_DTYPES = [("f32", "f64", "f64"), ("f64", "f32", "bf16"), ("bf16", "f32", "f32"),
                 ("f32", "f16", "f32"), ("f64", "f64", "f64")]


def _update_operands(dts, n, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(n) * s, dtype=DTYPES[d][0])
            for d, s in zip(dts, (2.0, 1.0, 0.5))]


def _close_update(u, nrm, u_want, nrm_want, w_dtype, tacc):
    assert u.dtype == w_dtype and nrm.dtype == tacc
    _close(u, u_want, max(RTOL[tacc], float(torch.finfo(w_dtype).eps)))
    _close(nrm.reshape(1), np.reshape(nrm_want, 1), RTOL[tacc])


@pytest.mark.parametrize("acc", list(ACCS))
@pytest.mark.parametrize("dts", UPDATE_DTYPES, ids="-".join)
def test_lanczos_update_takes_mixed_operands(dts, acc):
    """``u = w - alpha v - beta v_prev`` and ``||u||^2`` with ``w``, ``v``
    and ``v_prev`` in mixed dtypes (and, last, all f64 under f32
    accumulation, a pair no kernel has): ``u`` in ``w``'s dtype."""
    jacc, tacc = ACCS[acc]
    w_j, v_j, p_j = _update_operands(dts, 5001, seed=7)
    a, b = 0.37, 1.21
    u_want, nrm_want = jax_ops.lanczos_update(w_j, v_j, p_j, jnp.asarray(a, jacc),
                                              jnp.asarray(b, jacc), accum_dtype=jacc,
                                              interpret=True)
    u, nrm = ops.lanczos_update(_t(w_j), _t(v_j), _t(p_j), torch.tensor(a, dtype=tacc),
                                torch.tensor(b, dtype=tacc), accum_dtype=tacc)
    _close_update(u, nrm, u_want, nrm_want, DTYPES[dts[0]][1], tacc)


@pytest.mark.parametrize("acc", list(ACCS))
@pytest.mark.parametrize("dts", UPDATE_DTYPES, ids="-".join)
def test_lanczos_update_multi_takes_mixed_operands(dts, acc):
    """The batched update on ``(3, n)`` rows of mixed dtypes: row s is the
    reference's update of row s."""
    jacc, tacc = ACCS[acc]
    rows = [_update_operands(dts, 1000, seed=20 + s) for s in range(3)]
    al, be = np.array([0.3, -1.1, 2.0]), np.array([0.5, 0.25, 1.5])
    w, v, p = (torch.stack([_t(r[i]) for r in rows]) for i in range(3))
    u, nrm = ops.lanczos_update_multi(w, v, p, torch.tensor(al, dtype=tacc),
                                      torch.tensor(be, dtype=tacc), accum_dtype=tacc)
    assert u.shape == w.shape and nrm.shape == (3,)
    for s, (w_j, v_j, p_j) in enumerate(rows):
        u_want, nrm_want = jax_ops.lanczos_update(w_j, v_j, p_j, jnp.asarray(al[s], jacc),
                                                  jnp.asarray(be[s], jacc), accum_dtype=jacc,
                                                  interpret=True)
        _close_update(u[s], nrm[s], u_want, nrm_want, DTYPES[dts[0]][1], tacc)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("acc", list(ACCS))
def test_spmv_ell_alpha_takes_an_f64_x(acc, layout):
    """The fused SpMV + alpha over f32 storage with an f64 ``x``."""
    jacc, tacc = ACCS[acc]
    mat_j = _reference_format("ell")
    n = _csr().n
    x_j = _x("f64")
    v_j = jnp.asarray(np.random.default_rng(12).standard_normal(n), dtype=jacc)
    w_want, a_want = jax_ops.spmv_ell_alpha(mat_j, x_j, v_j, accum_dtype=jacc, interpret=True)
    w, alpha = ops.spmv_ell_alpha(_port_format("ell"), _laid_out(_t(x_j), layout), _t(v_j),
                                  accum_dtype=tacc)
    assert w.dtype == alpha.dtype == tacc
    _close(w, w_want, RTOL[tacc])
    terms = float(np.sum(np.abs(np.asarray(v_j, np.float64) * np.asarray(w_want, np.float64))))
    _close(alpha.reshape(1), np.reshape(a_want, 1), RTOL[tacc], scale=terms)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("acc", list(ACCS))
@pytest.mark.parametrize("mode", ["bf16", "fp8"])
def test_spmv_ell_packed_takes_an_f64_x(mode, acc, layout):
    """A packed chunk (the first 64 rows of the road ELL) with an f64 ``x``:
    under f32 accumulation no kernel pairs it, so the rule widens it."""
    jacc, tacc = ACCS[acc]
    ell = _reference_format("ell")
    val, col = np.asarray(ell.val)[:64], np.asarray(ell.col)[:64]
    packed_j = jax_pack_ell_chunk(val, col, mode)
    x_j = _x("f64")
    want = jax_ops.spmv_ell_packed(*packed_j, x_j, 64, accum_dtype=jacc, interpret=True)
    packed = [torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(torch.float8_e4m3fn)
              if np.asarray(a).dtype.name == "float8_e4m3fn" else _t(a) for a in packed_j]
    got = ops.spmv_ell_packed(*packed, _laid_out(_t(x_j), layout), 64, accum_dtype=tacc)
    assert got.dtype == tacc
    _close(got, want, RTOL[tacc])


def test_bsr_matvec_takes_an_f64_x_over_f32_storage():
    """The fault the rule repairs: an f64 ``x`` over f32 storage raised in
    ``DeviceBSR.matvec``; the length check stays."""
    mat = _port_format("bsr8")
    y = mat.matvec(_t(_x("f64")), accum_dtype=torch.float64)
    _close(y, _reference_matvec("bsr8", "f64", "f64"), RTOL[torch.float64])
    with pytest.raises(ValueError, match="whole 8-blocks"):
        ops.bsr_matvec(mat.val, mat.bcol, torch.zeros(mat.n_cols + 1, dtype=torch.float64),
                       torch.float64, mat.n_cols)


# --------------------------------------------------------- the rule itself


def test_an_operand_that_fits_is_the_same_object(monkeypatch):
    """On both paths an operand in the kernel's dtype, contiguous and
    aligned, comes back from the rule as the same object; on the card's
    path a strided one is copied contiguous and one below its alignment
    into a fresh, aligned allocation with the same values."""
    t = torch.arange(64, dtype=torch.float32)
    for cpu in (True, False):
        monkeypatch.setattr(ops, "on_cpu", lambda _t, cpu=cpu: cpu)
        assert ops.conform(t) is t
        assert ops.conform(t, torch.float32) is t
        assert ops.conform(t, torch.float32, align=16) is t
    strided = torch.stack([t, t], 1)[:, 0]
    offset = t[1:]
    assert offset.data_ptr() % 16
    monkeypatch.setattr(ops, "on_cpu", lambda _t: True)
    assert ops.conform(strided) is strided  # the host's plain versions take any layout
    assert ops.conform(offset, align=16) is offset
    monkeypatch.setattr(ops, "on_cpu", lambda _t: False)
    got = ops.conform(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    got = ops.conform(offset, align=16)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, offset)
    got = ops.conform(strided, torch.float64)
    assert got.dtype == torch.float64 and got.is_contiguous() and torch.equal(got, strided.double())


@pytest.mark.parametrize("dt,acc,want", [
    (torch.float32, torch.float64, torch.float32),   # the storage dtype: passed on
    (torch.float64, torch.float64, torch.float64),   # the accum dtype: the <S, A, A> kernel
    (torch.float64, torch.float32, torch.float32),   # neither: to the accum dtype
    (torch.float16, torch.float64, torch.float64),
    (torch.bfloat16, torch.float32, torch.float32),
])
def test_the_card_path_hands_the_kernels_a_dtype_they_take(dt, acc, want, monkeypatch):
    """On the card's path (``on_cpu`` False, the kernel calls swapped for
    recorders) each gathering wrapper hands its kernel ``x`` in the storage
    dtype or the accum dtype, the vector wrappers one shared dtype; an
    ``x`` that already fits reaches the kernel as the same object."""
    seen = {}

    def recorder(name, result):
        def call(*args, **kw):
            seen[name] = args
            return result(*args, **kw)
        return call

    monkeypatch.setattr(ops, "on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "spmv_ell_kernel_call", recorder(
        "ell", lambda val, col, x, accum_dtype: ref.spmv_ell_ref(val, col, x, accum_dtype)))
    monkeypatch.setattr(ops, "spmv_bsr_kernel_call", recorder(
        "bsr", lambda val, bcol, x, accum_dtype, n_cols: ref.spmv_bsr_ref(val, bcol, x,
                                                                          accum_dtype)))
    monkeypatch.setattr(ops, "lanczos_update_kernel_call", recorder(
        "update", lambda w, v, vp, a, b, accum_dtype: ref.lanczos_update_ref(w, v, vp, a, b,
                                                                             accum_dtype)))
    ell, bsr = _port_format("ell"), _port_format("bsr8")
    x = torch.randn(_csr().n, dtype=torch.float64).to(dt)
    ops.ell_matvec(ell.val, ell.col, x, acc)
    bx = torch.randn(bsr.n_cols, dtype=torch.float64).to(dt)
    ops.bsr_matvec(bsr.val, bsr.bcol, bx, acc, bsr.n_cols)
    assert seen["ell"][2].dtype == want and seen["bsr"][2].dtype == want
    assert (seen["ell"][2] is x) == (dt == want)
    assert seen["ell"][0] is ell.val and seen["bsr"][0] is bsr.val
    w = torch.randn(100, dtype=torch.float64)
    ops.lanczos_update(w.to(dt), w.float(), w, torch.tensor(0.5), torch.tensor(0.5), acc)
    got = {t.dtype for t in seen["update"][:3]}
    assert len(got) == 1 and (next(iter(got)), acc) in ops.PAIRS


def test_kernel_calls_keep_their_refusals(monkeypatch):
    """The kernel calls still refuse an ``x`` in neither the storage nor the
    accum dtype: only the wrappers' rule casts."""
    monkeypatch.setattr(build, "require_cuda", lambda *a: None)
    val, col = torch.zeros(8, 8), torch.zeros(8, 8, dtype=torch.int32)
    with pytest.raises(TypeError, match="neither"):
        spmv_ell_kernel_call(val, col, torch.zeros(8, dtype=torch.float16),
                             accum_dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or torch.float64 vector"):
        spmv_bsr_kernel_call(torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(8, dtype=torch.float16), accum_dtype=torch.float64)
    assert bsr_x_bytes(8, 4) == bsr_x_bytes(4, 4) == 16 and bsr_x_bytes(2, 4) == 8


@pytest.mark.parametrize("dt,acc", [(torch.float16, torch.float64), (torch.float64, torch.float32),
                                    (torch.float32, torch.float64)])
def test_the_op_counter_records_the_same_on_both_paths(dt, acc, monkeypatch):
    """A cast the rule adds is counted once, outside the kernel's scope, on
    the host and on the card's path alike; the contract reads the dtype
    that reaches the kernel (no widening of an ``x`` already widened)."""
    ell = _port_format("ell")
    x = torch.randn(_csr().n, dtype=torch.float64).to(dt)

    def run():
        return ops.ell_matvec(ell.val, ell.col, x, acc)

    _, host = measure(run)
    monkeypatch.setattr(ops, "on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "spmv_ell_kernel_call",
                        lambda val, col, xx, accum_dtype: ref.spmv_ell_ref(val, col, xx,
                                                                           accum_dtype))
    _, card = measure(run)
    assert host.ops_by_dtype() == card.ops_by_dtype()
    assert host.conversion_counts() == card.conversion_counts()
    assert host.cast_elements == card.cast_elements
    name = str(dt).replace("torch.", "")
    casts = {k: v for k, v in host.cast_elements.items() if k[0] == name}
    x_dt = ops.gather_dtype(ell.val, x, acc)
    if x_dt == dt:
        assert casts == {}
    else:
        assert casts == {(name, str(x_dt).replace("torch.", "")): x.numel()}
    assert host.kernels["spmv_ell"]["calls"] == 1
