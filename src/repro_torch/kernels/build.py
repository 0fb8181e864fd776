"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

The six kernel sources and the resource report (``attrs.cu``) compile
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``:
seconds to build, against minutes for an extension that includes PyTorch's
headers.  The build happens at first use, from the sources in this package
only, into ``build/repro_torch_kernels/<hash>/`` at the repository root; the
hash covers the sources and the flags, so an edited source rebuilds and an
unchanged one loads what is there.  The sources compile in parallel (one
``nvcc`` each, all started together) and then link.

Every launch passes its pointers and PyTorch's current stream as
``ctypes.c_void_p``; each C entry returns ``cudaGetLastError()`` after its
launches, and :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "SOURCES",
    "NVCC_FLAGS",
    "BUILD_INFO",
    "build",
    "load",
    "check",
    "dtype_code",
    "index_code",
    "ptr",
    "ptr_or_null",
    "stream_of",
    "require_cuda",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "spmv_ell.cu",
    "lanczos_update.cu",
    "lanczos_fused.cu",
    "spmv_bsr.cu",
    "spmv_ell_packed.cu",
    "mixed_dot.cu",
    "attrs.cu",
)
# --fmad=false: every product is rounded before it is added, as in the plain
# PyTorch versions, so kernel and plain version differ only in sum order.
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)
# Mirror the DT_* codes of csrc/common.cuh: value dtypes, then the index
# dtypes of the packed chunks' column deltas.
_DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.bfloat16: 3,
    torch.float8_e4m3fn: 4,
}
_INDEX_CODES = {torch.int16: 5, torch.int32: 6}

# What the last build() did: seconds, library path, whether it was already
# built, and the compiler's output (register / spill report).
BUILD_INFO: dict = {"seconds": None, "path": None, "cached": None, "log": ""}

_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "repro_spmv_ell": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P]),
    "repro_spmv_ell_alpha": (
        _I, [_I, _I, _I, _P, _P, _P, _P, _L, _P, _P, _L, _P, _L, _I, _I, _I, _I, _P]
    ),
    "repro_lanczos_update": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P]),
    "repro_spmv_bsr": (_I, [_I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P]),
    "repro_spmv_ell_packed": (
        _I, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P]
    ),
    "repro_mixed_dot": (_I, [_I, _I, _P, _P, _P, _P, _L, _I, _I, _P]),
    "repro_update_blocks": (_L, [_L]),
    "repro_kernel_count": (_I, []),
    "repro_kernel_attrs": (_I, [_I, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(_L)]),
    "repro_error_string": (ctypes.c_char_p, [_I]),
}


def _build_root() -> Path:
    # src/repro_torch/kernels/build.py -> the repository root.
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (on PATH or at /usr/local/cuda/bin/nvcc)")
    return found


def _source_key() -> str:
    h = hashlib.blake2b(digest_size=10)
    h.update(repr(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the
    library path.  Fills :data:`BUILD_INFO`."""
    t0 = time.perf_counter()
    out = _build_root() / _source_key()
    lib = out / "librepro_torch_kernels.so"
    if lib.exists():
        log_file = out / "build.log"
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0,
            path=str(lib),
            cached=True,
            log=log_file.read_text() if log_file.exists() else "",
        )
        return lib
    nvcc = _nvcc()
    tmp = out / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = [
        (
            src,
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(tmp / f"{src}.o")],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
        )
        for src in SOURCES
    ]
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src}\n{text}")
        if proc.returncode:
            failed.append(src)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp / lib.name)]
        + [str(tmp / f"{src}.o") for src in SOURCES],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp / lib.name, lib)
    (out / "build.log").write_text(log)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib), cached=False, log=log)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Once it is loaded, a call
    takes no lock."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported an error."""
    if rc:
        msg = load().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): {msg}")


def dtype_code(dt: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dt]
    except KeyError:
        raise TypeError(f"no CUDA kernel instantiation for dtype {dt}") from None


def index_code(dt: torch.dtype) -> int:
    try:
        return _INDEX_CODES[dt]
    except KeyError:
        raise TypeError(f"no CUDA kernel instantiation for index dtype {dt}") from None


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t) -> ctypes.c_void_p:
    """:func:`ptr`, or a null pointer for ``None`` (scratch a path does not use)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on one CUDA device; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all operands must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
