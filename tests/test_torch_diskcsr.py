"""The port's diskcsr reader and writer against the reference's.

Both packages write the same directory format (``header.json`` plus three
``.npy`` arrays), so each must open the other's directories and see the same
matrix, bit for bit.  bf16 payloads are 2-byte words the port decodes
without ``ml_dtypes``; the reference cannot read its own bf16 payloads back
(``np.load`` gives it raw ``|V2`` words too), so for bf16 the check is the
reverse one: the port writes the same words the reference writes.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.sparse import generate
from repro.sparse import open_diskcsr as jax_open
from repro.sparse import save_diskcsr as jax_save
from repro_torch.sparse import CSR, DiskCSR, is_diskcsr, open_diskcsr, save_diskcsr


@pytest.fixture(scope="module")
def web():
    return generate("web", 384, 6.0, seed=7, values="normalized")


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


def _words(path) -> np.ndarray:
    """The data payload of a diskcsr directory as raw 2-byte words."""
    return np.load(path / "data.npy").view(np.uint16)


def test_roundtrip_stays_a_mapping(web, tmp_path):
    path = save_diskcsr(tmp_path / "m", _port_csr(web))
    assert is_diskcsr(path) and not is_diskcsr(tmp_path) and not is_diskcsr(42)
    disk = open_diskcsr(path)
    assert isinstance(disk.data, np.memmap) and isinstance(disk.indices, np.memmap)
    assert disk.n == web.n and disk.nnz == web.nnz and disk.shape == web.shape
    back = disk.to_csr()
    np.testing.assert_array_equal(back.indptr, web.indptr)
    np.testing.assert_array_equal(back.indices, web.indices)
    np.testing.assert_array_equal(back.data, web.data)
    np.testing.assert_array_equal(disk.row_nnz(), web.row_nnz())
    np.testing.assert_array_equal(disk.values(10, 50), web.data[10:50])


def test_open_rejects_other_dirs(tmp_path):
    with pytest.raises(FileNotFoundError, match="diskcsr"):
        open_diskcsr(tmp_path)
    (tmp_path / "header.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="header"):
        open_diskcsr(tmp_path)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, ml_dtypes.bfloat16])
def test_port_opens_reference_directories(web, tmp_path, dtype):
    jax_save(str(tmp_path / "m"), web, data_dtype=dtype)
    disk = open_diskcsr(tmp_path / "m")
    ref = jax_open(tmp_path / "m")
    assert disk.data_dtype == np.dtype(dtype).name == ref.header["data_dtype"]
    assert disk.nbytes_on_disk() == ref.nbytes_on_disk()
    want = np.asarray(web.data).astype(dtype).astype(np.float64)
    np.testing.assert_array_equal(disk.to_csr().data, want)  # bf16 decoded exactly
    np.testing.assert_array_equal(disk.to_csr().indptr, ref.indptr)


@pytest.mark.parametrize("dtype", [None, np.float32])
def test_reference_opens_port_directories(web, tmp_path, dtype):
    save_diskcsr(tmp_path / "m", _port_csr(web), data_dtype=dtype)
    ref = jax_open(tmp_path / "m").to_csr()
    np.testing.assert_array_equal(ref.indptr, web.indptr)
    np.testing.assert_array_equal(ref.indices, web.indices)
    want = np.asarray(web.data) if dtype is None else np.asarray(web.data).astype(dtype)
    np.testing.assert_array_equal(ref.data, want.astype(np.float64))


def test_bf16_payload_words_equal_the_reference(web, tmp_path):
    jax_save(str(tmp_path / "ref"), web, data_dtype=ml_dtypes.bfloat16)
    save_diskcsr(tmp_path / "port", _port_csr(web), data_dtype=torch.bfloat16)
    np.testing.assert_array_equal(_words(tmp_path / "port"), _words(tmp_path / "ref"))
    hdr = json.loads((tmp_path / "port" / "header.json").read_text())
    assert hdr == json.loads((tmp_path / "ref" / "header.json").read_text())
    # A copy of a bf16 mapping keeps its words.
    save_diskcsr(tmp_path / "copy", open_diskcsr(tmp_path / "port"))
    np.testing.assert_array_equal(_words(tmp_path / "copy"), _words(tmp_path / "ref"))
    assert isinstance(open_diskcsr(tmp_path / "copy"), DiskCSR)
