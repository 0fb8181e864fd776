"""How ``eigsh_many`` keys a query's start vector: a call groups its ``v0``
queries by a byte-wise comparison where the vectors live, and takes the
host digest ``v0:<blake2b>`` only where a key leaves the call (a
checkpoint token, a reseed trail's ``"from"``).

Against the reference, which keys every ``v0`` by the blake2b of
``np.asarray(v0).tobytes()``: the same classes of starts, the same sweep
counts and ``amortized_over``, the same trail.  Counts are compared
exactly; nothing here compares floating-point values.
"""

import hashlib

import numpy as np
import pytest
import torch

import repro
from repro.api import EigQuery as JaxQuery
from repro.sparse import generate as jax_generate
from repro.testing import faults as jfaults
import repro_torch
from repro_torch.api import EigQuery
from repro_torch.api import session as port_session
from repro_torch.core import trace
from repro_torch.serving import SolveCheckpoint
from repro_torch.sparse import CSR
from repro_torch.testing import faults

K = 4
ITERS = 16
BACKENDS = {"single": {"num_iters": ITERS}, "restarted": {"tol": 1e-6, "subspace": 12}}


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.reset()
    jfaults.reset()
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()
    yield
    faults.reset()
    jfaults.reset()
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()


@pytest.fixture(scope="module")
def web_ref():
    return jax_generate("web", 384, 6.0, seed=7, values="normalized")


@pytest.fixture(scope="module")
def web(web_ref):
    c = web_ref
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.fixture(scope="module")
def v(web_ref):
    return np.random.default_rng(5).standard_normal(web_ref.n)


def _digest_key(v0) -> str:
    """The digest key of a ``v0`` (the reference's start key), computed
    here from its host bytes."""
    host = v0.numpy() if isinstance(v0, torch.Tensor) else np.asarray(v0)
    return f"v0:{hashlib.blake2b(host.tobytes(), digest_size=8).hexdigest()}"


def _classes(keys):
    seen = {}
    for i, key in enumerate(keys):
        seen.setdefault(key, []).append(i)
    return sorted(seen.values())


def _port_classes(sess, starts):
    normal = [sess._normalize(EigQuery(k=K, num_iters=ITERS, v0=s), i, sess.cfg)
              for i, s in enumerate(starts)]
    return _classes([q.start_key for q in port_session._key_starts(normal)])


def _ref_classes(sess, starts):
    return _classes([sess._normalize(JaxQuery(k=K, num_iters=ITERS, v0=np.asarray(s)), i,
                                     sess.cfg).start_key for i, s in enumerate(starts)])


def _both(web, web_ref, starts, **kw):
    """(port session, its results, reference session, its results) of one
    call with a query on each start."""
    got_sess = repro_torch.prepare(web, device="cpu")
    want_sess = repro.prepare(web_ref)
    got = got_sess.eigsh_many([EigQuery(k=K, v0=s, **kw) for s in starts])
    want = want_sess.eigsh_many([JaxQuery(k=K, v0=np.asarray(s), **kw) for s in starts])
    return got_sess, got, want_sess, want


def _neighbours(v, case):
    """Two start vectors that differ in one element's bytes alone."""
    a, b = v.copy(), v.copy()
    if case == "signed_zero":
        a[7], b[7] = 0.0, -0.0
    else:  # two quiet NaNs with other payloads
        a.view(np.uint64)[7] = 0x7FF8000000000001
        b.view(np.uint64)[7] = 0x7FF8000000000002
    return a, b


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_equal_bytes_share_one_sweep(web, web_ref, v, backend):
    """Two distinct objects with the same bytes: one start, one sweep, in
    both packages, found by one comparison."""
    got_sess, got, want_sess, want = _both(web, web_ref, [v, v.copy()], **BACKENDS[backend])
    assert got_sess.stats["sweeps"] == want_sess.stats["sweeps"] == 1
    for g, w in zip(got, want):
        assert g.timings["amortized_over"] == w.timings["amortized_over"] == 2.0
        assert g.timings["start_compares"] == 1.0 and g.timings["v0_digests"] == 0.0
    assert torch.equal(got[0].eigenvalues, got[1].eigenvalues)


@pytest.mark.parametrize("case", ["signed_zero", "nan_payload"])
def test_one_differing_byte_keeps_starts_apart(web, web_ref, v, case):
    """0.0 against -0.0, and two NaN payloads, in one element: equal as
    numbers or both NaN, but other bytes, so other starts, as the
    reference's digest keys them."""
    starts = _neighbours(v, case)
    got_sess, want_sess = repro_torch.prepare(web, device="cpu"), repro.prepare(web_ref)
    assert _port_classes(got_sess, starts) == _ref_classes(want_sess, starts) == [[0], [1]]
    if case == "signed_zero":  # finite starts: solve them too
        got_sess, got, want_sess, want = _both(web, web_ref, starts, num_iters=ITERS)
        assert got_sess.stats["sweeps"] == want_sess.stats["sweeps"] == 2
        assert all("amortized_over" not in r.timings for r in got + want)
        assert got[0].timings["start_compares"] == 1.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_array_and_tensor_group_by_bytes(web, web_ref, v, dtype):
    """A NumPy ``v0`` and a CPU tensor group together exactly when their
    bytes match, as the reference's digest of their host bytes grouped
    them: an f64 tensor of the same values does, an f32 one does not."""
    t = torch.from_numpy(v.copy()).to(dtype)
    got_sess = repro_torch.prepare(web, device="cpu")
    want_sess = repro.prepare(web_ref)
    want_classes = [[0, 1]] if dtype == torch.float64 else [[0], [1]]
    assert _port_classes(got_sess, [v, t]) == _ref_classes(want_sess, [v, t.numpy()]) \
        == want_classes
    got = got_sess.eigsh_many([EigQuery(k=K, num_iters=ITERS, v0=s) for s in (v, t)])
    assert got_sess.stats["sweeps"] == len(want_classes)
    assert got[0].timings["start_compares"] == (1.0 if dtype == torch.float64 else 0.0)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_lone_v0_is_neither_read_nor_hashed(web, v, backend, monkeypatch):
    """One ``v0`` in a call: no comparison, no digest, no ``v0_digest_s``;
    the same object twice: no comparison either."""
    sess = repro_torch.prepare(web, device="cpu")

    def forbidden(_):
        raise AssertionError("a lone v0 was read for its bytes")

    monkeypatch.setattr(port_session, "_start_bytes", forbidden)
    t = sess.eigsh(K, v0=v, **BACKENDS[backend]).timings
    assert (t["start_compares"], t["v0_digests"]) == (0.0, 0.0)
    assert "v0_digest_s" not in t
    same = sess.eigsh_many([EigQuery(k=K, v0=v, **BACKENDS[backend]),
                            EigQuery(k=2, v0=v, **BACKENDS[backend])])
    assert [r.timings["amortized_over"] for r in same] == [2.0, 2.0]
    assert same[0].timings["start_compares"] == 0.0


def test_group_key_takes_no_digest(web, web_ref, v, monkeypatch):
    """``group_key`` (the serving scheduler's admission check) neither
    copies nor hashes a ``v0``, and groups as the reference's does."""
    sess = repro_torch.prepare(web, device="cpu")
    want_sess = repro.prepare(web_ref)

    def forbidden(_):
        raise AssertionError("group_key read a v0")

    monkeypatch.setattr(port_session, "_host_array", forbidden)
    monkeypatch.setattr(port_session, "_start_bytes", forbidden)
    queries = [{"k": K, "num_iters": ITERS, "v0": v}, {"k": 2, "num_iters": ITERS, "v0": -v},
               {"k": K, "num_iters": ITERS, "v0": v, "policy": "FFF"}]
    record = {}
    with trace.counting(record):
        keys = [sess.group_key(q) for q in queries]
    assert record == {}
    assert _classes(keys) == _classes([want_sess.group_key(q) for q in queries]) == [[0, 1], [2]]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_checkpoint_token_names_the_digest(web, v, tmp_path, as_tensor):
    """A checkpointed sweep's token names its start by the digest key, so a
    snapshot written before starts were compared in place resumes: the
    crash leaves the token built from ``v0:<blake2b>``, and the resumed
    solve has the bits of an uninterrupted one."""
    v0 = torch.from_numpy(v.copy()) if as_tensor else v
    kw = dict(policy="FDF", backend="restarted", tol=1e-10, subspace=16, v0=v0)
    want = repro_torch.eigsh(web, K, device="cpu", **kw)
    repro_torch.session_cache_clear()
    with faults.inject("solve_crash@cycle=1"):
        with pytest.raises(faults.InjectedCrash):
            repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    sess = repro_torch.prepare(web, device="cpu", checkpoint_dir=str(tmp_path), policy="FDF",
                               backend="restarted")
    q = sess._normalize(EigQuery(k=K, tol=1e-10, subspace=16, v0=v0), 0, sess.cfg)
    token = SolveCheckpoint.token(
        sess.ensure_fingerprint(), backend="restarted", policy="FDF", k=K, m=16,
        start=_digest_key(v0), tol=q.tol_eff, reorth=q.reorth, package="repro_torch")
    assert SolveCheckpoint(str(tmp_path)).entries() == [token]
    repro_torch.session_cache_clear()
    got = repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert got.timings["v0_digests"] == 1.0 and got.timings["v0_digest_s"] > 0


def test_reseed_trail_names_the_digest(web, web_ref, v):
    """``recovery="auto"`` reseeding away from a ``v0`` writes the digest
    key in ``"from"``, the reference's string."""
    with faults.inject("beta_collapse@iter=2"):
        got = repro_torch.eigsh(web, K, device="cpu", num_iters=ITERS, recovery="auto", v0=v)
    with jfaults.inject("beta_collapse@iter=2"):
        want = repro.eigsh(web_ref, K, num_iters=ITERS, recovery="auto", v0=v)
    trail = [(t["action"], t["from"], t["to"]) for t in got.recovery_trail]
    assert trail == [(t["action"], t["from"], t["to"]) for t in want.recovery_trail]
    assert trail == [("reseed", _digest_key(v), "seed:1000")]
    assert got.timings["v0_digests"] == 1.0 and got.timings["v0_digest_s"] > 0
