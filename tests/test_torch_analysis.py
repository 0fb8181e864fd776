"""repro_torch.analysis: one red input per rule, the shipped tree clean, and
the precision sweep held against the reference's.

Structure mirrors ``tests/test_analysis.py``:

  * every rule (P001..P004, K001..K004, C001/C002, E001/E002) has an input
    that fails it;
  * the shipped tree passes every pass (``python -m repro_torch.analysis
    --strict`` exits 0 here, on the CPU);
  * for each (rung, engine, mode) both packages run, where the reference's
    ``check_policy`` is clean, the port's is clean too and every phase's
    dtypes (those carrying >= 2% of its ops) are the same in both;
  * each kernel's declared op contract against the ops its plain version
    runs: the same dtypes, each count within a factor of 2 (a kernel counts
    a multiply and an add a slot; ``spmv_bsr``'s plain version contracts
    through ``einsum``, a matmul that counts one op a multiply-add, so its
    count is exactly half).
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.analysis import precision_flow as ref_flow
from repro.core.precision import POLICIES as REF_POLICIES
from repro_torch.analysis import RULES, Finding, is_suppressed, run_checks
from repro_torch.analysis import (
    concurrency,
    config_lint,
    kernel_check,
    op_count,
    precision_flow,
)
from repro_torch.analysis.findings import filter_suppressed, format_findings
from repro_torch.core.precision import (
    BFF,
    FDF,
    FFF,
    POLICIES,
    assert_phase_count_parity,
    phase_op_counts,
)
from repro_torch.kernels import ops, ref

REPO_ROOT = Path(__file__).resolve().parents[1]
f32, f64, bf16, f16 = torch.float32, torch.float64, torch.bfloat16, torch.float16


@pytest.fixture(autouse=True)
def _fresh_sessions():
    import repro_torch

    repro_torch.session_cache_clear()
    yield
    repro_torch.session_cache_clear()


# ----------------------------------------------------------------- findings


def test_rules_table_complete():
    assert set(RULES) == {
        "P001", "P002", "P003", "P004",
        "K001", "K002", "K003", "K004",
        "C001", "C002", "E001", "E002",
    }
    from repro.analysis import RULES as REF_RULES

    assert set(RULES) == set(REF_RULES)  # the same IDs: suppressions mean the same


def test_finding_rejects_unknown_rule():
    with pytest.raises(ValueError):
        Finding("Z999", "nope")


def test_suppression_comment():
    assert is_suppressed("x = 1  # repro: ignore[C001]", "C001")
    assert is_suppressed("x = 1  # repro: ignore[C001, E001]", "E001")
    assert not is_suppressed("x = 1  # repro: ignore[C001]", "C002")
    assert not is_suppressed("x = 1", "C001")
    fs = [Finding("C001", "m", file="f.py", line=1), Finding("C001", "m", file="f.py", line=2)]
    kept = filter_suppressed(fs, ["a = 1  # repro: ignore[C001]", "b = 2"])
    assert [f.line for f in kept] == [2]


# ----------------------------------------------------------------- op_count


def test_counter_conventions():
    x, b = torch.randn(8), torch.randn(3, 8)

    def fn():
        y = x.to(f64)
        (y * 2 + 1).sum()  # 8 mul + 8 add + 8 summed
        b.to(f64) @ y  # mv: 3 x 8 multiply-accumulates
        torch.randn(4, 5, dtype=f32) @ torch.randn(5, 6)  # mm: 4 * 6 * 5 in float32
        torch.arange(5) + 1  # integer index arithmetic: not work

    assert op_count.count_ops_by_dtype(fn) == {"float32": 120, "float64": 48}


def test_counter_conversions_and_chain():
    x = torch.randn(8)
    convs = op_count.conversions(lambda: x.to(bf16).to(f32))
    assert convs == [op_count.Conversion("float32", "bfloat16", None),
                     op_count.Conversion("bfloat16", "float32", "float32")]
    dst = torch.zeros(8, dtype=f64)
    assert op_count.conversions(lambda: dst.copy_(x)) == [
        op_count.Conversion("float32", "float64", None)]


def test_kernel_and_host_scopes():
    x = torch.randn(16)
    contract = ({"float64": 5}, [op_count.Conversion("float32", "float64", None)])
    with op_count.OpCounter() as outer, op_count.OpCounter() as inner:
        with op_count.kernel_scope("k", lambda: contract):
            (x * x).sum()  # hidden
        with op_count.host_scope():
            x + x  # hidden, nothing recorded
        x * 2
    for c in (outer, inner):  # counters nest: each sees every op
        assert c.ops_by_dtype() == {"float32": 16, "float64": 5}
        assert c.kernels == {"k": {"calls": 1, "ops": {"float64": 5}, "conversions": 1}}
    op_count.record_kernel("k", {"float64": 1})  # no counter: a no-op


def test_counter_is_per_thread():
    import threading

    x = torch.randn(32)
    with op_count.OpCounter() as c:
        t = threading.Thread(target=lambda: (x * x).sum())
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert c.ops_by_dtype() == {}


# ------------------------------------------------------- precision red rules


def test_p001_red_undeclared_upcast():
    x = torch.randn(8)
    convs = op_count.conversions(lambda: (x.to(f64) * 2.0).to(f32))
    fs = precision_flow.find_upcasts(convs, FFF)
    assert [f.rule for f in fs] == ["P001"]
    assert "float64" in fs[0].message
    assert precision_flow.find_upcasts(convs, FDF) == []  # FDF declares f64


def test_p002_red_double_rounding():
    x = torch.randn(8)
    convs = op_count.conversions(lambda: x.to(bf16).to(f32) * 2.0)
    fs = precision_flow.find_double_rounding(convs, FFF)
    assert [f.rule for f in fs] == ["P002"]
    assert "bfloat16" in fs[0].message
    assert precision_flow.find_double_rounding(convs, BFF) == []  # BFF stores bf16


def test_p003_red_phase_leak():
    a, b = torch.randn(64), torch.randn(64)
    counts = op_count.count_ops_by_dtype(lambda: torch.sum(a.to(bf16) * b.to(bf16)))
    assert any(f.rule == "P003" for f in precision_flow.find_phase_leaks(counts, FFF, "alpha_beta"))
    green = op_count.count_ops_by_dtype(lambda: torch.sum(a * b))
    assert precision_flow.find_phase_leaks(green, FFF, "alpha_beta") == []


def test_p004_red_parity_divergence(monkeypatch):
    with pytest.raises(AssertionError):
        assert_phase_count_parity({"float32": 1_000}, {"float32": 1_000_000}, ratio=8.0)
    with pytest.raises(AssertionError):  # dtype present only in measured
        assert_phase_count_parity({"float32": 1_000}, {"float32": 1_000, "float64": 1_000})
    assert_phase_count_parity({"float32": 1_000}, {"float32": 3_000}, ratio=8.0)
    # check_policy reports a model that tells another dtype story as P004.
    monkeypatch.setattr(precision_flow, "phase_op_counts", lambda *a, **k: {"float64": 10**6})
    fs, _ = precision_flow.check_policy("FFF", "single", device="cpu")
    assert [f.rule for f in fs] == ["P004"]


def test_phase_op_counts_executed_and_device_jacobi():
    host = phase_op_counts(FDF, n=100, nnz=400, m=8, k=4, executed=True)
    dev = phase_op_counts(FDF, n=100, nnz=400, m=8, k=4, executed=True, jacobi="jax")
    assert dev["float64"] - host["float64"] == int(9.0 * 6.0 * 8**3)
    assert phase_op_counts(FDF, n=100, nnz=400, m=8, k=4, executed=True, jacobi="device") == dev
    # executed: the masked project_out runs 3 m n a pass (f = 1.5), the
    # touched-data model half that for the parity scheme.
    algo = phase_op_counts(FDF, n=100, nnz=400, m=8, k=4, reorth="half")
    exe = phase_op_counts(FDF, n=100, nnz=400, m=8, k=4, reorth="half", executed=True)
    assert exe["float64"] - algo["float64"] == int(2.0 * (1.5 - 0.5) * 8 * 8 * 100)


def test_device_jacobi_ritz_accounting():
    fs, measured = precision_flow.check_policy("FDF", "single", jacobi="jax", device="cpu")
    assert fs == [], format_findings(fs)
    _, host = precision_flow.check_policy("FDF", "single", device="cpu")
    assert measured["float64"] > host["float64"]  # every sweep of the device Jacobi counted


# ---------------------------------------------------------- kernel red rules


def test_k001_red_launch_shape():
    fs = kernel_check.check_lane_plans(plan=lambda w, s, a, r, m: (3, "vector", 0),
                                       widths=(8, 16))
    assert fs and all(f.rule == "K001" for f in fs)
    fs = kernel_check.check_lane_plans(plan=lambda w, s, a, r, m: (1, "wide", 0), widths=(512,))
    assert [f.rule for f in fs][:1] == ["K001"]  # the wide path takes a warp a row
    # the split path takes a warp a segment of 1 to SPLIT_VECS whole vectors a lane
    for seg in (0, 100, 32 * 4 * 5):
        fs = kernel_check.check_lane_plans(plan=lambda w, s, a, r, m: (32, "split", seg),
                                           widths=(512,), sizes=(4,))
        assert [f.rule for f in fs][:1] == ["K001"], seg
    fs = kernel_check.check_launch_constants(
        sources={"common.cuh": "constexpr int kThreads = 200;"})
    assert [f.rule for f in fs] == ["K001"]
    assert kernel_check.check_lane_plans() == []
    assert kernel_check.check_launch_constants() == []


def test_k001_red_bsr_plan(monkeypatch):
    """``spmv_bsr``'s plan table against its Python mirror, and a plan the
    kernel's static_asserts refuse (3 lanes: not a power of two)."""
    from repro_torch.kernels import spmv_bsr

    src = (kernel_check.CSRC / "spmv_bsr.cu").read_text()
    edited = src.replace("{4, 16, 16, 2}", "{4, 16, 8, 2}")
    assert edited != src
    fs = kernel_check.check_launch_constants(sources={"spmv_bsr.cu": edited})
    assert [f.rule for f in fs] == ["K001"] and "BSR_PLAN" in fs[0].message
    assert kernel_check.check_bsr_plan(sources={"spmv_bsr.cu": "// rewritten"})[0].rule == "K001"
    monkeypatch.setitem(spmv_bsr.BSR_PLAN, (4, 16), (3, 2))
    fs = kernel_check.check_bsr_plan(sources={"spmv_bsr.cu": src.replace("{4, 16, 16, 2}",
                                                                         "{4, 16, 3, 2}")})
    assert [f.rule for f in fs] == ["K001"] and "refused" in fs[0].message
    monkeypatch.undo()
    assert kernel_check.check_bsr_plan() == []


def test_k002_red_bounds():
    huge = kernel_check.Layout("2^31 columns", ("spmv_ell",), rows=8, width=8, n_cols=2**31 + 1)
    fs = kernel_check.check_index_bounds(layouts=[huge])
    assert [f.rule for f in fs] == ["K002"] and "gather" in fs[0].message
    grid = kernel_check.Layout("2^40 BSR rows", ("spmv_bsr",), nbr=2**40, slots=1, bs=8,
                               n_cols=8)
    assert {f.rule for f in kernel_check.check_index_bounds(layouts=[grid])} == {"K002"}
    gone = kernel_check.check_index_bounds(sources={"mixed_dot.cu": "// rewritten"})
    assert gone and all(f.rule == "K002" and "mixed_dot" in f.message for f in gone)
    fs = kernel_check.check_partials(per_sm={"spmv_ell_alpha_kernel<float, double>": 12})
    assert fs and {f.rule for f in fs} == {"K002"}
    fs = kernel_check.check_partials(update_blocks=lambda n: 1)
    assert fs and {f.rule for f in fs} == {"K002"}
    assert kernel_check.check_index_bounds() == []
    assert kernel_check.check_partials() == []


def test_k003_red_resources():
    ok = {"name": "k<float, double>", "registers": 80, "shared_bytes": 32, "local_bytes": 8,
          "max_threads": 768, "occupancy": 3, "const_bytes": 0}
    assert kernel_check.check_resources([ok]) == []  # a spill is reported, not flagged
    bad = dict(ok, shared_bytes=300_000, occupancy=0)
    fs = kernel_check.check_resources([bad])
    assert [f.rule for f in fs] == ["K003", "K003"]
    assert "local 8 B" in kernel_check.format_attrs([ok])


def test_k004_red_nondeterministic_reduction():
    src = ("__global__ void k(float* __restrict__ out, const float* v, unsigned* counter) {\n"
           "  atomicAdd(&out[0], v[threadIdx.x]);\n  atomicAdd(counter, 1u);\n}\n")
    fs = kernel_check.check_atomics(src, "x.cu")
    assert [(f.rule, f.line) for f in fs] == [("K004", 2)]  # the integer ticket is allowed
    fs = kernel_check.check_cross_block(sources={"lanczos_fused.cu": "// no partials"})
    assert fs and {f.rule for f in fs} == {"K004"} and all("spmv_ell_alpha" in f.message
                                                           for f in fs)
    # the split path's row sums: a partial a segment, summed by finish_row
    fs = kernel_check.check_cross_block(sources={"spmv_ell_packed.cu": "// no partials"})
    assert fs and all("spmv_ell_packed (split)" in f.message for f in fs)
    assert kernel_check.check_cross_block() == []


# --------------------------------------------------- concurrency red rules

_C001_SNIPPET = """
class Sched:
    _GUARDED_BY = {"_queue": "_cv"}

    def bad(self):
        self._queue.append(1)

    def good(self):
        with self._cv:
            self._queue.append(1)
"""


def test_c001_red_unguarded_mutation():
    fs = concurrency.check_source(_C001_SNIPPET, "sched.py")
    assert [(f.rule, f.line) for f in fs] == [("C001", 6)]


def test_c002_red_lock_order_and_cross_object_call():
    snippet = """
class Sched:
    _GUARDED_BY = {}

    def inverted(self):
        with self._build_lock:
            with self._cv:
                pass

    def cross(self, sess):
        with self._cv:
            sess.eigsh_many([])
"""
    assert [f.rule for f in concurrency.check_source(snippet, "sched.py")] == ["C002", "C002"]


def test_c001_exemptions():
    snippet = """
class S:
    _GUARDED_BY = {"_q": "_lock"}

    def __init__(self):
        self._q = []

    def _drain_locked(self):
        self._q.clear()

    def drain(self):  # repro: holds[_lock]
        self._q.clear()

    def noted(self):
        self._q.clear()  # repro: ignore[C001]
"""
    assert concurrency.check_source(snippet, "s.py") == []


def test_c001_guards_the_session_plan_cache():
    """The port's session declares the reference's guard, so an unguarded
    write to its plan cache is a finding."""
    path = REPO_ROOT / "src/repro_torch/api/session.py"
    text = path.read_text()
    assert 'self._prepared: Dict[tuple, _Prepared] = {}' in text
    assert concurrency.check_source(text, "session.py") == []
    doctored = text.replace("    def release(self) -> None:",
                            "    def evict_all(self) -> None:\n"
                            "        self._prepared.clear()\n\n"
                            "    def release(self) -> None:", 1)
    fs = concurrency.check_source(doctored, "session.py")
    assert [f.rule for f in fs] == ["C001"] and "_prepared" in fs[0].message


# ---------------------------------------------------------- config red rules


def test_e001_red_raw_env_read():
    src = """
import os
a = os.environ.get("REPRO_SPMV_TUNE")
b = os.getenv("REPRO_FAULT")
c = os.environ["REPRO_ITER_UPDATE"]
os.environ["REPRO_SPMV_TUNE"] = "1"      # write: allowed
os.environ.setdefault("REPRO_FAULT", "") # write: allowed
d = os.environ.get("HOME")               # not a knob: allowed
"""
    fs = config_lint.find_raw_env_reads(src, "m.py")
    assert [f.rule for f in fs] == ["E001"] * 3
    assert [f.line for f in fs] == [3, 4, 5]


def test_e002_red_registry_readme_drift():
    fs = config_lint.check_readme_sync({"REPRO_A", "REPRO_B"}, "only REPRO_A and REPRO_GHOST")
    msgs = sorted(f.message for f in fs)
    assert len(fs) == 2 and all(f.rule == "E002" for f in fs)
    assert any("REPRO_B" in m for m in msgs) and any("REPRO_GHOST" in m for m in msgs)
    # The TPU-only knobs the port section names to say it does not read them.
    assert config_lint.check_readme_sync({"REPRO_A"}, "REPRO_A; not REPRO_ANALYSIS_VMEM_MB") == []
    assert config_lint.port_section("# t\n## Other\nREPRO_X\n") is None
    section = config_lint.port_section("## PyTorch port (H100)\nREPRO_A\n## Tests\nREPRO_B\n")
    assert "REPRO_A" in section and "REPRO_B" not in section


def test_env_registry_contract():
    from repro.configs import env as ref_env
    from repro_torch.configs import env as envcfg

    with pytest.raises(KeyError):
        envcfg.knob("REPRO_NOT_A_KNOB")
    assert set(envcfg.KNOBS) <= set(ref_env.KNOBS)  # no REPRO_* name the reference lacks
    got, want = envcfg.knob("REPRO_PRECISION_MEASURE"), ref_env.knob("REPRO_PRECISION_MEASURE")
    assert (got.type, got.default) == (want.type, want.default) == ("bool", False)
    assert envcfg.get_bool("REPRO_PRECISION_MEASURE") is False


# -------------------------------------------------- shipped-tree cleanliness


def test_shipped_tree_strict_clean_static_passes():
    results = run_checks(["kernels", "concurrency", "config"], repo_root=str(REPO_ROOT),
                         device="cpu")
    for name, findings in results.items():
        assert findings == [], f"{name}: {format_findings(findings)}"


_PORT_SWEEP = [(r, e, m) for r in precision_flow.RUNGS for e in precision_flow.ENGINES
               for m in precision_flow.ENGINE_MODES[e]]


@pytest.mark.parametrize("rung,engine,mode", _PORT_SWEEP)
def test_declared_phase_map_matches_measured(rung, engine, mode):
    """The port's acceptance sweep: every rung, engine and update mode it
    resolves is clean, and the measured counts are positive."""
    fs, measured = precision_flow.check_policy(POLICIES[rung], engine, mode=mode, device="cpu")
    assert fs == [], format_findings(fs)
    assert measured and all(v > 0 for v in measured.values())


# ------------------------------------------------------ against the reference

# The reference's check_policy fails on these in the driver's environment
# (tests/test_analysis.py::test_declared_phase_map_matches_measured): not
# compared, but the port must still be clean there.
REFERENCE_FAILING = {("BFF", "chunked", "fused"), ("FFF", "chunked", "fused"),
                     ("FCF", "chunked", "fused"), ("FDF", "chunked", "fused"),
                     ("DDD", "chunked", "fused"), ("DDD", "distributed", "fused")}
_BOTH = [(r, e, m) for r, e, m in _PORT_SWEEP if m in ("unfused", "fused")]


@contextlib.contextmanager
def _enable_x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture
def reference_jax(monkeypatch):
    """The reference's analysis on the installed jax: where it lacks
    ``jax.experimental.enable_x64`` and ``jax.core.ClosedJaxpr`` (removed in
    later jax), their successors stand in for the duration of one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", _enable_x64, raising=False)
    missing = [name for name in ("ClosedJaxpr", "Jaxpr") if not hasattr(jax.core, name)]
    if missing:
        import jax.extend.core as jec

        for name in missing:
            monkeypatch.setattr(jax.core, name, getattr(jec, name), raising=False)


def _major_dtypes(counts, min_share=0.02):
    total = sum(counts.values()) or 1
    return {dt for dt, c in counts.items() if c / total >= min_share}


@pytest.mark.parametrize("rung,engine,mode", _BOTH)
def test_phase_dtypes_match_reference(rung, engine, mode, reference_jax):
    fs, _ = precision_flow.check_policy(rung, engine, mode=mode, device="cpu")
    assert fs == [], format_findings(fs)
    if (rung, engine, mode) in REFERENCE_FAILING:
        return
    ref_fs, _ = ref_flow.check_policy(REF_POLICIES[rung], engine, fused=mode == "fused")
    if ref_fs:  # the reference is not clean here: nothing to hold the port to
        return
    from repro.analysis.jaxpr_tools import count_ops_by_dtype

    with jax.experimental.enable_x64():
        ref_phases = ref_flow.trace_phases(rung, engine, fused=mode == "fused")
        want = {ph: _major_dtypes(count_ops_by_dtype(jx)) for ph, jx in ref_phases.items()}
    got = {ph: _major_dtypes(c) for ph, c in
           precision_flow.trace_phases(rung, engine, mode=mode, device="cpu").items()}
    assert got == want


# ------------------------------------------------ contracts against plain versions


def _plain_vs_contract(plain, contract):
    plain_ops = op_count.count_ops_by_dtype(plain)
    ops_, convs = contract
    assert set(plain_ops) == set(ops_), (plain_ops, ops_)
    for dt, n in ops_.items():
        assert 0.5 <= n / plain_ops[dt] <= 2.0, (dt, n, plain_ops[dt])
    plain_convs = {(c.src, c.dst) for c in op_count.conversions(plain)}
    assert {(c.src, c.dst) for c in convs} <= plain_convs


PAIRS = [(f32, f32), (f32, f64), (f64, f64), (bf16, f32), (f16, f32)]
SHAPES = [(64, 8), (200, 24)]


def _rand(shape, dtype, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


@pytest.mark.parametrize("sdt,acc", PAIRS)
@pytest.mark.parametrize("rows,width", SHAPES)
def test_contract_spmv_ell_and_alpha(sdt, acc, rows, width):
    from repro_torch.kernels.lanczos_fused import spmv_ell_alpha_contract
    from repro_torch.kernels.spmv_ell import spmv_ell_contract

    val, x, v = _rand((rows, width), sdt), _rand(rows, sdt, 1), _rand(rows - 3, acc, 2)
    col = torch.as_tensor(np.random.default_rng(3).integers(0, rows, (rows, width)),
                          dtype=torch.int32)
    _plain_vs_contract(lambda: ref.spmv_ell_ref(val, col, x, acc), spmv_ell_contract(val, x, acc))
    _plain_vs_contract(lambda: ref.spmv_ell_alpha_ref(val, col, x, v, acc),
                       spmv_ell_alpha_contract(val, x, v, acc))


@pytest.mark.parametrize("sdt,acc", PAIRS)
@pytest.mark.parametrize("n", [100, 4096])
def test_contract_lanczos_update(sdt, acc, n):
    from repro_torch.kernels.lanczos_update import lanczos_update_contract

    w, v, vp = _rand(n, sdt), _rand(n, sdt, 1), _rand(n, sdt, 2)
    a, b = torch.tensor(0.3, dtype=acc), torch.tensor(0.2, dtype=acc)
    _plain_vs_contract(lambda: ref.lanczos_update_ref(w, v, vp, a, b, acc),
                       lanczos_update_contract(w, acc))


@pytest.mark.parametrize("sdt,acc", PAIRS)
@pytest.mark.parametrize("bs,nbr", [(4, 30), (8, 12), (16, 7)])
def test_contract_spmv_bsr(sdt, acc, bs, nbr):
    from repro_torch.kernels.spmv_bsr import spmv_bsr_contract

    slots = 3
    val, x = _rand((nbr, slots, bs, bs), sdt), _rand(nbr * bs, sdt, 1)
    bcol = torch.as_tensor(np.random.default_rng(3).integers(0, nbr, (nbr, slots)),
                           dtype=torch.int32)
    _plain_vs_contract(lambda: ref.spmv_bsr_ref(val, bcol, x, acc), spmv_bsr_contract(val, x, acc))


@pytest.mark.parametrize("mode,idx", [("bf16", torch.int16), ("bf16", torch.int32),
                                      ("fp8", torch.int16), ("fp8", torch.int32)])
@pytest.mark.parametrize("sdt,acc", [(f32, f32), (f32, f64), (f64, f64)])
@pytest.mark.parametrize("rows,width", [(16, 8), (40, 24)])
def test_contract_spmv_ell_packed(mode, idx, sdt, acc, rows, width):
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk, spmv_ell_packed_contract

    rng = np.random.default_rng(0)
    col = np.sort(rng.integers(0, 4 * rows, (rows, width)), axis=1).astype(np.int32)
    val, scale, base, dcol = pack_ell_chunk(rng.standard_normal((rows, width)).astype(np.float32),
                                            col, mode)
    dcol = dcol.to(idx)
    x = _rand(4 * rows, sdt, 1)
    _plain_vs_contract(lambda: ref.spmv_ell_packed_ref(val, scale, base, dcol, x, acc),
                       spmv_ell_packed_contract(val, scale, x, acc))


@pytest.mark.parametrize("sdt", [f32, f64, f16, bf16])
@pytest.mark.parametrize("acc", [f32, f64])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("n,block", [(4096, 512), (8192, 4096)])
def test_contract_mixed_dot(sdt, acc, compensated, n, block):
    from repro_torch.kernels.mixed_dot import mixed_dot_contract

    a, b = _rand(n, sdt), _rand(n, sdt, 1)
    _plain_vs_contract(lambda: ref.mixed_dot_ref(a, b, acc, block=block, compensated=compensated),
                       mixed_dot_contract(a, acc, block, compensated))


def test_wrappers_record_their_contract_and_hide_the_plain_ops():
    from repro_torch.kernels.lanczos_update import lanczos_update_contract
    from repro_torch.kernels.spmv_ell import spmv_ell_contract

    val, x = _rand((64, 8), f32), _rand(64, f32, 1)
    col = torch.as_tensor(np.random.default_rng(3).integers(0, 64, (64, 8)), dtype=torch.int32)
    w, v = _rand(64, f64), _rand(64, f64, 1)
    with op_count.OpCounter() as c:
        ops.ell_matvec(val, col, x, f64)
        ops.lanczos_update(w, v, v, torch.tensor(0.5, dtype=f64), torch.tensor(0.1, dtype=f64),
                           accum_dtype=f64)
    want_ell, want_upd = spmv_ell_contract(val, x, f64), lanczos_update_contract(w, f64)
    assert c.kernels["spmv_ell"]["ops"] == want_ell[0]
    assert c.kernels["lanczos_update"]["ops"] == want_upd[0]
    assert c.ops_by_dtype() == {"float64": want_ell[0]["float64"] + want_upd[0]["float64"]}


# ----------------------------------------------------------- measured hook


def test_session_measured_hook(monkeypatch):
    """REPRO_PRECISION_MEASURE=1 fills ops_by_dtype_measured with the
    counts of the session's own solve, with the model's dtypes, and changes
    no bit of the result."""
    import repro_torch
    from repro_torch.sparse import generate

    csr = generate("road", 100, 4.0, seed=1)
    runs = [{}, {"tol": 1e-6}]
    before = [repro_torch.eigsh(csr, k=3, device="cpu", **kw) for kw in runs]
    repro_torch.session_cache_clear()
    monkeypatch.setenv("REPRO_PRECISION_MEASURE", "1")
    for kw, want in zip(runs, before):
        res = repro_torch.eigsh(csr, k=3, device="cpu", **kw)
        prec = res.partition["spmv"]["precision"]
        measured = prec["ops_by_dtype_measured"]
        assert measured and "error" not in measured
        assert all(isinstance(v, int) and v > 0 for v in measured.values())
        assert set(measured) == set(prec["ops_by_dtype"])
        assert set(prec["counts"]) == {"ops_by_dtype", "ops_by_dtype_measured"}
        assert torch.equal(res.eigenvalues, want.eigenvalues)
        assert torch.equal(res.eigenvectors, want.eigenvectors)
    dist = repro_torch.eigsh(csr, k=3, device="cpu", backend="distributed")
    assert "error" in dist.partition["spmv"]["precision"]["ops_by_dtype_measured"]


# ----------------------------------------------------------------- CLI


def test_cli_strict_clean_on_fast_passes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    summary = tmp_path / "summary.md"
    rc = main(["--check", "concurrency", "--check", "config", "--strict", "--device", "cpu",
               "--repo-root", str(REPO_ROOT), "--summary-out", str(summary)])
    assert rc == 0
    assert "[concurrency] 0 finding(s)" in capsys.readouterr().out
    assert "clean" in summary.read_text()


def test_cli_strict_fails_on_findings(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    bad_root = tmp_path / "tree"
    (bad_root / "src" / "repro_torch" / "serving").mkdir(parents=True)
    (bad_root / "src" / "repro_torch" / "serving" / "bad.py").write_text(_C001_SNIPPET)
    rc = main(["--check", "concurrency", "--strict", "--device", "cpu",
               "--repo-root", str(bad_root)])
    assert rc == 1
    assert "C001" in capsys.readouterr().out
    assert main(["--check", "concurrency", "--device", "cpu",
                 "--repo-root", str(bad_root)]) == 0  # not strict


def test_cli_rejects_unknown_check():
    from repro_torch.analysis.__main__ import main

    with pytest.raises(SystemExit):
        main(["--check", "nonsense"])


def _subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_PRECISION_MEASURE", None)
    return env


def test_cli_strict_exits_zero_on_the_shipped_tree():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict",
                          "--device", "cpu"], cwd=REPO_ROOT, env=_subprocess_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "static analysis: clean" in out.stdout


def test_analysis_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "from repro_torch.analysis import concurrency, config_lint, kernel_check, op_count\n"
        "from repro_torch.analysis import precision_flow\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=_subprocess_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
