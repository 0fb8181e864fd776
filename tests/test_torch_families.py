"""The port's MoE, RG-LRU and SSD families (``repro_torch.models.{mlp,rglru,
ssd,model}``) against the reference on the same weights and inputs (CPU).

The reference's params are carried into the port with ``params_from_numpy``
and the inputs are drawn with NumPy, so both packages compute the same
function at the f32 ``SMOKE`` configs.  Tolerances (max abs error over max
|reference|), each set from what a sum in another order costs in f32:
block outputs, states, logits and HVPs within 1e-5 (measured 1e-7 to
4e-6), losses within 1e-6, ``_ssd_chunked`` against the plain recurrence
within 1e-4 (the reference's own bound for an exp of a cumsum).  Each
assert message prints the error it measured.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.operators import HvpOperator as JaxHvpOperator
from repro.models import mlp as jax_mlp
from repro.models import rglru as jax_rglru
from repro.models import ssd as jax_ssd
from repro.models.common import split_tree as jax_split_tree
from repro.models.model import init_model as jax_init_model
from repro.models.model import loss_fn as jax_loss_fn
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import synthetic_batch as jax_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.core.operators import HvpOperator
from repro_torch.models import mlp, rglru, ssd
from repro_torch.models.common import split_tree
from repro_torch.models.model import init_model, loss_fn, params_from_numpy
from repro_torch.training import DataConfig, OptConfig, TrainConfig, Trainer, data_stream
from repro_torch.training.data import synthetic_batch

FAMILIES = ["mixtral-8x7b", "arctic-480b", "recurrentgemma-2b", "mamba2-130m"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def carried():
    """Per arch: (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for arch in FAMILIES:
        jc = jax_get_config(arch, smoke=True)
        jp = jax.device_get(jax_split_tree(jax_init_model(jax.random.PRNGKey(0), jc))[0])
        out[arch] = (jc, jp, get_config(arch, smoke=True), params_from_numpy(jp))
    return out


# ------------------------------------------------------------------- MoE


def _moe_case(arch, key, cf=None):
    jc, tc = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if cf is not None:
        jc, tc = (dataclasses.replace(c, capacity_factor=cf) for c in (jc, tc))
    jp = jax.device_get(jax_split_tree(jax_mlp.init_moe(jax.random.PRNGKey(key), jc))[0])
    x = np.random.default_rng(key + 4).standard_normal((2, 64, jc.d_model)).astype(np.float32)
    return jc, jp, tc, params_from_numpy(jp), x


@pytest.mark.parametrize("arch,cf,dropless", [
    ("mixtral-8x7b", None, False), ("mixtral-8x7b", None, True),
    ("arctic-480b", 0.5, False), ("arctic-480b", 0.5, True),
], ids=["mixtral-capacity", "mixtral-dropless", "arctic-cf0.5", "arctic-dropless"])
def test_moe_matches_reference(arch, cf, dropless):
    """GShard dispatch with capacity drops (arctic at cf 0.5 drops, and adds
    its dense residual MLP) and the dropless serving capacity."""
    jc, jp, tc, tp, x = _moe_case(arch, 3, cf)
    jy, jaux = jax_mlp.moe(jp, jc, jnp.asarray(x), dropless=dropless)
    ty, taux = mlp.moe(tp, tc, t(x), dropless=dropless)
    err = rel(ty.numpy(), jy)
    assert err <= 1e-5, f"{arch} cf {cf} dropless {dropless}: y rel err {err:.3e}"
    aerr = abs(float(taux) - float(jaux)) / abs(float(jaux))
    assert aerr <= 1e-6, f"aux {float(taux)} vs {float(jaux)}"


def test_moe_ties_route_as_the_reference():
    """A zero router gives every expert the same probability: ``argmax``
    then takes the first maximum in both packages, so the same experts fill
    up and the same tokens drop."""
    jc, jp, tc, tp, x = _moe_case("mixtral-8x7b", 5)
    jp["router"] = np.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    jy, _ = jax_mlp.moe(jp, jc, jnp.asarray(x))
    ty, _ = mlp.moe(tp, tc, t(x))
    err = rel(ty.numpy(), jy)
    assert err <= 1e-5, f"tied router: rel err {err:.3e}"
    routed = np.abs(ty.numpy()).max(-1) > 0
    assert 0 < routed.sum() < routed.size  # capacity cut the tie-broken queue


def test_moe_routing_properties():
    """The reference's ``test_moe_routing_properties`` on the port."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    p, _ = split_tree(mlp.init_moe(torch.Generator().manual_seed(2), cfg))
    x = t(np.random.default_rng(6).standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    y, aux = mlp.moe(p, cfg, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) >= 1.0 - 1e-3  # the Switch aux loss is 1 at balance


def test_moe_dropless_vs_training_capacity():
    """The reference's serving test on the port: training at cf 0.5 drops
    tokens, serving routes every token."""
    cfg = dataclasses.replace(get_config("arctic-480b", smoke=True), capacity_factor=0.5)
    p, _ = split_tree(mlp.init_moe(torch.Generator().manual_seed(3), cfg))
    x = t(np.random.default_rng(4).standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    y_train, _ = mlp.moe(p, cfg, x, dropless=False)
    y_serve, _ = mlp.moe(p, cfg, x, dropless=True)
    assert float((y_train - y_serve).abs().amax(-1).max()) > 0
    assert float(y_serve.abs().amax(-1).min()) > 0


# ---------------------------------------------------------------- RG-LRU


@pytest.fixture(scope="module")
def rglru_case():
    jc, tc = jax_get_config("recurrentgemma-2b", smoke=True), get_config("recurrentgemma-2b", True)
    jp = jax.device_get(jax_split_tree(jax_rglru.init_rglru_block(jax.random.PRNGKey(1), jc))[0])
    # the init's zero gate weights make r and i constant: give them weight
    rng = np.random.default_rng(2)
    for name in ("w_a", "w_x"):
        jp[name] = (rng.standard_normal(jp[name].shape) * 0.2).astype(np.float32)
    x = rng.standard_normal((2, 13, jc.d_model)).astype(np.float32)
    return jc, jp, tc, params_from_numpy(jp), x


def test_rglru_block_and_decode_match_reference(rglru_case):
    """The sequence form (S = 13: a doubling scan over a length that is not a
    power of two) and 13 single-token steps from the zero state."""
    jc, jp, tc, tp, x = rglru_case
    jy, jst = jax_rglru.rglru_block(jp, jc, jnp.asarray(x))
    ty, tst = rglru.rglru_block(tp, tc, t(x))
    for name, got, want in (("y", ty, jy), ("h", tst.h, jst.h), ("conv", tst.conv, jst.conv)):
        err = rel(got.numpy(), want)
        assert err <= 1e-5, f"rglru_block {name}: rel err {err:.3e}"
    jst = jax_rglru.init_rglru_state(jc, 2)
    tst = rglru.init_rglru_state(tc, 2)
    for i in range(x.shape[1]):
        jy, jst = jax_rglru.rglru_decode_step(jp, jc, jnp.asarray(x[:, i:i + 1]), jst)
        ty, tst = rglru.rglru_decode_step(tp, tc, t(x[:, i:i + 1]), tst)
        err = max(rel(ty.numpy(), jy), rel(tst.h.numpy(), jst.h), rel(tst.conv.numpy(), jst.conv))
        assert err <= 1e-5, f"rglru_decode_step {i}: rel err {err:.3e}"


def test_rglru_decode_matches_sequence(rglru_case):
    """The reference's ``test_rglru_decode_matches_sequence`` on the port."""
    _, _, tc, tp, x = rglru_case
    y_seq, st_final = rglru.rglru_block(tp, tc, t(x))
    st = rglru.init_rglru_state(tc, 2)
    ys = []
    for i in range(x.shape[1]):
        y, st = rglru.rglru_decode_step(tp, tc, t(x[:, i:i + 1]), st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_seq, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st.h, st_final.h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_linear_scan_matches_the_recurrence_and_is_twice_differentiable(s):
    """The doubling scan against the step-by-step recurrence in f64, and its
    gradient of a gradient against finite differences."""
    rng = np.random.default_rng(s)
    a = t(rng.uniform(0.5, 1.0, (2, s, 3)))
    b = t(rng.standard_normal((2, s, 3)))
    h, hs = torch.zeros(2, 3, dtype=torch.float64), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        hs.append(h)
    err = rel(rglru._linear_scan(a, b).numpy(), torch.stack(hs, 1).numpy())
    assert err <= 1e-14, f"S={s}: scan vs recurrence rel err {err:.3e}"
    if s in (7, 16):
        assert torch.autograd.gradgradcheck(
            rglru._linear_scan, (a.requires_grad_(), b.requires_grad_()))


# ------------------------------------------------------------------- SSD


def _ssd_inputs(seed=4, B=1, S=24, H=2, P=4, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, a, bm, cm


def test_ssd_chunked_matches_reference():
    args = _ssd_inputs()
    jy, jh = jax_ssd._ssd_chunked(*(jnp.asarray(v) for v in args), chunk=8)
    ty, th = ssd._ssd_chunked(*(t(v) for v in args), chunk=8)
    err = max(rel(ty.numpy(), jy), rel(th.numpy(), jh))
    assert err <= 1e-5, f"_ssd_chunked: rel err {err:.3e}"


def test_ssd_chunked_matches_recurrence():
    """The reference's ``test_ssd_chunked_matches_recurrence`` on the port:
    the chunked scan against the per-token SSM recurrence."""
    x, dt, a, bm, cm = _ssd_inputs()
    y, hf = ssd._ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), chunk=8)
    B, S, H, P = x.shape
    h = np.zeros((B, H, P, bm.shape[-1]))
    ys = np.zeros((B, S, H, P))
    for i in range(S):
        da = np.exp(dt[:, i] * a)
        h = h * da[..., None, None] + np.einsum("bh,bn,bhp->bhpn", dt[:, i], bm[:, i], x[:, i])
        ys[:, i] = np.einsum("bn,bhpn->bhp", cm[:, i], h)
    np.testing.assert_allclose(y.numpy(), ys, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), h, rtol=1e-4, atol=1e-4)


def test_ssd_backward_stays_finite_where_the_decay_overflows():
    """A 64-step chunk with dt*|A| ~ 2.5 a step: exp(dac_i - dac_j) above
    the diagonal would reach e^160 (inf in f32).  The port masks before the
    exp, so the gradient and the gradient of the gradient stay finite."""
    x, dt, a, bm, cm = (t(v) for v in _ssd_inputs(seed=9, S=64, H=2))
    dt = (dt * 0 + 0.1).requires_grad_()
    a = (a * 0 - 25.0).requires_grad_()
    x = x.requires_grad_()
    y, h = ssd._ssd_chunked(x, dt, a, bm, cm, chunk=64)
    (g,) = torch.autograd.grad((y.sum() + h.sum()), x, create_graph=True)
    hv = torch.autograd.grad(g.square().sum(), (dt, a))  # g is linear in x
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(g).all())
    assert all(bool(torch.isfinite(v).all()) for v in hv)


@pytest.fixture(scope="module")
def ssd_case():
    jc, tc = jax_get_config("mamba2-130m", smoke=True), get_config("mamba2-130m", smoke=True)
    jp = jax.device_get(jax_split_tree(jax_ssd.init_ssd_block(jax.random.PRNGKey(1), jc))[0])
    x = np.random.default_rng(3).standard_normal((2, 27, jc.d_model)).astype(np.float32)
    return jc, jp, tc, params_from_numpy(jp), x


def test_ssd_block_and_decode_match_reference(ssd_case):
    """S = 27 with chunk 16: the ragged tail is padded with dt = 0 steps."""
    jc, jp, tc, tp, x = ssd_case
    jy, jst = jax_ssd.ssd_block(jp, jc, jnp.asarray(x))
    ty, tst = ssd.ssd_block(tp, tc, t(x))
    for name, got, want in (("y", ty, jy), ("h", tst.h, jst.h), ("conv", tst.conv, jst.conv)):
        err = rel(got.numpy(), want)
        assert err <= 1e-5, f"ssd_block {name}: rel err {err:.3e}"
    jst, tst = jax_ssd.init_ssd_state(jc, 2), ssd.init_ssd_state(tc, 2)
    for i in range(6):
        jy, jst = jax_ssd.ssd_decode_step(jp, jc, jnp.asarray(x[:, i:i + 1]), jst)
        ty, tst = ssd.ssd_decode_step(tp, tc, t(x[:, i:i + 1]), tst)
        err = max(rel(ty.numpy(), jy), rel(tst.h.numpy(), jst.h), rel(tst.conv.numpy(), jst.conv))
        assert err <= 1e-5, f"ssd_decode_step {i}: rel err {err:.3e}"


def test_ssd_decode_matches_sequence(ssd_case):
    """The reference's ``test_ssd_decode_matches_sequence`` on the port
    (here with a ragged length)."""
    _, _, tc, tp, x = ssd_case
    y_seq, st_final = ssd.ssd_block(tp, tc, t(x))
    st = ssd.init_ssd_state(tc, 2)
    ys = []
    for i in range(x.shape[1]):
        y, st = ssd.ssd_decode_step(tp, tc, t(x[:, i:i + 1]), st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_seq, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st.h, st_final.h, rtol=2e-3, atol=2e-3)


# ------------------------------------------------------- whole models


def _batches(jc, tc, seq, batch=2):
    jb = jax_synthetic_batch(jc, JaxDataConfig(batch=batch, seq_len=seq, seed=5), 0)
    tb = synthetic_batch(tc, DataConfig(batch=batch, seq_len=seq, seed=5), 0)
    return jb, tb


def _dtype_name(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    try:
        return jnp.dtype(v).name
    except TypeError:
        return v


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_match_reference(arch, smoke):
    want, got = jax_get_config(arch, smoke), get_config(arch, smoke)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            a, b = _dtype_name(a), _dtype_name(b)
        assert a == b, f"{arch} {'SMOKE' if smoke else 'CONFIG'}.{f.name}: {b!r} vs {a!r}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_draws_the_reference_tree(carried, arch):
    """The port's own init gives the reference's leaf names, shapes and
    dtypes, for the stacked kinds and the remainder layers."""
    from repro_torch.core import tree

    jc, jp, tc, tp = carried[arch]
    own, _ = split_tree(init_model(torch.Generator().manual_seed(0), tc))
    want = [("/".join(str(k) for k in p), tuple(a.shape), a.dtype.name)
            for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = [(n, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for n, v in tree.leaves_with_names(own)]
    assert got == want
    assert all(bool(torch.isfinite(v).all()) for v in tree.leaves(own))


@pytest.mark.parametrize("arch", FAMILIES)
def test_hvp_matches_reference(carried, arch):
    """Reverse over reverse through the MoE routing, the doubling scan and
    the SSD chunk loop: the port's HVP within rel 1e-5 of max |Hv| of the
    reference's, on one NumPy vector (``ggn`` is accepted, as there)."""
    jc, jp, tc, tp = carried[arch]
    jb, tb = _batches(jc, tc, 32)
    jop = JaxHvpOperator(lambda p: jax_loss_fn(p, jc, jb)[0], jp)
    top = HvpOperator(lambda p: loss_fn(p, tc, tb)[0], tp, ggn=True)
    assert top.n == jop.n
    v = np.random.default_rng(0).standard_normal(top.n).astype(np.float32)
    want = np.asarray(jop.matvec(jnp.asarray(v)))
    got = top.matvec(t(v)).numpy()
    err = rel(got, want)
    assert err <= 1e-5, f"{arch}: HVP rel err {err:.3e} of max|Hv|"


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_steps_and_probes(carried, arch):
    """``Trainer`` takes AdamW steps on each new family and a Hessian probe
    runs at step 2 (FFF on the CPU: the plain versions)."""
    _, _, tc, tp = carried[arch]
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=4),
                       ckpt_every=100, ckpt_dir=tempfile.mkdtemp(), spectral_every=2)
    tr = Trainer(tc, tcfg, tp,  # it trains a copy
                 probe_batch_fn=lambda: synthetic_batch(tc, DataConfig(batch=2, seq_len=32, seed=2), 0))
    hist = tr.run(data_stream(tc, DataConfig(batch=2, seq_len=32, seed=1)), num_steps=2,
                  log_fn=lambda *_: None)
    assert len(hist) == 2 and np.isfinite(hist).all() and tr.rollbacks == 0
    ev = np.asarray(tr.spectra[2])
    assert ev.shape == (4,) and np.isfinite(ev).all()
    assert np.all(np.diff(np.abs(ev)) <= 0)
