"""The port's Mamba blocks (``repro_torch.models.ssm``) and SSM inits
against the JAX package's ``repro.models.ssm``, on the CPU.

Inputs are made with numpy from a seed; weights are drawn by the
reference's ``init_params`` and carried across as numpy arrays.

Tolerances.  The associative scan takes the order of
``jax.lax.associative_scan`` (the odd/even recursion), so against the
reference's scan run op by op it is held bit for bit.  Inside a jitted
program XLA may fuse a multiply and an add of the scan into one rounding,
which torch does not, so against a jitted reference it is held to SCAN_TOL =
1e-6 normwise (measured: a few f32 ulps), and against a sequential
recurrence to 1e-5 elementwise, mirroring the reference's own test
(``tests/test_models.py``).  Whole Mamba blocks agree to about 1e-7
normwise (the products, ``exp`` and ``logaddexp`` round alike to a few
ulps); they are held at BLOCK_TOL = 1e-5 normwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as ref_config
from repro.models import ssm as ref_ssm
from repro.models.params import Leaf as RefLeaf
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.models import params as pp
from repro_torch.models import smoke, ssm
from repro_torch.models.params import Leaf

SCAN_TOL = 1e-6
SEQ_TOL = 1e-5
BLOCK_TOL = 1e-5
ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _shapes(table, leaf_type):
    if isinstance(table, leaf_type):
        return (table.shape, table.axes, table.init)
    return {k: _shapes(v, leaf_type) for k, v in table.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_table_is_the_references(arch):
    for cfg, ref_cfg in ((get_config(arch), REF_ARCHS[arch]),
                         (smoke(get_config(arch)),
                          ref_config.smoke(REF_ARCHS[arch]))):
        assert _shapes(ssm.mamba_table(cfg), Leaf) \
            == _shapes(ref_ssm.mamba_table(ref_cfg), RefLeaf)


@pytest.mark.parametrize("shape", [(16, 4), (8,), (2, 3, 5)])
def test_ssm_inits(shape):
    """``ssm_a`` is log(1..n) over the last axis, whatever the generator,
    the reference's to an ulp of ``log``; ``dt_bias`` is drawn from the
    generator, so softplus of it lies in [1e-3, 1e-1]."""
    leaf = {"a": Leaf(shape, (None,) * len(shape), "ssm_a")}
    a = pp.init_params(leaf, torch.Generator(), device="cpu")["a"]
    assert torch.equal(a, pp.init_params(
        leaf, torch.Generator().manual_seed(9), device="cpu")["a"])
    want = ref_init_params({"a": RefLeaf(shape, (None,) * len(shape),
                                         "ssm_a")}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(a.numpy(), np.asarray(want["a"]), rtol=2e-7,
                               atol=0)
    np.testing.assert_allclose(a.numpy()[..., -1], np.log(shape[-1]),
                               rtol=2e-7)
    leaf = {"d": Leaf(shape, (None,) * len(shape), "dt_bias")}
    d1 = pp.init_params(leaf, torch.Generator().manual_seed(3), device="cpu")
    d2 = pp.init_params(leaf, torch.Generator().manual_seed(3), device="cpu")
    d3 = pp.init_params(leaf, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(d1["d"], d2["d"]) and not torch.equal(d1["d"],
                                                             d3["d"])
    dt = ssm._softplus(d1["d"].double())
    assert bool((dt >= 1e-3 * (1 - 1e-5)).all()) \
        and bool((dt <= 0.1 * (1 + 1e-5)).all())


def _a_u(b, n, tail, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, size=(b, n) + tail).astype(np.float32)
    u = rng.normal(size=(b, n) + tail).astype(np.float32)
    h0 = rng.normal(size=(b,) + tail).astype(np.float32)
    return a, u, h0


def _sequential(a, u, h0):
    """h_t = a_t h_{t-1} + u_t in f64, one step at a time."""
    a, u, h = (np.asarray(x, np.float64) for x in (a, u, h0))
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return np.stack(hs, axis=1)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 16, 31, 32, 64])
def test_scan_chunks_matches_the_reference(n):
    a, u, h0 = _a_u(2, n, (4, 3), seed=n)
    got, last = ssm._scan_chunks(*(torch.from_numpy(x) for x in (a, u, h0)))
    args = tuple(jnp.asarray(x) for x in (a, u, h0))
    want, want_last = ref_ssm._scan_chunks(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(last.numpy(), np.asarray(want_last))
    jitted, _ = jax.jit(ref_ssm._scan_chunks)(*args)
    assert normwise(got.numpy(), jitted) <= SCAN_TOL
    np.testing.assert_allclose(got.numpy(), _sequential(a, u, h0),
                               rtol=SEQ_TOL, atol=SEQ_TOL)


def test_decode_step_of_the_scan_is_exact():
    """At s = 1 the scan is h = a h0 + u, one multiply and one add."""
    a, u, h0 = _a_u(3, 1, (5, 2), seed=11)
    got, last = ssm._scan_chunks(*(torch.from_numpy(x) for x in (a, u, h0)))
    want = torch.from_numpy(a[:, 0] * h0) + torch.from_numpy(u[:, 0])
    assert torch.equal(last, want) and torch.equal(got[:, 0], want)


@pytest.mark.parametrize("s,chunk", [(48, 16), (48, 48), (40, 64), (64, 8)])
def test_chunked_ssm_apply_matches_sequential(s, chunk):
    """The reference's test (``tests/test_models.py``) on the port, and the
    reference's ``_chunked_ssm_apply`` on the same inputs."""
    a, u, _ = _a_u(2, s, (4, 3), seed=s + chunk)
    h0 = np.zeros((2, 4, 3), np.float32)

    def build(ch):
        a_c, u_c = ch
        return a_c, u_c, lambda h_all: h_all

    got, last = ssm._chunked_ssm_apply(
        build, (torch.from_numpy(a), torch.from_numpy(u)),
        torch.from_numpy(h0), chunk, s)
    ref = _sequential(a, u, h0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(last.numpy(), ref[:, -1], rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    want, want_last = ref_ssm._chunked_ssm_apply(
        build, (jnp.asarray(a), jnp.asarray(u)), jnp.asarray(h0), chunk, s)
    assert normwise(got.numpy(), want) <= SCAN_TOL
    assert normwise(last.numpy(), want_last) <= SCAN_TOL


def test_chunked_ssm_apply_refuses_a_ragged_sequence():
    a, u, h0 = _a_u(1, 24, (2,), seed=0)

    def build(ch):
        return ch[0], ch[1], lambda h_all: h_all

    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        ssm._chunked_ssm_apply(build, (torch.from_numpy(a),
                                       torch.from_numpy(u)),
                               torch.from_numpy(h0), 16, 24)


@pytest.mark.parametrize("window", [None, "f32", "bf16"])
def test_causal_conv_matches_the_reference(window):
    """Without a window (zero history), with an f32 one, and with a bf16
    one, which promotes the output to f32 as ``jnp.concatenate`` does."""
    rng = np.random.default_rng(3)
    b, s, c, k = 2, 5, 6, 4
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    win = rng.normal(size=(b, k - 1, c)).astype(np.float32)
    if window is None:
        tw, jw = None, None
    elif window == "f32":
        tw, jw = torch.from_numpy(win), jnp.asarray(win)
    else:
        tw = torch.from_numpy(win).to(torch.bfloat16)
        jw = jnp.asarray(win, jnp.bfloat16)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bias), tw)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias), jw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _block(arch, seed=0):
    cfg = smoke(get_config(arch))
    ref_cfg = ref_config.smoke(REF_ARCHS[arch])
    ref_p = ref_init_params(ref_ssm.mamba_table(ref_cfg),
                            jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                               ref_p)
    return cfg, ref_cfg, p, ref_p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,with_state", [(32, False), (48, True),
                                          (1, True), (7, True)])
def test_mamba_forward_matches_the_reference(arch, s, with_state):
    """mamba1_forward (falcon) and mamba2_forward (zamba2) over several
    chunks (smoke chunk 16) or less than one, from a zero or a carried
    state; the output, the new conv window and the new SSM state."""
    cfg, ref_cfg, p, ref_p = _block(arch)
    if s % min(cfg.ssm.chunk, s):
        pytest.skip("the reference asserts a whole number of chunks")
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    state = ref_state = None
    if with_state:
        conv0, h0 = ssm.mamba_init_state(cfg, 2, device="cpu")
        conv = rng.normal(size=tuple(conv0.shape)).astype(np.float32)
        h = (rng.normal(size=tuple(h0.shape)) * 0.1).astype(np.float32)
        state = (torch.from_numpy(conv), torch.from_numpy(h))
        ref_state = (jnp.asarray(conv), jnp.asarray(h))
    fwd = ssm.mamba1_forward if cfg.ssm.version == 1 else ssm.mamba2_forward
    ref_fwd = ref_ssm.mamba1_forward if cfg.ssm.version == 1 \
        else ref_ssm.mamba2_forward
    y, (conv, h) = fwd(p, cfg, torch.from_numpy(x), state)
    wy, (wconv, wh) = ref_fwd(ref_p, ref_cfg, jnp.asarray(x), ref_state)
    assert y.shape == wy.shape and conv.shape == wconv.shape \
        and h.shape == wh.shape
    for got, want in ((y, wy), (conv, wconv), (h, wh)):
        assert normwise(got.numpy(), want) <= BLOCK_TOL
    y2, _ = ssm.mamba_forward(p, cfg, torch.from_numpy(x), state)
    assert torch.equal(y2, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_init_state_is_the_references(arch):
    cfg = smoke(get_config(arch))
    ref_cfg = ref_config.smoke(REF_ARCHS[arch])
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        conv, h = ssm.mamba_init_state(cfg, 3, dtype, device="cpu")
        wconv, wh = ref_ssm.mamba_init_state(ref_cfg, 3, jdtype)
        assert (tuple(conv.shape), tuple(h.shape)) == (wconv.shape, wh.shape)
        assert str(conv.dtype).replace("torch.", "") == str(wconv.dtype)
        assert h.dtype == torch.float32 and wh.dtype == jnp.float32
        assert not conv.any() and not h.any()
