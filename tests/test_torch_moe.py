"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

Inputs are made with numpy from a seed; expert weights are drawn by the
reference's ``init_params`` and carried across as numpy arrays, so both
packages run the same weights on the same activations.

Tolerances.  The dispatch (sort, counts, capacity, destinations) is integer
work and is held bit for bit, as is the combine's order of addition on the
same expert outputs.  ``moe_ffn`` as a whole is held normwise at
MOE_TOL = 1e-6: torch's and XLA's CPU products and softmax round alike to a
few ulps (about 1e-7 normwise measured), and the routing is the same unless
two router probabilities fall within an ulp of each other, which these
seeds do not make.  ``moe_aux_loss`` relatively at 1e-6.  The host-backend
``moe_dispatch_spgemm`` in f64 at rtol 1e-8 against the dense product,
mirroring the reference's own test (``tests/test_models.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as ref_config
from repro.models import moe as ref_moe
from repro.models.params import Leaf as RefLeaf
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.models import moe, smoke
from repro_torch.models.params import Leaf

MOE_TOL = 1e-6
AUX_TOL = 1e-6
ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def configs(arch, **moe_kw):
    """(port cfg, reference cfg) at smoke size, with ``moe_kw`` replaced."""
    cfg = smoke(get_config(arch))
    ref_cfg = ref_config.smoke(REF_ARCHS[arch])
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_kw))
    return cfg, ref_cfg


def weights(ref_cfg, seed=1):
    """(port params, reference params) of one MoE layer."""
    ref_p = ref_init_params(ref_moe.moe_table(ref_cfg),
                            jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), ref_p), ref_p


def activations(t, d, seed=0):
    return np.random.default_rng(seed).normal(size=(1, t, d)).astype(
        np.float32)


def _shapes(table, leaf_type):
    if isinstance(table, leaf_type):
        return (table.shape, table.axes, table.init)
    return {k: _shapes(v, leaf_type) for k, v in table.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_table_is_the_references(arch):
    for cfg, ref_cfg in ((get_config(arch), REF_ARCHS[arch]),
                         configs(arch)):
        assert _shapes(moe.moe_table(cfg), Leaf) \
            == _shapes(ref_moe.moe_table(ref_cfg), RefLeaf)


def test_capacity_and_groups_are_the_references():
    cfg, ref_cfg = configs("qwen3-moe-30b-a3b")
    full, ref_full = get_config("qwen3-moe-30b-a3b"), \
        REF_ARCHS["qwen3-moe-30b-a3b"]
    for t in (1, 3, 4, 7, 64, 128, 1000, 4095, 4096, 4097, 4100, 6144,
              8192, 12345, 32768):
        assert moe._n_groups(t) == ref_moe._n_groups(t), t
        for c, rc in ((cfg, ref_cfg), (full, ref_full)):
            assert moe._capacity(t, c) == ref_moe._capacity(t, rc), t
    # the chip run's two sizes: decode (one group, cap 8) and a [1, 4096]
    # prefill (32 groups of 128 tokens, cap 16)
    assert moe._n_groups(4) == 1 and moe._capacity(4, full) == 8
    assert moe._n_groups(4096) == 32 and moe._capacity(128, full) == 16


def _routing(t, e, k, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        probs = np.full((t, e), 1.0 / e, np.float32)
    else:
        probs = rng.uniform(size=(t, e)).astype(np.float32)
    idx = np.argsort(-probs, axis=1, kind="stable")[:, :k].astype(np.int32)
    gates = np.take_along_axis(probs, idx, axis=1)
    return idx, gates


@pytest.mark.parametrize("t,e,k,cap,ties", [
    (16, 8, 2, 8, False), (40, 8, 2, 8, False), (64, 8, 3, 16, False),
    (33, 8, 2, 8, True), (128, 16, 4, 24, False)])
def test_dispatch_group_is_the_references_bit_for_bit(t, e, k, cap, ties):
    """Sorted order, destinations, keep mask (drops past capacity), gates
    and the dispatched rows, on ties (every token on experts 0..k-1) too."""
    d = 12
    x = activations(t, d, seed=t)[0]
    idx, gates = _routing(t, e, k, seed=t, ties=ties)
    got = moe._dispatch_group(torch.from_numpy(x), torch.from_numpy(idx),
                              torch.from_numpy(gates), e=e, cap=cap)
    want = ref_moe._dispatch_group(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(gates), e=e, cap=cap)
    names = ("x_disp", "dst", "keep", "g_sorted", "tok_sorted")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (not got[2].all()) == (ties or t * k / e > cap)


def _ref_combine(yd, dst, keep, gs, toks, tg, d):
    """The reference's combine (``moe_ffn``'s inner function) on one group,
    as it is written there, under jit."""
    e_cap = yd.shape[0] * yd.shape[1]

    def combine(yd, dst_g, keep_g, gs, toks):
        y_pair = yd.reshape(e_cap, d)[jnp.where(keep_g, dst_g, 0)]
        y_pair = jnp.where(keep_g[:, None], y_pair, 0) * gs[:, None]
        return jnp.zeros((tg, d), yd.dtype).at[toks].add(y_pair)

    return jax.jit(combine)(yd, dst, keep, gs, toks)


@pytest.mark.parametrize("g,tg,e,k,cap,ties", [
    (1, 24, 8, 2, 8, False), (4, 40, 8, 3, 8, False), (2, 64, 16, 4, 16,
                                                       False),
    (3, 17, 8, 2, 8, True)])
def test_combine_is_the_references_bit_for_bit(g, tg, e, k, cap, ties):
    """The combine on the same expert outputs: the port adds each token's
    pairs by ascending expert id onto a zero, the order in which XLA's
    scatter-add applies the reference's sorted updates, so every element
    equals the reference's bit for bit, drops included."""
    d = 16
    rng = np.random.default_rng(g * 100 + tg)
    x = rng.normal(size=(g, tg, d)).astype(np.float32)
    routes = [_routing(tg, e, k, seed=g * 10 + i, ties=ties)
              for i in range(g)]
    idx = np.stack([r[0] for r in routes])
    gates = np.stack([r[1] for r in routes])
    x_disp, dst, keep, g_sorted, _, order = moe._dispatch(
        torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates),
        e=e, cap=cap)
    y_disp = rng.normal(size=(g, e, cap, d)).astype(np.float32)
    got = moe._combine(torch.from_numpy(y_disp), dst, keep, g_sorted, order,
                       torch.from_numpy(idx)).numpy().reshape(g, tg, d)
    for i in range(g):
        _, r_dst, r_keep, r_gs, r_toks = ref_moe._dispatch_group(
            jnp.asarray(x[i]), jnp.asarray(idx[i]), jnp.asarray(gates[i]),
            e=e, cap=cap)
        want = _ref_combine(jnp.asarray(y_disp[i]), r_dst, r_keep, r_gs,
                            r_toks, tg, d)
        np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [16, 200, 4096])
def test_moe_ffn_matches_the_reference(arch, t):
    """One group below 4096 tokens, 32 groups at 4096; the default capacity
    factor (1.25), so pairs drop past capacity; llama4 adds its shared
    expert."""
    cfg, ref_cfg = configs(arch)
    p, ref_p = weights(ref_cfg)
    x = activations(t, cfg.d_model, seed=t)
    got = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    want = jax.jit(ref_moe.moe_ffn, static_argnums=1)(ref_p, ref_cfg,
                                                       jnp.asarray(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert normwise(got.numpy(), want) <= MOE_TOL


def _drops(p, cfg, x):
    """How many (token, expert) pairs moe_ffn drops on x."""
    m = cfg.moe
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    t = xf.shape[0]
    g = moe._n_groups(t)
    _, idx = moe._top_k(moe._route(p, xf), m.top_k)
    _, _, keep, _, _, _ = moe._dispatch(
        xf.reshape(g, t // g, -1), idx.reshape(g, t // g, -1),
        torch.ones(g, t // g, m.top_k), e=m.n_experts,
        cap=moe._capacity(t // g, cfg))
    return int((~keep).sum())


def test_moe_ffn_drops_past_capacity():
    """At 4096 tokens (32 groups of 128, cap 40 at smoke size) some pairs
    drop; at capacity factor 16 none do, and the output then equals the
    all-experts sum of each token's top-k (the reference's own check)."""
    cfg, ref_cfg = configs("qwen3-moe-30b-a3b")
    p, _ = weights(ref_cfg)
    x = activations(4096, cfg.d_model, seed=4096)
    assert _drops(p, cfg, x) > 0
    big, _ = configs("qwen3-moe-30b-a3b", capacity_factor=16.0)
    x = activations(32, cfg.d_model, seed=5)
    assert _drops(p, big, x) == 0
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model)).double()
    probs = torch.softmax(xf @ p["router"]["w"].double(), -1)
    g, idx = moe._top_k(probs, cfg.moe.top_k)
    g = g / g.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for j in range(cfg.moe.top_k):
        e = idx[:, j]
        h = torch.einsum("td,tdf->tf", xf, p["gate"].double()[e])
        u = torch.einsum("td,tdf->tf", xf, p["up"].double()[e])
        y = torch.einsum("tf,tfd->td", torch.nn.functional.silu(h) * u,
                         p["down"].double()[e])
        want += g[:, j, None] * y
    got = moe.moe_ffn(p, big, torch.from_numpy(x))
    assert normwise(got.numpy().reshape(-1, cfg.d_model), want) <= MOE_TOL


@pytest.mark.parametrize("t", [16, 4096])
def test_zero_router_ties_pick_the_lower_experts(t):
    """A zero router makes every probability equal: every token picks
    experts 0..k-1 (``lax.top_k``'s lower index first), so those experts
    overflow and most pairs drop; the output equals the reference's."""
    cfg, ref_cfg = configs("qwen3-moe-30b-a3b")
    p, ref_p = weights(ref_cfg)
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    ref_p = dict(ref_p, router={"w": jnp.zeros_like(ref_p["router"]["w"])})
    x = activations(t, cfg.d_model, seed=7)
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    vals, idx = moe._top_k(moe._route(p, xf), cfg.moe.top_k)
    assert (idx == torch.arange(cfg.moe.top_k)).all()
    assert (vals == 1.0 / cfg.moe.n_experts).all()
    assert _drops(p, cfg, x) >= t * cfg.moe.top_k // 2
    got = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    want = jax.jit(ref_moe.moe_ffn, static_argnums=1)(ref_p, ref_cfg,
                                                       jnp.asarray(x))
    assert normwise(got.numpy(), want) <= MOE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_the_reference(arch):
    cfg, ref_cfg = configs(arch)
    p, ref_p = weights(ref_cfg)
    for t in (16, 300):
        x = activations(t, cfg.d_model, seed=t + 1)
        got = float(moe.moe_aux_loss(p, cfg, torch.from_numpy(x)))
        want = float(ref_moe.moe_aux_loss(ref_p, ref_cfg, jnp.asarray(x)))
        assert abs(got - want) <= AUX_TOL * abs(want)
    # a zero router: every token's top-1 is expert 0 with prob 1/E
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    assert float(moe.moe_aux_loss(p, cfg, torch.from_numpy(x))) == 1.0


@pytest.mark.parametrize("t,d,e,k", [(32, 16, 8, 2), (64, 24, 16, 4)])
def test_moe_dispatch_spgemm_on_the_host(t, d, e, k):
    """The dispatch through the host backend in f64: the dense per-expert
    weighted token sums at rtol 1e-8 (the reference's own test), and the
    reference's own ``moe_dispatch_spgemm`` bit for bit (the host backend
    is the reference's, product for product)."""
    x = np.random.default_rng(0).normal(size=(t, d))
    probs = np.random.default_rng(1).uniform(size=(t, e))
    idx = np.argsort(-probs, axis=1)[:, :k].astype(np.int32)
    gates = np.take_along_axis(probs, idx, axis=1)
    got = moe.moe_dispatch_spgemm(x, idx, gates, e, device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == (e, d)
    r = np.zeros((t, e))
    np.put_along_axis(r, idx, gates, axis=1)
    np.testing.assert_allclose(got.numpy(), r.T @ x, rtol=1e-8, atol=1e-10)
    want = ref_moe.moe_dispatch_spgemm(x, idx, gates, e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # integer values: exact
    xi = np.random.default_rng(2).integers(-2, 3, size=(t, d)).astype(float)
    gi = np.random.default_rng(3).integers(1, 4, size=(t, k)).astype(float)
    got = moe.moe_dispatch_spgemm(xi, idx, gi, e, device="cpu")
    r = np.zeros((t, e))
    np.put_along_axis(r, idx, gi, axis=1)
    np.testing.assert_array_equal(got.numpy(), r.T @ xi)
