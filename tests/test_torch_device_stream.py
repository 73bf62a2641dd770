"""The port's device stream (``backend="torch"``, ``core.device_stream``)
against the JAX package's (``backend="jax"``, ``core/jax_stream.py``), on
the CPU, mirroring ``test_jax_stream.py``:

- the torch engine equals the reference's jax stream on every adversarial
  case of the differential harness: structure bit for bit, values exact on
  integer inputs and within the reference's rtol 1e-5 / atol 1e-6 on real
  ones; on integer inputs it equals the naive oracles exactly;
- gradients through ``plan.stream_apply`` equal finite differences, the
  dense-matmul gradient and the reference's ``jax.grad``;
- ``[B, nnz]`` stacks (the reference's ``vmap``) equal a loop bit for bit,
  forward and gradients, on both stream engines (the torch stream and K1),
  at B = 1, 3 and 8;
- the guard (a transient stream on the plan's device, where the reference
  falls back to its host engine), capability errors, the canonical plan
  every method spelling shares, ``stream_apply`` on ``"cuda"`` plans and
  the device-stream bytes of the plan LRU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import plan_spgemm as ref_plan_spgemm
from repro_torch.core import (
    backend_names,
    device_stream,
    get_backend,
    plan_cache_clear,
    plan_cache_info,
    plan_spgemm,
    spgemm,
    spgemm_batched,
    stream_fn,
    stream_fn_batched,
)
from repro_torch.core.api import cached_plan
from repro_torch.core.reference import dense_product
from repro_torch.sparse import generate
from repro_torch.sparse.format import BatchedCSC, _np, csc_from_dense, \
    csc_to_dense
from torch_parity import ADVERSARIAL, adversarial, assert_same_csc, \
    integer_valued, to_ref

RTOL, ATOL = 1e-5, 1e-6     # the reference's own (tests/test_jax_stream.py)
F32 = np.float32


def _f32(m):
    return _np(m.values)[: m.nnz].astype(F32)


def _operands(case, values):
    a, b = adversarial(case)
    if values == "int":
        same = a is b
        a = integer_valued(a, seed=1)
        b = a if same else integer_valued(b, seed=2)
    return a, b


# --- forward: the torch stream against the reference's jax stream -----------


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_torch_stream_matches_reference_jax_stream(case, values):
    a, b = _operands(case, values)
    ra, rb = to_ref(a), to_ref(b)
    want = ref_plan_spgemm(ra, rb, "expand", backend="jax").execute(ra, rb)
    plan = plan_spgemm(a, b, backend="torch", device="cpu")
    stats: dict = {}
    got = plan.execute(a, b, stats=stats)
    assert stats["engine"] == "stream" and stats["stream_cached"]
    assert_same_csc(got, want, exact=values == "int", rtol=RTOL, atol=ATOL)
    # the default method spelling and spgemm() reach the same plan
    again = spgemm(a, b, backend="torch", device="cpu", cache=False)
    assert torch.equal(again.values, got.values)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_integer_exact_vs_naive_oracles(case):
    """On integer values no sum rounds: the torch stream equals the host
    oracles (f64) exactly, whatever their order."""
    a, b = _operands(case, "int")
    c = spgemm(a, b, backend="torch", device="cpu", cache=False)
    want = dense_product(a, b)
    got = csc_to_dense(c).double()
    assert torch.equal(got, want)
    for method in ("spa", "expand", "h-hash-256/256"):
        host = spgemm(a, b, method, backend="host", engine="naive",
                      cache=False)
        assert torch.equal(csc_to_dense(host).double(), want), method


def test_torch_stream_equals_fused_engine_on_the_cpu():
    """On the CPU both lowerings add each slot left to right from 0: the
    torch stream equals K1's plain version bit for bit on real values."""
    a = generate.random_powerlaw_csc(40, 3.0, seed=2)
    plan = plan_spgemm(a, a, backend="torch", device="cpu")
    assert torch.equal(plan.execute(a, a).values,
                       plan.execute(a, a, engine="fused").values)


# --- gradients --------------------------------------------------------------


def _stored_coords(m):
    cp = _np(m.col_ptr).astype(np.int64)
    rows = torch.from_numpy(_np(m.row_indices)[: cp[-1]].astype(np.int64))
    cols = torch.from_numpy(np.repeat(np.arange(m.n_cols), np.diff(cp)))
    return rows, cols


@pytest.mark.parametrize("case", ("random", "dup_heavy", "single_row",
                                  "rect_chain"))
def test_grad_matches_finite_differences(case):
    a, b = adversarial(case)
    plan = plan_spgemm(a, b, backend="torch", device="cpu")
    av, bv = _f32(a), _f32(b)

    def loss(x, y):
        return float(plan.stream_apply(torch.from_numpy(x),
                                       torch.from_numpy(y)).sum())

    x = torch.from_numpy(av).requires_grad_()
    y = torch.from_numpy(bv).requires_grad_()
    ga, gb = torch.autograd.grad(plan.stream_apply(x, y).sum(), (x, y))
    assert ga.shape == x.shape and gb.shape == y.shape
    rng = np.random.default_rng(0)
    eps = 1e-2
    for arr, grad, which in ((av, ga, 0), (bv, gb, 1)):
        for i in rng.choice(len(arr), size=min(4, len(arr)), replace=False):
            hi, lo = arr.copy(), arr.copy()
            hi[i] += eps
            lo[i] -= eps
            args = [(hi, bv), (lo, bv)] if which == 0 else [(av, hi),
                                                           (av, lo)]
            fd = (loss(*args[0]) - loss(*args[1])) / (2 * eps)
            np.testing.assert_allclose(float(grad[i]), fd, rtol=5e-2,
                                       atol=5e-3)


@pytest.mark.parametrize("case", ("random", "dup_heavy", "rect_chain"))
def test_grad_matches_dense_matmul_oracle(case):
    a, b = adversarial(case)
    plan = plan_spgemm(a, b, backend="torch", device="cpu")
    x = torch.from_numpy(_f32(a)).requires_grad_()
    y = torch.from_numpy(_f32(b)).requires_grad_()
    ga, gb = torch.autograd.grad(plan.stream_apply(x, y).sum(), (x, y))
    xd = x.detach().double().requires_grad_()
    yd = y.detach().double().requires_grad_()
    ad = torch.zeros(a.shape, dtype=torch.float64).index_put(
        _stored_coords(a), xd)
    bd = torch.zeros(b.shape, dtype=torch.float64).index_put(
        _stored_coords(b), yd)
    da, db = torch.autograd.grad((ad @ bd).sum(), (xd, yd))
    np.testing.assert_allclose(ga.numpy(), da.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), db.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("engine", [None, "fused"])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_grad_matches_reference_jax_grad(case, engine):
    """Forward and both gradients of ``sum(w * C)`` against the reference's
    jax stream under ``jax.grad``: exact on integer values, within the
    reference's tolerance on real ones."""
    for values in ("int", "real"):
        a, b = _operands(case, values)
        ra, rb = to_ref(a), to_ref(b)
        ref_plan = ref_plan_spgemm(ra, rb, "expand", backend="jax")
        av, bv = _f32(a), _f32(b)
        n_c = ref_plan.stream.nnz
        w = np.random.default_rng(3).integers(-3, 4, n_c).astype(F32)
        c_ref, pull = jax.vjp(ref_plan.stream_apply, jnp.asarray(av),
                              jnp.asarray(bv))
        ga_ref, gb_ref = (np.asarray(g) for g in pull(jnp.asarray(w)))
        plan = plan_spgemm(a, b, backend="torch", device="cpu")
        x = torch.from_numpy(av).requires_grad_()
        y = torch.from_numpy(bv).requires_grad_()
        c = plan.stream_apply(x, y, engine=engine)
        ga, gb = torch.autograd.grad((torch.from_numpy(w) * c).sum(), (x, y))
        for got, want in ((c.detach(), c_ref), (ga, ga_ref), (gb, gb_ref)):
            if values == "int":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=RTOL, atol=ATOL)


# --- batched: [B, nnz] stacks equal a loop, both engines ---------------------


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("engine", [None, "fused"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_forward_and_grads_equal_looped(backend, engine, batch):
    a = generate.random_powerlaw_csc(36, 3.0, seed=4)
    plan = plan_spgemm(a, a, backend=backend, device="cpu")
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.normal(size=(batch, a.nnz)).astype(F32))
    ys = torch.from_numpy(rng.normal(size=(batch, a.nnz)).astype(F32))
    w = torch.from_numpy(rng.normal(size=(batch, plan.stream.nnz))
                         .astype(F32))
    x, y = xs.clone().requires_grad_(), ys.clone().requires_grad_()
    c = plan.stream_apply(x, y, engine=engine)
    assert c.shape == (batch, plan.stream.nnz)
    gx, gy = torch.autograd.grad((w * c).sum(), (x, y))
    for k in range(batch):
        xk, yk = xs[k].clone().requires_grad_(), ys[k].clone() \
            .requires_grad_()
        ck = plan.stream_apply(xk, yk, engine=engine)
        gxk, gyk = torch.autograd.grad((w[k] * ck).sum(), (xk, yk))
        assert torch.equal(c[k], ck) and torch.equal(gx[k], gxk) \
            and torch.equal(gy[k], gyk)
    stats: dict = {}
    outs = plan.execute_batched(xs, ys, engine=engine or (
        "stream" if backend == "torch" else "fused"), stats=stats)
    assert stats["batch"] == batch
    for k, o in enumerate(outs):
        assert torch.equal(o.values, c[k].detach())


def test_stream_fn_batched_takes_stacks_only():
    a = generate.random_powerlaw_csc(20, 2.0, seed=6)
    plan = plan_spgemm(a, a, backend="torch", device="cpu")
    assert stream_fn(plan) is stream_fn(plan)        # kept on the plan
    v = torch.from_numpy(_f32(a))
    with pytest.raises(ValueError, match="stacks"):
        stream_fn_batched(plan)(v, v)
    out = stream_fn_batched(plan)(v[None], v[None])
    assert torch.equal(out[0], stream_fn(plan)(v, v))
    with pytest.raises(ValueError, match="batch mismatch"):
        plan.stream_apply(torch.stack([v, v]), v[None])


def test_spgemm_batched_rides_the_torch_backend():
    a = generate.random_powerlaw_csc(30, 2.5, seed=6)
    rng = np.random.default_rng(7)
    ab = BatchedCSC.from_values(a, torch.from_numpy(
        rng.normal(size=(3, a.nnz)).astype(F32)))
    stats: dict = {}
    plan = plan_spgemm(a, a, backend="torch", device="cpu")
    got = spgemm_batched(ab, ab, backend="torch", device="cpu", cache=False)
    again = plan.execute_batched(ab, ab, stats=stats)
    assert stats["path"] == "flat" and stats["batch"] == 3
    for k in range(3):
        want = plan.execute(ab[k], ab[k])
        assert torch.equal(got[k].values, want.values)
        assert torch.equal(again[k].values, want.values)
        assert again[k].row_indices is again[0].row_indices


# --- the guard --------------------------------------------------------------


def test_guarded_plan_runs_a_transient_stream_on_its_device():
    """Past the guard the reference falls back to its host engine; the port
    builds the stream on the plan's device for the call and keeps nothing:
    the same values as an unguarded plan, bit for bit."""
    a = generate.random_powerlaw_csc(40, 3.0, seed=10)
    guarded = plan_spgemm(a, a, backend="torch", device="cpu",
                          stream_limit=1)
    full = plan_spgemm(a, a, backend="torch", device="cpu")
    stats: dict = {}
    c = guarded.execute(a, a, stats=stats)
    assert stats["stream_cached"] is False and stats["backend"] == "torch"
    assert guarded.stream is None and guarded.device_stream_nbytes == 0
    assert torch.equal(c.values, full.execute(a, a).values)
    vals = torch.from_numpy(np.random.default_rng(11).normal(
        size=(3, a.nnz)).astype(F32))
    for x, y in zip(guarded.execute_batched(vals, vals),
                    full.execute_batched(vals, vals)):
        assert torch.equal(x.values, y.values)
    with pytest.raises(ValueError, match="guard"):
        guarded.stream_apply(vals[0], vals[0])
    with pytest.raises(ValueError, match="guard"):
        stream_fn(guarded)


# --- validation, capability errors, the registry ----------------------------


def _colliding_pair(n=16):
    a = csc_from_dense(np.eye(n))
    b = csc_from_dense(np.roll(np.eye(n), 1, axis=0))
    assert a.shape == b.shape and a.nnz == b.nnz
    return a, b


@pytest.mark.parametrize("backend, engine", [("host", "stream"),
                                             ("torch", None),
                                             ("torch", "fused")])
def test_validate_fingerprint_covers_stream_engines(backend, engine):
    a, corrupt = _colliding_pair()
    kw = {} if backend == "host" else dict(device="cpu")
    plan = plan_spgemm(a, a, "expand", backend=backend, **kw)
    plan.execute(corrupt, corrupt, engine=engine)   # O(1) check: accepted
    with pytest.raises(ValueError, match="fingerprint"):
        plan.execute(corrupt, corrupt, engine=engine,
                     validate="fingerprint")
    assert plan.execute(a, a, engine=engine,
                        validate="fingerprint").shape == (16, 16)
    bad = BatchedCSC.stack([corrupt, corrupt])
    with pytest.raises(ValueError, match="fingerprint"):
        plan.execute_batched(bad, bad, engine=engine,
                             validate="fingerprint")
    good = BatchedCSC.stack([a, a])
    plan.execute_batched(good, good, engine=engine, validate="fingerprint")


def test_engine_capability_errors():
    a = generate.random_powerlaw_csc(20, 2.0, seed=13)
    pt = plan_spgemm(a, a, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        pt.execute(a, a, engine="bogus")
    # the torch backend has no naive oracles
    with pytest.raises(ValueError, match="naive"):
        pt.execute(a, a, engine="naive")
    v = torch.stack([a.values] * 2)
    with pytest.raises(ValueError, match="naive"):
        pt.execute_batched(v, v, engine="naive")
    ab = BatchedCSC.stack([a, a])
    with pytest.raises(ValueError, match="naive"):
        spgemm_batched(ab, ab, backend="torch", engine="naive",
                       device="cpu", cache=False)
    with pytest.raises(ValueError, match="host-backend or torch-backend"):
        spgemm(a, a, "spa", backend="cuda", engine="stream", device="cpu",
               cache=False)
    with pytest.raises(ValueError, match="validate"):
        pt.execute(a, a, validate="bogus")


def test_backend_registry_contracts():
    assert set(backend_names()) == {"host", "cuda", "torch"}
    host, cuda, tch = (get_backend(n) for n in ("host", "cuda", "torch"))
    assert host.bit_exact_oracle and not host.supports_grad
    assert not host.device_resident and host.carries_stream
    assert tch.supports_grad and tch.device_resident and tch.carries_stream
    assert not tch.bit_exact_oracle and tch.canonical_method == "expand"
    assert tch.engines == (None, "stream", "fused")
    assert tch.default_engine == "stream"
    assert cuda.carries_stream and "expand" in cuda.excluded_methods
    assert "fused" in cuda.engines and "fused" in tch.engines
    for name in ("jax", "pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            get_backend(name)
    with pytest.raises(ValueError, match="unknown backend"):
        spgemm(a := generate.random_powerlaw_csc(8, 1.0, seed=0), a,
               backend="jax", device="cpu")


def test_torch_method_spellings_share_one_canonical_plan():
    plan_cache_clear()
    a = generate.random_powerlaw_csc(26, 2.5, seed=18)
    p1 = cached_plan(a, a, "expand", backend="torch", device="cpu")
    p2 = cached_plan(a, a, "spa", backend="torch", device="cpu")
    p3 = cached_plan(a, a, "h-hash-256/256", backend="torch", device="cpu")
    assert p1 is p2 is p3 and p1.method == "expand" and p1.params == ()
    assert plan_cache_info()["size"] == 1
    assert plan_spgemm(a, a, "spa", backend="torch",
                       device="cpu").method == "expand"
    for fn in (lambda: spgemm(a, a, "h-hash-256/256", backend="torch",
                              b_min=8, device="cpu", cache=False),
               lambda: plan_spgemm(a, a, "h-hash-256/256", backend="torch",
                                   b_min=8, device="cpu"),
               lambda: cached_plan(a, a, "h-hash-256/256", backend="torch",
                                   t=10.0, device="cpu")):
        with pytest.raises(ValueError, match="do not apply"):
            fn()
    # a named method whose defaults carry knobs still collapses
    assert spgemm(a, a, "h-hash-256/256", backend="torch", device="cpu",
                  cache=False).nnz == p1.execute(a, a).nnz
    plan_cache_clear()


def test_stream_apply_works_on_cuda_plans():
    """``stream_apply(engine=None)`` on a per-group plan runs the torch
    stream over that plan's stream: the host stream's values."""
    a = generate.random_powerlaw_csc(20, 2.0, seed=19)
    cuda_plan = plan_spgemm(a, a, "spa", device="cpu")
    host_plan = plan_spgemm(a, a, "expand", backend="host")
    v = torch.from_numpy(_f32(a))
    vals = cuda_plan.stream_apply(v, v)
    ref = host_plan.execute(a, a, engine="stream")
    np.testing.assert_allclose(vals.numpy(), _np(ref.values), rtol=2e-6)
    assert cuda_plan.device_stream_nbytes > 0


def test_stream_apply_checks_operand_shapes():
    a = generate.random_powerlaw_csc(22, 2.0, seed=20)
    plan = plan_spgemm(a, a, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="values"):
        plan.stream_apply(torch.zeros(2), torch.zeros(a.nnz))
    with pytest.raises(ValueError, match="1-D"):
        plan.stream_apply(torch.zeros((2, a.nnz)), torch.zeros(a.nnz))


def test_device_stream_bytes_reported_separately():
    plan_cache_clear()
    a = generate.random_powerlaw_csc(32, 3.0, seed=14)
    spgemm(a, a, "expand", backend="host")              # host stream
    info = plan_cache_info()
    assert info["stream_bytes"] > 0 and info["device_stream_bytes"] == 0
    spgemm(a, a, backend="torch", device="cpu")
    info = plan_cache_info()
    plan = cached_plan(a, a, backend="torch", device="cpu")
    ds = device_stream(plan)
    assert info["device_stream_bytes"] == ds.nbytes > 0
    assert info["fused_stream_bytes"] == 0
    # the torch plan keeps the host stream it was lifted from
    assert plan.stream_nbytes > 0
    # the gradient replays are held from the first execute on
    assert ds.grad_a is not None and ds.grad_b is not None
    plan_cache_clear()


def test_torch_backend_without_device_needs_a_card():
    """device=None means the card on the torch backend too: with none
    present it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    a = generate.random_uniform_csc(16, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm(a, a, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_spgemm(a, a, backend="torch")
    s = BatchedCSC.from_values(a, torch.ones((2, a.nnz)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm_batched(s, s, backend="torch")
