"""The port's SpGEMM mesh (``backend="mesh"``, ``repro_torch.distributed``)
against the JAX package's, on the CPU, mirroring
``tests/test_distributed_spgemm.py``.

Every shard runs on the CPU (``device="cpu"``), each replaying its own
slice, the bins reduced in shard order: the port's counterpart of the
reference's forced host devices.  On the same seeded inputs:

- the plans equal the reference's field by field (grid, tiles, placement,
  predicted cost and flops, each shard's index stream, the output
  structure, the slot axis), and planning errors name the same things;
- on integer-valued operands C equals the reference's host stream
  (``backend="host", engine="stream"``) bit for bit at 1, 2, 4 and 8
  shards, and the reference's real 8-device mesh (a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``) bit for bit, with
  its gradients; on normal reals within rtol 1e-5 / atol 1e-6;
- ``estimate_mesh_cost`` and ``should_distribute`` equal the reference's
  to the float, the ``comm`` ladder fits ``comm_base`` alone on one
  device, and the two examples run on the CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan_cache_clear as ref_plan_cache_clear
from repro.core import plan_spgemm as ref_plan_spgemm
from repro.core.cost import estimate_mesh_cost as ref_estimate_mesh_cost
from repro.core.cost import should_distribute as ref_should_distribute
from repro.core.executor import execute as ref_execute
from repro.distributed import plan_spgemm_mesh as ref_plan_spgemm_mesh
from repro.sparse.stats import TileStats as RefTileStats
from repro.sparse.stats import tile_stats as ref_tile_stats
from repro_torch.core import api, cached_plan, fast, plan_cache_clear, \
    plan_spgemm, profile, spgemm, spgemm_batched
from repro_torch.core.cost import estimate_mesh_cost, should_distribute
from repro_torch.core.executor import execute, execute_batched
from repro_torch.distributed import ShardedSpgemmPlan, plan_spgemm_mesh
from repro_torch.distributed.spgemm_mesh import _ops_balanced_bounds, \
    reduce_bins
from repro_torch.sparse import random_density_csc, random_uniform_csc
from repro_torch.sparse.format import CSC, BatchedCSC, _np
from repro_torch.sparse.generate import random_banded_csc, \
    random_powerlaw_csc
from repro_torch.sparse.stats import TileStats, ops_per_column, tile_stats
from torch_parity import adversarial, to_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6     # C5's: the reduction orders differ on reals
CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_cache():
    plan_cache_clear()
    ref_plan_cache_clear()
    yield
    plan_cache_clear()
    ref_plan_cache_clear()


def _int_csc(n, z, seed, n_rows):
    """Integer-valued f32 operand (the reference test's): every sum is
    exact, so every order gives the same bits."""
    m = random_uniform_csc(n, z, seed=seed, n_rows=n_rows)
    rng = np.random.default_rng(seed + 100)
    return CSC(torch.from_numpy(rng.integers(1, 8, m.nnz).astype(np.float32)),
               m.row_indices, m.col_ptr, m.shape)


def _with_values(m, values):
    return CSC(torch.from_numpy(np.ascontiguousarray(values, np.float32)),
               _np(m.row_indices)[: m.nnz], _np(m.col_ptr), tuple(m.shape))


def _host_oracle(a, b):
    """The reference's host stream, guard lifted, on the same operands."""
    ra, rb = to_ref(a), to_ref(b)
    plan = ref_plan_spgemm(ra, rb, "expand", backend="host",
                           stream_limit=10**12)
    return ref_execute(plan, ra, rb, engine="stream")


def _assert_bits(got, want):
    """The port's CSC equals a reference CSC bit for bit (f32 values)."""
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got.col_ptr), np.asarray(want.col_ptr))
    nnz = got.nnz
    np.testing.assert_array_equal(_np(got.row_indices)[:nnz],
                                  np.asarray(want.row_indices)[:nnz])
    gv = _np(got.values)[:nnz]
    wv = np.asarray(want.values)[:nnz].astype(np.float32)
    assert gv.dtype == np.float32
    assert np.array_equal(gv.view(np.uint32), wv.view(np.uint32))


def _leaf(x):
    return x.detach().clone().requires_grad_()


def _grads(apply, av, bv):
    x, y = _leaf(av), _leaf(bv)
    return torch.autograd.grad((apply(x, y) ** 2).sum(), (x, y))


# --- planning --------------------------------------------------------------


def test_ops_balanced_bounds_properties():
    ops = np.array([100, 1, 1, 1, 100, 1, 1, 1, 100, 1])
    bounds = _ops_balanced_bounds(ops, 3)
    assert bounds[0] == 0 and bounds[-1] == len(ops)
    assert np.all(np.diff(bounds) >= 1)
    blk = np.add.reduceat(ops, bounds[:-1])
    assert blk.max() < ops.sum()
    assert len(_ops_balanced_bounds(np.zeros(0, np.int64), 4)) == 1
    assert list(_ops_balanced_bounds(np.array([5]), 4)) == [0, 1]


def test_mesh_plan_structure_and_guard():
    a = _int_csc(60, 6, seed=0, n_rows=50)
    b = _int_csc(40, 5, seed=1, n_rows=60)
    total = int(ops_per_column(a, b).sum())
    plan = plan_spgemm_mesh(a, b, shards=1, shard_limit=2 * total,
                            device=CPU)
    assert isinstance(plan, ShardedSpgemmPlan)
    assert plan.backend == "mesh" and plan.method == "expand"
    assert plan.shape == (50, 40)
    assert plan.n_shards == 1
    assert int(plan.predicted_flops.sum()) == total
    assert plan.imbalance >= 1.0
    ss = plan.stream
    assert ss.n_products == total
    assert ss.padded_slots % plan.n_shards == 0
    assert ss.padded_slots > ss.num_slots   # a slot past nnz_c exists
    assert int(ss.per_device.sum()) == total
    assert plan.mesh_stream_nbytes == ss.nbytes > 0
    # the children are expand plans on the torch backend, in the LRU
    assert all(t.plan.backend == "torch" and t.plan.method == "expand"
               for t in plan.tiles)
    # the shards' device views count once lifted
    plan.execute(a, b)
    assert plan.mesh_stream_nbytes > ss.nbytes


def test_mesh_plan_overfull_raises():
    a = _int_csc(60, 6, seed=0, n_rows=50)
    b = _int_csc(40, 5, seed=1, n_rows=60)
    total = int(ops_per_column(a, b).sum())
    with pytest.raises(ValueError, match="shard_limit"):
        plan_spgemm_mesh(a, b, shards=1, shard_limit=total // 4, device=CPU)


def test_mesh_shards_validation():
    a = _int_csc(10, 2, seed=0, n_rows=10)
    with pytest.raises(ValueError, match="shards"):
        plan_spgemm_mesh(a, a, shards=0, device=CPU)
    with pytest.raises(ValueError, match="shape mismatch"):
        plan_spgemm_mesh(a, _int_csc(5, 2, seed=0, n_rows=9), device=CPU)
    with pytest.raises(ValueError, match="backend='mesh'"):
        spgemm(a, a, "expand", backend="host", shards=2)
    for be in ("torch", "cuda"):
        with pytest.raises(ValueError, match="backend='mesh'"):
            plan_spgemm(a, a, "expand", backend=be, shards=2, device=CPU)
        with pytest.raises(ValueError, match="backend='mesh'"):
            cached_plan(a, a, backend=be, shards=2, device=CPU)
    with pytest.raises(ValueError, match="t/b_min/b_max"):
        spgemm(a, a, "spa", backend="mesh", t=3.0, shards=1, device=CPU)


# --- execution: bit-identity, grads, batched -------------------------------


def test_mesh_bit_matches_guard_lifted_host_stream():
    a = _int_csc(60, 6, seed=0, n_rows=50)
    b = _int_csc(40, 5, seed=1, n_rows=60)
    # a real multi-tile grid (k and n both split) on one shard
    plan = plan_spgemm_mesh(a, b, shards=1, tile=(20, 8), device=CPU)
    assert len(plan.tiles) > 4
    _assert_bits(plan.execute(a, b), _host_oracle(a, b))


def test_mesh_execution_is_deterministic():
    a = _int_csc(50, 5, seed=4, n_rows=45)
    b = _int_csc(35, 4, seed=5, n_rows=50)
    plan = plan_spgemm_mesh(a, b, shards=1, device=CPU)
    c1 = _np(plan.execute(a, b).values)
    c2 = _np(plan.execute(a, b).values)
    assert np.array_equal(c1.view(np.uint32), c2.view(np.uint32))


@pytest.mark.parametrize("shards", [1, 3])
def test_mesh_gradients_match_single_device_stream(shards):
    a = _int_csc(50, 5, seed=2, n_rows=40)
    b = _int_csc(30, 4, seed=3, n_rows=50)
    mesh_plan = plan_spgemm_mesh(a, b, shards=shards, tile=(None, 4),
                                 device=CPU)
    torch_plan = plan_spgemm(a, b, "expand", backend="torch", device=CPU)
    av, bv = a.values, b.values
    ga_m, gb_m = _grads(mesh_plan.stream_apply, av, bv)
    ga_t, gb_t = _grads(torch_plan.stream_apply, av, bv)
    assert torch.equal(ga_m, ga_t) and torch.equal(gb_m, gb_t)


def test_mesh_stream_apply_matches_execute():
    """The reference holds its jitted stream_apply to the eager one; here
    the differentiable form equals the executor's forward bit for bit."""
    a = _int_csc(40, 4, seed=6, n_rows=30)
    b = _int_csc(25, 3, seed=7, n_rows=40)
    plan = plan_spgemm_mesh(a, b, shards=2, device=CPU)
    eager = plan.stream_apply(a.values, b.values)
    assert torch.equal(eager, plan.execute(a, b).values)
    with torch.no_grad():
        assert torch.equal(plan.stream_apply(a.values, b.values), eager)


def test_mesh_batched_matches_loop():
    a = _int_csc(40, 4, seed=8, n_rows=30)
    b = _int_csc(25, 3, seed=9, n_rows=40)
    plan = plan_spgemm_mesh(a, b, shards=2, device=CPU)
    B = 3
    av = (torch.stack([a.values] * B)
          * torch.arange(1, B + 1, dtype=torch.float32)[:, None])
    bv = torch.stack([b.values] * B)
    stats = {}
    outs = execute_batched(plan, av, bv, stats=stats)
    assert len(outs) == B and stats["batch"] == B
    for i in range(B):
        ci = execute(plan, av[i], bv[i])
        assert torch.equal(outs[i].values, ci.values)
    got = spgemm_batched(BatchedCSC.from_values(a, av),
                         BatchedCSC.from_values(b, bv), "expand",
                         backend="mesh", shards=2, device=CPU)
    for i in range(B):
        assert torch.equal(got[i].values, outs[i].values)


def test_mesh_empty_operand():
    b = _int_csc(20, 3, seed=10, n_rows=30)
    ea = CSC(torch.zeros(0), np.zeros(0, np.int32), np.zeros(31, np.int32),
             (25, 30))
    plan = plan_spgemm_mesh(ea, b, shards=2, device=CPU)
    c = plan.execute(ea, b)
    assert c.shape == (25, 20) and c.nnz == 0
    # the gradient of the empty contraction is zero, not an error
    y = _leaf(b.values)
    (g,) = torch.autograd.grad(plan.stream_apply(ea.values, y).sum(), (y,),
                               allow_unused=True)
    assert g is None or torch.equal(g, torch.zeros(b.nnz))


def test_mesh_oversized_value_arrays():
    # value arrays padded past nnz: the cotangent takes their shape, with a
    # zero tail
    a = _int_csc(30, 3, seed=11, n_rows=25)
    b = _int_csc(20, 3, seed=12, n_rows=30)
    plan = plan_spgemm_mesh(a, b, shards=2, device=CPU)
    pad = 7
    av = torch.cat([a.values, torch.full((pad,), 99.0)])
    ref = plan.stream_apply(a.values, b.values)
    assert torch.equal(plan.stream_apply(av, b.values), ref)
    x = _leaf(av)
    (ga,) = torch.autograd.grad(plan.stream_apply(x, b.values).sum(), (x,))
    assert ga.shape == av.shape
    assert torch.equal(ga[a.nnz:], torch.zeros(pad))


# --- api threading: cache, auto, executor contract -------------------------


def test_spgemm_mesh_through_api_and_cache():
    a = _int_csc(50, 5, seed=2, n_rows=40)
    b = _int_csc(30, 4, seed=3, n_rows=50)
    stats = {}
    c = spgemm(a, b, "expand", backend="mesh", shards=1, device=CPU)
    _assert_bits(c, _host_oracle(a, b))
    key = api.plan_cache_key(a, b, "expand", backend="mesh", shards=1,
                             device=CPU)
    plan = api.plan_cache_peek(key)
    assert plan is not None and plan.backend == "mesh"
    assert plan.cache_key == key
    assert cached_plan(a, b, "expand", backend="mesh", shards=1,
                       device=CPU) is plan
    # method spellings collapse to the canonical stream contraction
    assert cached_plan(a, b, "spa", backend="mesh", shards=1,
                       device=CPU) is plan
    info = api.plan_cache_info()
    assert info["mesh_stream_bytes"] >= plan.mesh_stream_nbytes > 0
    plan.execute(a, b, stats=stats)
    assert stats["backend"] == "mesh" and stats["shards"] == 1
    assert stats["stream_products"] == plan.stream.n_products
    with pytest.raises(ValueError, match="shards=2"):
        spgemm(a, b, plan=plan, shards=2)
    with pytest.raises(ValueError, match="engine"):
        plan.execute(a, b, engine="fused")


def test_mesh_plans_key_on_shard_count():
    a = _int_csc(30, 3, seed=13, n_rows=25)
    b = _int_csc(20, 3, seed=14, n_rows=30)
    k1 = api.plan_cache_key(a, b, "expand", backend="mesh", shards=1,
                            device=CPU)
    k2 = api.plan_cache_key(a, b, "expand", backend="mesh", shards=4,
                            device=CPU)
    k3 = api.plan_cache_key(a, b, "expand", backend="mesh", shards=4,
                            device=CPU, stream_limit=99)
    k4 = api.plan_cache_key(a, b, "expand", backend="mesh", shards=4)
    assert len({k1, k2, k3, k4}) == 4


def test_auto_mesh_small_matrix_stays_single_device():
    a = _int_csc(30, 3, seed=15, n_rows=25)
    b = _int_csc(20, 3, seed=16, n_rows=30)
    assert not should_distribute(tile_stats(a, b), 8)
    c = spgemm(a, b, "auto", backend="mesh", shards=1, device=CPU)
    ref = spgemm(a, b, "auto", backend="torch", device=CPU)
    np.testing.assert_allclose(_np(c.values), _np(ref.values))


def test_auto_mesh_above_the_guard_distributes():
    a = _int_csc(60, 6, seed=0, n_rows=50)
    b = _int_csc(40, 5, seed=1, n_rows=60)
    total = int(ops_per_column(a, b).sum())
    guard = fast.STREAM_MAX_PRODUCTS
    fast.STREAM_MAX_PRODUCTS = total // 2
    c = spgemm(a, b, "auto", backend="mesh", shards=4, device=CPU)
    fast.STREAM_MAX_PRODUCTS = guard
    plans = [p for p in api.PLAN_CACHE._plans.values()
             if isinstance(p, ShardedSpgemmPlan)]
    assert len(plans) == 1 and plans[0].n_shards == 4
    _assert_bits(c, _host_oracle(a, b))


def test_should_distribute_above_guard():
    a = random_density_csc(64, 64, 0.3, seed=17)
    b = random_density_csc(64, 64, 0.3, seed=18)
    st = tile_stats(a, b)
    assert should_distribute(st, 8, shard_limit=st.flops // 2)
    assert not should_distribute(st, 1, shard_limit=st.flops // 2)
    assert not should_distribute(st, 8)


def test_estimate_mesh_cost_comm_terms():
    small = tile_stats(random_density_csc(64, 64, 0.4, seed=19),
                       random_density_csc(64, 64, 0.4, seed=20))
    assert estimate_mesh_cost(small, 2) > estimate_mesh_cost(small, 1)
    big_flops = 4 * fast.STREAM_MAX_PRODUCTS
    big = TileStats(m=10**5, k=10**5, n=10**5, nnz_a=10**6, nnz_b=10**6,
                    ops=np.array([big_flops], np.int64),
                    steps=np.array([1], np.int64))
    assert should_distribute(big, 8)
    assert estimate_mesh_cost(big, 8) < estimate_mesh_cost(big, 1)


def test_mesh_needs_enough_devices_at_execute():
    """``device=None`` runs shard d on ``cuda:d``: a plan for more shards
    than cards builds, and its execution raises naming ``device=``."""
    a = _int_csc(30, 3, seed=21, n_rows=25)
    b = _int_csc(20, 3, seed=22, n_rows=30)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    plan = plan_spgemm_mesh(a, b, shards=cards + 1)
    assert plan.device is None
    with pytest.raises(ValueError, match="device="):
        plan.execute(a, b)
    if not cards:
        # the default shard count is the visible cards: none here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spgemm(a, b, "expand", backend="mesh")


# --- against the reference's plans, field by field -------------------------


def _pattern(i):
    """Twenty seeded operand pairs: uniform, Bernoulli, power-law, banded
    and the differential harness's structural edge cases."""
    if i < 6:
        n, z, m = (60, 40, 20, 33, 48, 70)[i], (6, 3, 2, 5, 4, 1)[i], \
            (50, 60, 45, 33, 52, 30)[i]
        return (random_uniform_csc(m, min(z, m), seed=i, n_rows=n),
                random_uniform_csc(40, min(z + 1, m), seed=i + 50, n_rows=m))
    if i < 10:
        j = i - 6
        return (random_density_csc(30 + 7 * j, 26 + 5 * j, 0.15, seed=i),
                random_density_csc(26 + 5 * j, 35, 0.2 + 0.05 * j,
                                   seed=i + 50))
    if i < 13:
        a = random_powerlaw_csc(40 + 10 * (i - 10), 3.0, seed=i)
        return a, a
    if i < 15:
        a = random_banded_csc(45, 2 + i - 13, fill=0.7, seed=i)
        return a, a
    names = ("empty_cols", "all_dense_cols", "single_row", "dup_heavy",
             "empty_a")
    return adversarial(names[i - 15], seed=i)


def _int_operands(i):
    a, b = _pattern(i)
    rng = np.random.default_rng([i, 7])
    return (_with_values(a, rng.integers(1, 4, a.nnz)),
            _with_values(b, rng.integers(1, 4, b.nnz)))


def _plan_both(a, b, **kw):
    """(port plan or error, reference plan or error)."""
    out = []
    for make in (lambda: plan_spgemm_mesh(a, b, device=CPU, **kw),
                 lambda: ref_plan_spgemm_mesh(to_ref(a), to_ref(b), **kw)):
        try:
            out.append(make())
        except ValueError as e:
            out.append(e)
    return out


def _assert_same_plan(p, r):
    assert p.params == r.params
    np.testing.assert_array_equal(p.k_bounds, r.k_bounds)
    np.testing.assert_array_equal(p.n_bounds, r.n_bounds)
    assert len(p.tiles) == len(r.tiles)
    for tp, tr in zip(p.tiles, r.tiles):
        assert (tp.k, tp.n, tuple(tp.a_vals)) == (tr.k, tr.n,
                                                  tuple(tr.a_vals))
        np.testing.assert_array_equal(tp.b_vals, tr.b_vals)
    np.testing.assert_array_equal(p.device_of, r.device_of)
    assert p.predicted_cost.dtype == r.predicted_cost.dtype == np.float64
    assert np.array_equal(p.predicted_cost, r.predicted_cost)
    np.testing.assert_array_equal(p.predicted_flops, r.predicted_flops)
    assert p.imbalance == r.imbalance
    ps, rs = p.stream, r.stream
    np.testing.assert_array_equal(ps.per_device, rs.per_device)
    for d in range(p.n_shards):
        n = int(rs.per_device[d])
        for got, want in ((ps.a_idx[d], rs.a_pos), (ps.b_idx[d], rs.b_pos),
                          (ps.seg[d], rs.seg)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(want)[d, :n])
    np.testing.assert_array_equal(ps.c_rows, rs.c_rows)
    np.testing.assert_array_equal(ps.c_col_ptr, rs.c_col_ptr)
    assert (ps.n_products, ps.num_slots, ps.padded_slots) == (
        rs.n_products, rs.num_slots, rs.padded_slots)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("case", range(20))
def test_plan_equals_reference(case, shards):
    """Plans equal the reference's field by field, errors name the same
    limit, and on integer values C equals the reference's host stream bit
    for bit, over the default guard and one a quarter of the stream, on
    the auto grid and a fixed one."""
    a, b = _int_operands(case)
    total = int(ops_per_column(a, b).sum())
    oracle = _host_oracle(a, b)
    for limit in (None, total // 4):
        for tile in (None, (7, 9)):
            p, r = _plan_both(a, b, shards=shards, shard_limit=limit,
                              tile=tile)
            if isinstance(r, ValueError):
                assert isinstance(p, ValueError), (limit, tile, r)
                assert str(p) == str(r)
                continue
            assert not isinstance(p, ValueError), (limit, tile, p)
            _assert_same_plan(p, r)
            _assert_bits(p.execute(a, b), oracle)


def test_planning_errors_name_the_reference_phrases():
    a, b = _int_operands(0)
    total = int(ops_per_column(a, b).sum())
    for kw, phrase in ((dict(shards=1, shard_limit=total // 4),
                        "shard_limit"),
                       (dict(shards=0), "shards"),
                       (dict(shards=2, shard_limit=0), "shard_limit")):
        p, r = _plan_both(a, b, **kw)
        assert isinstance(p, ValueError) and isinstance(r, ValueError)
        assert phrase in str(p) and str(p) == str(r)
    p, r = _plan_both(a, a, shards=2)
    assert "shape mismatch" in str(p) and str(p) == str(r)
    with pytest.raises(ValueError, match="backend='mesh'"):
        spgemm(a, b, "expand", backend="torch", shards=2, device=CPU)


# --- against the reference's real 8-device mesh ----------------------------


_REFERENCE_MESH = textwrap.dedent("""
    import json
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.distributed import plan_spgemm_mesh
    from repro.sparse import random_uniform_csc
    from repro.sparse.format import CSC

    assert len(jax.devices()) == 8, jax.devices()
    a0 = random_uniform_csc(160, 8, seed=0, n_rows=120)
    b0 = random_uniform_csc(120, 7, seed=1, n_rows=160)
    rng = np.random.default_rng(0)
    values = {
        "int": (rng.integers(1, 8, a0.nnz), rng.integers(1, 8, b0.nnz)),
        "real": (rng.standard_normal(a0.nnz), rng.standard_normal(b0.nnz)),
    }
    total = int(sum(np.diff(a0.col_ptr)[b0.row_indices]))
    out = {"limit": total // 4, "patterns": {}}
    for key, m in (("a", a0), ("b", b0)):
        out["patterns"][key] = dict(
            rows=np.asarray(m.row_indices).tolist(),
            col_ptr=np.asarray(m.col_ptr).tolist(), shape=list(m.shape))
    for name, (av, bv) in values.items():
        a = CSC(av.astype(np.float32), a0.row_indices, a0.col_ptr, a0.shape)
        b = CSC(bv.astype(np.float32), b0.row_indices, b0.col_ptr, b0.shape)
        plan = plan_spgemm_mesh(a, b, shards=8, shard_limit=total // 4)
        c = plan.execute(a, b)
        loss = lambda x, y: jnp.sum(plan.stream_apply(x, y) ** 2)
        ga, gb = jax.grad(loss, (0, 1))(jnp.asarray(a.values),
                                        jnp.asarray(b.values))
        out[name] = dict(
            a_values=a.values.tolist(), b_values=b.values.tolist(),
            c_col_ptr=np.asarray(c.col_ptr).tolist(),
            c_rows=np.asarray(c.row_indices).tolist(),
            c_values=np.asarray(c.values).tolist(),
            ga=np.asarray(ga).tolist(), gb=np.asarray(gb).tolist(),
            per_device=plan.stream.per_device.tolist(),
            device_of=plan.device_of.tolist(), imbalance=plan.imbalance)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_mesh():
    """One run of the reference's mesh on 8 forced host devices."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_MESH],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _reference_operands(report, name):
    pats = report["patterns"]
    return tuple(
        CSC(torch.tensor(report[name][f"{k}_values"], dtype=torch.float32),
            np.asarray(pats[k]["rows"], np.int32),
            np.asarray(pats[k]["col_ptr"], np.int32),
            tuple(pats[k]["shape"])) for k in ("a", "b"))


@pytest.mark.parametrize("values", ["int", "real"])
def test_eight_shards_equal_the_reference_eight_device_mesh(reference_mesh,
                                                            values):
    rep = reference_mesh[values]
    a, b = _reference_operands(reference_mesh, values)
    plan = plan_spgemm_mesh(a, b, shards=8,
                            shard_limit=reference_mesh["limit"], device=CPU)
    assert plan.stream.per_device.tolist() == rep["per_device"]
    assert plan.device_of.tolist() == rep["device_of"]
    assert plan.imbalance == rep["imbalance"] < 2.0
    c = plan.execute(a, b)
    assert _np(c.col_ptr).tolist() == rep["c_col_ptr"]
    assert _np(c.row_indices).tolist() == rep["c_rows"]
    want = np.asarray(rep["c_values"], np.float32)
    ga, gb = _grads(plan.stream_apply, a.values, b.values)
    want_ga = np.asarray(rep["ga"], np.float32)
    want_gb = np.asarray(rep["gb"], np.float32)
    if values == "int":
        assert np.array_equal(_np(c.values), want)
        assert np.array_equal(ga.numpy(), want_ga)
        assert np.array_equal(gb.numpy(), want_gb)
    else:
        np.testing.assert_allclose(_np(c.values), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ga.numpy(), want_ga, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gb.numpy(), want_gb, rtol=RTOL, atol=ATOL)


def test_eight_shards_equal_the_host_stream_on_integers(reference_mesh):
    """The reference test's own assertion on its 8-device run: bit for bit
    the guard-lifted host stream, and balanced."""
    a, b = _reference_operands(reference_mesh, "int")
    plan = plan_spgemm_mesh(a, b, shards=8,
                            shard_limit=reference_mesh["limit"], device=CPU)
    _assert_bits(plan.execute(a, b), _host_oracle(a, b))


# --- the cost functions ----------------------------------------------------


def _stats_pairs():
    yield "small", tile_stats(random_density_csc(64, 64, 0.4, seed=19),
                              random_density_csc(64, 64, 0.4, seed=20))
    a, b = _int_operands(3)
    yield "uniform", tile_stats(a, b)
    for flops in (10**5, 4_000_000, 8_000_000, 8_000_001, 32_000_000,
                  10**9):
        yield f"flops{flops}", TileStats(
            m=10**5, k=10**5, n=3 * 10**4, nnz_a=10**6, nnz_b=10**6,
            ops=np.array([flops], np.int64), steps=np.array([1], np.int64))


def _ref_stats(st):
    return RefTileStats(m=st.m, k=st.k, n=st.n, nnz_a=st.nnz_a,
                        nnz_b=st.nnz_b, ops=st.ops, steps=st.steps)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_cost_functions_equal_the_reference(shards):
    for _, st in _stats_pairs():
        rst = _ref_stats(st)
        assert estimate_mesh_cost(st, shards) == \
            ref_estimate_mesh_cost(rst, shards)
        for limit in (None, st.flops // 2, st.flops):
            assert should_distribute(st, shards, shard_limit=limit) == \
                ref_should_distribute(rst, shards, shard_limit=limit)


def test_tile_stats_feed_the_cost_functions_alike():
    a, b = _int_operands(7)
    st, rst = tile_stats(a, b), ref_tile_stats(to_ref(a), to_ref(b))
    assert (st.m, st.n, st.flops) == (rst.m, rst.n, rst.flops)
    for d in (1, 2, 8):
        assert estimate_mesh_cost(st, d) == ref_estimate_mesh_cost(rst, d)


# --- the reduction, the comm ladder, the examples --------------------------


def test_reduce_bins_adds_in_shard_order():
    """Bin d is the shards' bin d added left to right: on values whose sum
    depends on the order, the result is that order's."""
    parts = [torch.tensor([1e8, 1.0, 2.0, 3.0]),
             torch.tensor([1.0, -1e8, 4.0, 5.0]),
             torch.tensor([-1e8, 1e8, 6.0, 7.0])]
    parts = [torch.cat([p, p[:2]]) for p in parts]    # 6 = 3 bins of 2
    got = reduce_bins(parts, (torch.device(CPU),) * 3)
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(got, want)
    assert not torch.equal(got, (parts[2] + parts[1]) + parts[0])


def test_comm_ladder_fits_comm_base_alone_on_one_device(tmp_path):
    prof = profile.calibrate_profile(scale=0.05, reps=1, sections=("comm",),
                                     tune=False, device=CPU,
                                     directory=str(tmp_path))
    assert prof.fitted == ("comm_base",)
    assert prof.constants.comm_base > 0
    assert prof.constants.comm_byte == profile.DEFAULT_CONSTANTS.comm_byte
    assert "comm" in profile.SECTIONS


@pytest.mark.parametrize("example", ["torch_quickstart",
                                     "torch_graph_triangles"])
def test_example_runs_on_the_cpu(example, capsys):
    path = os.path.join(REPO, "examples", f"{example}.py")
    spec = importlib.util.spec_from_file_location(example, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--device", "cpu"]
    if example == "torch_quickstart":
        argv += ["--n", "320"]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "MISMATCH" not in out
