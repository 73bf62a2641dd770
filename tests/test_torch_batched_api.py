"""The port's batched path on its own terms, on the CPU (the kernels'
plain versions): ``plan.execute_batched`` and ``spgemm_batched`` equal a
loop of unbatched executes exactly (``torch.equal`` on values and
structure) for every method and both engines; launch counts do not depend
on B; the largest tile is one batched tile; elements may keep different
entries; ``BatchedCSC`` semantics; malformed batches raise; the plan LRU is
shared with ``spgemm``; a guarded plan's fused batched execute equals the
unguarded one.  The comparisons with the JAX package are in
test_torch_batched_{spgemm,hash,fused,kernels}.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.planner import plan_spgemm as ref_plan_spgemm
from repro.sparse.format import BatchedCSC as RefBatchedCSC
from repro_torch import kernels
from repro_torch.convert import batched_csc_from_reference
from repro_torch.core import (
    plan_cache_clear,
    plan_cache_info,
    plan_spgemm,
    spgemm,
    spgemm_batched,
)
from repro_torch.sparse import generate
from repro_torch.sparse.format import (
    BatchedCSC,
    BatchedCSCBuilder,
    CSC,
    ColumnSlots,
    _np,
    csc_from_dense,
    padded_values,
    padded_values_batched,
)
from torch_parity import KERNEL_METHODS, adversarial, assert_same_csc, \
    to_ref, value_stack

DEFAULT = "h-hash-256/256"


def _stack(m: CSC, batch: int, seed: int, values: str = "real") -> BatchedCSC:
    return BatchedCSC.from_values(m, torch.from_numpy(
        value_stack(m, batch, values, seed)))


def _equal(x: CSC, y: CSC) -> bool:
    return (tuple(x.shape) == tuple(y.shape)
            and all(torch.equal(torch.as_tensor(_np(getattr(x, f))),
                                torch.as_tensor(_np(getattr(y, f))))
                    for f in ("col_ptr", "row_indices", "values")))


@pytest.mark.parametrize("engine", [None, "fused"])
@pytest.mark.parametrize("method", KERNEL_METHODS)
def test_batched_equals_looped(method, engine):
    a = generate.random_powerlaw_csc(70, 3.0, seed=1)
    plan = plan_spgemm(a, a, method, device="cpu")
    sa, sb = _stack(a, 3, seed=10), _stack(a, 3, seed=50)
    got = plan.execute_batched(sa, sb, engine=engine)
    assert len(got) == 3
    for b, c in enumerate(got):
        assert _equal(c, plan.execute(sa[b], sb[b], engine=engine))
    raw = plan.execute_batched(sa.values.numpy(), sb.values, engine=engine)
    assert all(_equal(r, c) for r, c in zip(raw, got))


@pytest.mark.parametrize("method", ["hash-32/256", "hash-256/256"])
def test_batched_equals_looped_on_the_dense_pattern(method):
    """The fully dense adversarial pattern under the pure HASH methods
    (tables of 512 slots), which the reference comparison leaves out."""
    a, b = adversarial("all_dense_cols")
    plan = plan_spgemm(a, b, method, device="cpu")
    sa, sb = _stack(a, 2, seed=3, values="int"), _stack(b, 2, seed=4,
                                                         values="int")
    for k, c in enumerate(plan.execute_batched(sa, sb)):
        assert _equal(c, plan.execute(sa[k], sb[k]))


def test_launches_do_not_depend_on_the_batch():
    a = generate.random_powerlaw_csc(300, 3.0, seed=4)
    plan = plan_spgemm(a, a, DEFAULT, device="cpu")
    assert len(plan.layout.groups) > 1
    counts = {}
    for batch in (1, 2, 5):
        stats: dict = {}
        s = _stack(a, batch, seed=batch)
        plan.execute_batched(s, s, stats=stats)
        assert stats["batch"] == batch and stats["engine"] == "naive"
        counts[batch] = stats["n_launches"]
        fused: dict = {}
        plan.execute_batched(s, s, engine="fused", stats=fused)
        assert fused["n_launches"] == 1 and fused["batch"] == batch
    assert set(counts.values()) == {len(plan.layout.groups)}


def test_wrapper_launch_counts_do_not_depend_on_the_batch():
    """On the card each group launches its batched kernel once; on the CPU
    no wrapper launches anything, so every count stays 0."""
    a = generate.random_powerlaw_csc(60, 3.0, seed=5)
    plan = plan_spgemm(a, a, DEFAULT, device="cpu")
    kernels.reset_launch_counts()
    s = _stack(a, 4, seed=2)
    plan.execute_batched(s, s)
    plan.execute_batched(s, s, engine="fused")
    assert set(kernels.launch_counts().values()) == {0}
    assert {"fused_stream_batched", "spa_spgemm_batched",
            "spars_spgemm_batched", "hash_spgemm_batched"} \
        <= set(kernels.launch_counts())


def test_peak_is_one_batched_tile():
    batch = 3
    a = generate.random_powerlaw_csc(300, 3.0, seed=5)
    for method in ("spa", DEFAULT, "spars-16/64"):
        plan = plan_spgemm(a, a, method, device="cpu")
        s = _stack(a, batch, seed=1)
        stats: dict = {}
        plan.execute_batched(s, s, stats=stats)
        m, n = stats["result_shape"]
        assert stats["peak_tile_elems"] < batch * m * n, method
        for kind, shape in stats["tile_shapes"]:
            assert shape[0] == batch and shape[2] <= 128
            if kind == "dense":
                assert shape[1] == m
        one: dict = {}
        plan.execute(s[0], s[0], stats=one)
        assert stats["peak_tile_elems"] == batch * one["peak_tile_elems"]


def _cancel_case():
    """C[0, 0] = A[0, 0] B[0, 0] + A[0, 1] B[1, 0]: value set 0 cancels it
    (1·1 + 1·(-1)), value set 1 does not (1·1 + 1·1); C[1, 0] stays."""
    a = csc_from_dense(np.array([[1.0, 1.0], [1.0, 0.0]]))
    b = csc_from_dense(np.array([[1.0, 0.0], [1.0, 1.0]]))
    av = np.array([[1, 1, 1], [1, 1, 1]], np.float32)   # a: (0,0) (1,0) (0,1)
    bv = np.array([[1, -1, 1], [1, 1, 1]], np.float32)  # b: (0,0) (1,0) (1,1)
    return a, b, av, bv


@pytest.mark.parametrize("method", ["spa", "h-hash-256/256", "spars-16/64"])
def test_a_product_cancels_in_one_element_only(method):
    """The per-group path keeps |v| > 0 per element: the cancelled entry
    drops from element 0 and stays in element 1, as in the JAX package and
    in a loop of executes.  The fused engine keeps the slot in both, so its
    results share one structure."""
    a, b, av, bv = _cancel_case()
    plan = plan_spgemm(a, b, method, device="cpu")
    got = plan.execute_batched(av, bv)
    assert got[0].nnz == got[1].nnz - 1
    assert 0 not in _np(got[0].row_indices)[: int(_np(got[0].col_ptr)[1])]
    for k, c in enumerate(got):
        assert _equal(c, plan.execute(av[k], bv[k]))
    ra, rb = to_ref(a), to_ref(b)
    want = ref_plan_spgemm(ra, rb, method, backend="pallas").execute_batched(
        RefBatchedCSC.from_values(ra, av), RefBatchedCSC.from_values(rb, bv))
    for g, w in zip(got, want):
        assert_same_csc(g, w, exact=True)
    fused = plan.execute_batched(av, bv, engine="fused")
    assert fused[0].row_indices is fused[1].row_indices
    assert fused[0].col_ptr is fused[1].col_ptr
    assert float(fused[0].values[0]) == 0.0
    assert float(fused[1].values[0]) == 2.0


def test_fused_results_share_one_structure():
    a = generate.random_powerlaw_csc(60, 3.0, seed=6)
    plan = plan_spgemm(a, a, device="cpu")
    s = _stack(a, 3, seed=6)
    got = plan.execute_batched(s, s, engine="fused")
    assert all(c.row_indices is got[0].row_indices
               and c.col_ptr is got[0].col_ptr for c in got)


def test_guarded_plan_fused_batched_equals_unguarded():
    a = generate.random_powerlaw_csc(80, 3.0, seed=7)
    sa, sb = _stack(a, 3, seed=1), _stack(a, 3, seed=2)
    want = plan_spgemm(a, a, device="cpu").execute_batched(sa, sb,
                                                           engine="fused")
    guarded = plan_spgemm(a, a, device="cpu", stream_limit=1)
    stats: dict = {}
    got = guarded.execute_batched(sa, sb, engine="fused", stats=stats)
    assert guarded.stream is None and not stats["stream_cached"]
    assert stats["n_launches"] == 1 and stats["batch"] == 3
    assert guarded.fused_stream_nbytes == 0
    assert all(_equal(g, w) for g, w in zip(got, want))


def test_spgemm_batched_hits_the_lru_spgemm_fills():
    plan_cache_clear()
    a = generate.random_powerlaw_csc(50, 3.0, seed=8)
    spgemm(a, a, "spars-40/40", device="cpu")
    assert plan_cache_info()["misses"] == 1
    s = _stack(a, 3, seed=8)
    got = spgemm_batched(s, s, "spars-40/40", device="cpu")
    info = plan_cache_info()
    assert info["misses"] == 1 and info["hits"] == 1
    for k, c in enumerate(got):
        assert _equal(c, spgemm(s[k], s[k], "spars-40/40", device="cpu"))
    plan_cache_clear()


def test_spgemm_batched_with_a_plan_takes_raw_stacks():
    a = generate.random_uniform_csc(36, 3, seed=8)
    plan = plan_spgemm(a, a, "hash-256/256", device="cpu")
    vals = torch.from_numpy(value_stack(a, 2, "real", seed=0))
    got = spgemm_batched(vals, vals, plan=plan)
    for k in range(2):
        assert _equal(got[k], plan.execute(vals[k], vals[k]))
    with pytest.raises(ValueError, match="conflict"):
        spgemm_batched(vals, vals, "spa", plan=plan)
    with pytest.raises(ValueError, match="conflict"):
        spgemm_batched(vals, vals, backend="jax", plan=plan)


def test_spgemm_batched_rejects_what_it_does_not_take():
    a = generate.random_uniform_csc(36, 3, seed=9)
    with pytest.raises(TypeError, match="BatchedCSC"):
        spgemm_batched(a, a, "spa", device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        spgemm_batched(_stack(a, 2, 0), _stack(a, 3, 1), "spa", device="cpu")
    empty = BatchedCSC(torch.zeros((0, a.nnz)), a.row_indices, a.col_ptr,
                       a.shape)
    with pytest.raises(ValueError, match="empty batch"):
        spgemm_batched(empty, empty, "spa", device="cpu")
    with pytest.raises(TypeError):
        spgemm_batched(_stack(a, 2, 0), _stack(a, 2, 1), tile=64)


@pytest.mark.parametrize("engine", [None, "fused"])
def test_execute_batched_rejects_malformed_batches(engine):
    a = generate.random_uniform_csc(36, 3, seed=10)
    plan = plan_spgemm(a, a, "spa", device="cpu")
    ok = np.zeros((2, a.nnz), np.float32)
    with pytest.raises(ValueError, match="batch mismatch"):
        plan.execute_batched(ok, np.zeros((3, a.nnz)), engine=engine)
    with pytest.raises(ValueError, match="empty batch"):
        plan.execute_batched(ok[:0], ok[:0], engine=engine)
    with pytest.raises(ValueError, match=r"\[B, nnz\]"):
        plan.execute_batched(np.zeros(a.nnz), ok, engine=engine)  # 1-D
    with pytest.raises(ValueError, match=r"\[B, nnz\]"):
        plan.execute_batched(a, ok, engine=engine)   # one CSC: use execute
    with pytest.raises(ValueError, match="values per batch"):
        plan.execute_batched(ok[:, :-1], ok, engine=engine)
    other = generate.random_uniform_csc(36, 4, seed=11)
    with pytest.raises(ValueError, match="nnz"):
        plan.execute_batched(_stack(other, 2, 0), ok, engine=engine)


def test_batched_csc_stack_roundtrip():
    a = generate.random_powerlaw_csc(30, 3.0, seed=11)
    mats = [CSC(torch.from_numpy(value_stack(a, 1, "real", seed=k)[0]),
                a.row_indices, a.col_ptr, a.shape) for k in range(4)]
    s = BatchedCSC.stack(mats)
    assert s.batch == 4 and s.nnz == a.nnz and s.shape == a.shape
    assert s.values.shape == (4, a.nnz) and s.device.type == "cpu"
    for k, m in enumerate(mats):
        assert _equal(s[k], m) and _equal(s.element(k), m)
    assert all(_equal(u, m) for u, m in zip(s.unstack(), mats))
    again = BatchedCSC.from_values(a, s.values)
    assert _equal(again[1], mats[1])
    assert _equal(s.to("cpu")[2], mats[2])


def test_batched_csc_stack_rejects_other_patterns():
    a = generate.random_powerlaw_csc(30, 3.0, seed=12)
    b = generate.random_powerlaw_csc(30, 3.0, seed=13)
    with pytest.raises(ValueError, match="patterns differ"):
        BatchedCSC.stack([a, b])
    with pytest.raises(ValueError, match="at least one"):
        BatchedCSC.stack([])
    with pytest.raises(ValueError):
        BatchedCSC.from_values(a, np.zeros(a.nnz))        # not [B, nnz]
    with pytest.raises(ValueError):
        BatchedCSC.from_values(a, np.zeros((0, a.nnz)))   # B = 0


def test_padded_values_batched_rows_equal_padded_values():
    from repro_torch.sparse.format import csc_pad_gather

    a = generate.random_powerlaw_csc(40, 3.0, seed=14)
    _, gather, mask, _ = csc_pad_gather(a)
    gather, mask = torch.from_numpy(gather), torch.from_numpy(mask)
    v = torch.from_numpy(value_stack(a, 3, "real", seed=1))
    got = padded_values_batched(v, gather, mask)
    assert got.shape == (3,) + tuple(gather.shape)
    for k in range(3):
        assert torch.equal(got[k], padded_values(v[k], gather, mask))
    with pytest.raises(ValueError, match=r"\[B, nnz\]"):
        padded_values_batched(v[0], gather, mask)
    assert not padded_values_batched(v[:, :0], gather, mask).any()


def test_batched_builder_sizes_its_spare_per_element():
    """Each element owns the plan's slots and spare, so a batched tile of B
    times the spare cells compacts, while a tile wider than one element's
    spare raises; the plan's own slots stay sized for one value set."""
    m, n = 6, 4
    slots = ColumnSlots.of(np.full(n, m), m * n, "cpu")
    builder = BatchedCSCBuilder(3, (m, n), slots)
    tiles = torch.from_numpy(np.random.default_rng(0).integers(
        -1, 2, (3, m, n)).astype(np.float32))
    builder.add_dense_tile(torch.arange(n), tiles)
    for k, c in enumerate(builder.build()):
        assert _equal(c, csc_from_dense(tiles[k].numpy().astype(np.float32)))
    assert slots.spare == m * n
    with pytest.raises(ValueError, match="spare"):
        BatchedCSCBuilder(3, (m, 2 * n), slots).add_dense_tile(
            torch.arange(2 * n), torch.zeros((3, m, 2 * n)))
    with pytest.raises(ValueError, match="batch"):
        BatchedCSCBuilder(0, (m, n), slots)
    with pytest.raises(ValueError, match=r"B=3"):
        builder.add_dense_tile(torch.arange(n), tiles[:2])


def test_converter_cuts_over_allocated_stacks():
    from repro.sparse.generate import random_powerlaw_csc as ref_powerlaw

    r = ref_powerlaw(30, 3.0, seed=15)
    vals = np.random.default_rng(0).standard_normal((2, r.nnz + 5))
    rows = np.concatenate([np.asarray(r.row_indices), np.zeros(5, np.int32)])
    got = batched_csc_from_reference(vals, rows, r.col_ptr, r.shape,
                                     device="cpu")
    assert got.values.shape == (2, r.nnz) and got.nnz == r.nnz
    assert got.row_indices.dtype == np.int32 and len(got.row_indices) == r.nnz
    np.testing.assert_array_equal(got.values.numpy(), vals[:, : r.nnz])


@pytest.mark.parametrize("kernel", ["spa", "spars", "hash", "fused"])
def test_batched_wrappers_check_the_batch(kernel):
    """The batch is each kernel's second grid axis: value sets of another
    count than their partner's, or none, raise before anything runs."""
    z = torch.zeros((16, 2), dtype=torch.int32)
    n = torch.zeros(16, dtype=torch.int32)
    steps = torch.zeros(1, dtype=torch.int32)
    for bad in ((torch.zeros((2, 16, 2)), torch.zeros((3, 16, 2))),
                (torch.zeros((0, 16, 2)), torch.zeros((0, 16, 2))),
                (torch.zeros((16, 2)), torch.zeros((16, 2)))):
        av, bv = bad
        with pytest.raises(ValueError):
            if kernel == "spa":
                kernels.spa_spgemm_batched(z, av, n, z, bv, n, m=16,
                                           block_cols=16)
            elif kernel == "spars":
                kernels.spars_spgemm_batched(z, av, n, z, bv, n, steps, m=16,
                                             block_cols=16)
            elif kernel == "hash":
                kernels.hash_spgemm_batched(z, av, n, z, bv, n, steps, m=16,
                                            h=4, block_cols=16)
            else:
                kernels.fused_stream_batched(n, n, n[:2],
                                             av[..., 0].contiguous(),
                                             bv[..., 0].contiguous())


def test_batched_wrappers_refuse_more_value_sets_than_the_grid_takes():
    from repro_torch.kernels._checks import MAX_BATCH

    n = torch.zeros(4, dtype=torch.int32)
    big = torch.zeros((MAX_BATCH + 1, 1))
    with pytest.raises(ValueError, match=str(MAX_BATCH)):
        kernels.fused_stream_batched(n, n, n[:2], big, big)
