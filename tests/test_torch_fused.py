"""The port's fused engine (``engine="fused"``, kernel K1) against the JAX
package's, on the CPU.

The reference runs ``plan.execute(..., engine="fused")`` of a pallas plan,
its Pallas kernel in interpret mode; the port runs ``plan.execute(...,
engine="fused")`` on the ``"cuda"`` backend's contract with
``device="cpu"``, where K1's wrapper takes its plain version.  Structure
must be bit-identical, values exact (atol=0) on integer-valued operands and
within ``FUSED_RTOL``/``FUSED_ATOL`` on real ones.  K1 alone is held against
the reference's ``_fused_call`` on the segment-boundary cases of the
reference's own fused-engine tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pallas_stream as ref_pallas_stream
from repro.core.planner import plan_spgemm as ref_plan_spgemm
from repro_torch import kernels
from repro_torch.core import (
    cached_plan,
    fast,
    fused_fn,
    fused_stream,
    plan_cache_clear,
    plan_cache_info,
    plan_spgemm,
    spgemm,
)
from repro_torch.core.device_stream import stream_seg_ids
from repro_torch.core.fused_stream import _forward_view, _grad_view
from repro_torch.sparse.format import CSC, _np
from torch_parity import (
    ADVERSARIAL,
    FUSED_ATOL,
    FUSED_RTOL,
    adversarial,
    assert_same_csc,
    integer_valued,
    to_ref,
)

DEFAULT = "h-hash-256/256"


def _valued(case, values):
    a, b = adversarial(case)
    if values == "int":
        same = a is b
        a = integer_valued(a, seed=1)
        b = a if same else integer_valued(b, seed=2)
    return a, b


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_fused_execute_matches_reference(case, values):
    a, b = _valued(case, values)
    ra, rb = to_ref(a), to_ref(b)
    want = ref_plan_spgemm(ra, rb, DEFAULT, backend="pallas").execute(
        ra, rb, engine="fused")
    stats: dict = {}
    got = plan_spgemm(a, b, device="cpu").execute(a, b, engine="fused",
                                                 stats=stats)
    assert_same_csc(got, want, exact=values == "int", rtol=FUSED_RTOL,
                    atol=FUSED_ATOL)
    assert stats["engine"] == "fused" and stats["backend"] == "cuda"
    assert stats["device"] == "cpu" and stats["stream_cached"] is True
    assert stats["n_launches"] == (1 if stats["stream_products"] else 0)
    assert stats["result_shape"] == tuple(want.shape)


@pytest.mark.parametrize("case", ["random", "dup_heavy", "rect_chain"])
def test_one_launch_and_shared_structure(case):
    """One K1 call per execute; every result shares the plan's structure
    tensors; values are the same from run to run."""
    a, b = _valued(case, "real")
    plan = plan_spgemm(a, b, device="cpu")
    stats: dict = {}
    c1 = plan.execute(a, b, engine="fused", stats=stats)
    c2 = plan.execute(a, b, engine="fused")
    assert stats["n_launches"] == 1
    assert c1.row_indices is c2.row_indices is fused_stream(plan).c_rows
    assert c1.col_ptr is c2.col_ptr
    assert torch.equal(c1.values, c2.values)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_fused_structure_equals_per_group_on_positive_values(case):
    """With positive values nothing cancels, so the stream's structure is
    the per-group path's and the values agree exactly on integers."""
    a, b = _valued(case, "int")
    a = CSC(a.values.abs(), a.row_indices, a.col_ptr, a.shape)
    b = CSC(b.values.abs(), b.row_indices, b.col_ptr, b.shape)
    plan = plan_spgemm(a, b, device="cpu")
    fused = plan.execute(a, b, engine="fused")
    naive = plan.execute(a, b)
    for f in ("col_ptr", "row_indices", "values"):
        np.testing.assert_array_equal(_np(getattr(fused, f)),
                                      _np(getattr(naive, f)), err_msg=f)


@pytest.mark.parametrize("case", ["empty", "empty_a"])
def test_empty_operand(case):
    a, b = adversarial(case)
    stats: dict = {}
    c = plan_spgemm(a, b, device="cpu").execute(a, b, engine="fused",
                                               stats=stats)
    assert c.nnz == 0 and c.values.shape == (0,)
    np.testing.assert_array_equal(_np(c.col_ptr), np.zeros(b.n_cols + 1))
    assert stats["n_launches"] == 0 and stats["stream_products"] == 0


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ["random", "dup_heavy", "rect_chain"])
def test_guarded_plan_runs_transiently(case, values):
    """Past its guard a plan keeps no stream: execute rebuilds it for the
    one execution (same values, bit for bit), fused_fn raises."""
    a, b = _valued(case, values)
    kept = plan_spgemm(a, b, device="cpu")
    guarded = plan_spgemm(a, b, device="cpu", stream_limit=1)
    assert guarded.stream is None and kept.stream is not None
    stats: dict = {}
    got = guarded.execute(a, b, engine="fused", stats=stats)
    want = kept.execute(a, b, engine="fused")
    for f in ("col_ptr", "row_indices", "values"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert stats["stream_cached"] is False and stats["n_launches"] == 1
    assert guarded.fused_stream_nbytes == 0 and guarded.stream_nbytes == 0
    with pytest.raises(ValueError, match="guard"):
        fused_fn(guarded)
    with pytest.raises(ValueError, match="guard"):
        guarded.stream_apply(a.values, b.values, engine="fused")


def test_spgemm_reaches_the_fused_engine():
    plan_cache_clear()
    a, b = _valued("random", "int")
    got = spgemm(a, b, device="cpu", engine="fused")
    plan = cached_plan(a, b, device="cpu")
    assert plan.fused_stream_nbytes > 0          # the engine ran on it
    want = plan.execute(a, b, engine="fused")
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.row_indices, want.row_indices)
    with pytest.raises(ValueError, match="engine"):
        spgemm(a, b, device="cpu", engine="stream")
    with pytest.raises(ValueError, match="engine"):
        plan.execute(a, b, engine="bogus")


def test_plan_cache_info_reports_stream_bytes():
    plan_cache_clear()
    a, b = _valued("dup_heavy", "int")
    spgemm(a, b, device="cpu")
    info = plan_cache_info()
    assert info["stream_bytes"] == 0 and info["fused_stream_bytes"] == 0
    spgemm(a, b, device="cpu", engine="fused")
    plan = cached_plan(a, b, device="cpu")
    info = plan_cache_info()
    assert info["stream_bytes"] == plan.stream.nbytes > 0
    assert info["fused_stream_bytes"] == fused_stream(plan).nbytes > 0
    assert info["size"] == 1


def test_stream_limit_is_set_per_plan():
    """Cached plans keep the default guard; plan_spgemm(stream_limit=)
    builds a plan under another without touching the LRU."""
    plan_cache_clear()
    a, b = _valued("random", "int")
    p1 = cached_plan(a, b, device="cpu")
    assert p1.stream_limit == fast.STREAM_MAX_PRODUCTS
    p2 = plan_spgemm(a, b, device="cpu", stream_limit=1)
    assert p2.stream_limit == 1 and p2.stream is None
    assert p1.stream is not None
    assert cached_plan(a, b, device="cpu") is p1
    assert plan_cache_info()["size"] == 1


# --- K1 alone, against the reference's _fused_call ---------------------------


def _k1_cases():
    """(idx_x, idx_y, seg, n_out, block) stressing segment
    boundaries: the reference's block is the grid tile it accumulates
    across (K1 has none)."""
    rng = np.random.default_rng(5)
    cases = {}
    k = 23                              # one segment over every tile
    cases["one_segment"] = (np.arange(k), np.arange(k), np.zeros(k, int), 1,
                            4)
    per, n_seg = 4, 6                   # boundaries exactly on tile edges
    cases["tile_edges"] = (np.arange(per * n_seg), np.zeros(per * n_seg, int),
                           np.repeat(np.arange(n_seg), per), n_seg, 4)
    p = 50                              # one product per segment
    cases["one_product_segments"] = (rng.integers(0, 30, p),
                                     rng.integers(0, 30, p), np.arange(p), p,
                                     8)
    lens = rng.integers(1, 12, 40)      # ragged, P % block != 0
    p = int(lens.sum())
    cases["ragged"] = (rng.integers(0, 30, p), rng.integers(0, 30, p),
                       np.repeat(np.arange(40), lens), 40, 16)
    return cases


K1_CASES = _k1_cases()


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_matches_reference_fused_call(case, values):
    import jax.numpy as jnp

    idx_x, idx_y, seg, n_out, block = K1_CASES[case]
    rng = np.random.default_rng(6)
    n_val = int(max(idx_x.max(), idx_y.max())) + 1
    if values == "int":
        x = rng.integers(-3, 4, n_val).astype(np.float32)
        y = rng.integers(-3, 4, n_val).astype(np.float32)
    else:
        x = rng.standard_normal(n_val).astype(np.float32)
        y = rng.standard_normal(n_val).astype(np.float32)
    view = ref_pallas_stream._build_view(idx_x, idx_y, seg, block, n_out)
    want = np.asarray(ref_pallas_stream._fused_call(
        view, jnp.asarray(x), jnp.asarray(y)))
    seg_ptr = np.searchsorted(seg, np.arange(n_out + 1))
    got = kernels.fused_stream(
        *(torch.as_tensor(np.asarray(t, np.int32))
          for t in (idx_x, idx_y, seg_ptr)),
        torch.from_numpy(x), torch.from_numpy(y))
    if values == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=FUSED_RTOL,
                                   atol=FUSED_ATOL)


@pytest.mark.parametrize("view_name", ["forward", "grad_a", "grad_b"])
def test_k1_on_the_plan_views_matches_reference(view_name):
    a, b = _valued("dup_heavy", "int")
    s = plan_spgemm(a, b, device="cpu").stream
    seg_ids = stream_seg_ids(s)
    rng = np.random.default_rng(7)
    g = rng.integers(-3, 4, s.nnz).astype(np.float32)
    av, bv = (_np(m.values).astype(np.float32) for m in (a, b))
    if view_name == "forward":
        view, x, y = _forward_view(s, "cpu"), av, bv
        ref_view = ref_pallas_stream._build_view(s.a_pos, s.b_pos, seg_ids,
                                                 8, s.nnz)
    else:
        pos, other, y = ((s.a_pos, s.b_pos, bv) if view_name == "grad_a"
                         else (s.b_pos, s.a_pos, av))
        view, x = _grad_view(pos, other, seg_ids, "cpu"), g
        ref_view = ref_pallas_stream._grad_view(pos, other, seg_ids, 8)
    want = np.asarray(ref_pallas_stream._fused_call(ref_view, x, y))
    got = kernels.fused_stream(view.idx_x, view.idx_y, view.seg_ptr,
                               torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k1_zero_products_and_zero_segments():
    i32 = torch.zeros(0, dtype=torch.int32)
    v = torch.ones(4)
    out = kernels.fused_stream(i32, i32, torch.zeros(4, dtype=torch.int32),
                               v, v)
    assert torch.equal(out, torch.zeros(3))
    out = kernels.fused_stream(i32, i32, torch.zeros(1, dtype=torch.int32),
                               v, v)
    assert out.shape == (0,)


def test_k1_wrapper_rejects_bad_operands():
    idx = torch.zeros(3, dtype=torch.int32)
    ptr = torch.tensor([0, 3], dtype=torch.int32)
    v = torch.ones(4)
    with pytest.raises(TypeError):
        kernels.fused_stream(idx.long(), idx, ptr, v, v)
    with pytest.raises(TypeError):
        kernels.fused_stream(idx, idx, ptr, v.double(), v)
    with pytest.raises(ValueError, match="length"):
        kernels.fused_stream(idx, idx[:2], ptr, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_stream(idx, idx, ptr, torch.ones(8)[::2], v)
    with pytest.raises(ValueError, match="device"):
        kernels.fused_stream(idx, idx, ptr, v, v, device="cuda")
    assert torch.equal(kernels.fused_stream(idx, idx, ptr, v, v),
                       torch.tensor([3.0]))
