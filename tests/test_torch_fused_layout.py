"""K1's two tiers on the CPU: the list of long slots each view carries, the
constants the host shares with ``csrc/fused_stream.cu``, and a plain
PyTorch model of the kernel's walk (``torch_k1_walk.py``: a warp a long
slot in rounds of 32 products, a thread a short slot, tiles of value sets)
against the plain version ``fused_stream_batched_plain``, bit for bit, and
through the plain version against the JAX package's Pallas kernel in
interpret mode.

The walk runs with the kernel's constants and with the long-slot threshold
lowered to 2 and 4, so that small views put long slots next to each other,
first, last and beside empty slots, and with fewer threads a CTA, so that
the warp CTAs and the short ones cross several borders.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import pallas_stream as ref_pallas_stream
from repro_torch import kernels
from repro_torch.core import (
    cached_plan,
    fused_stream,
    plan_cache_clear,
    plan_cache_info,
    plan_spgemm,
    spgemm,
)
from repro_torch.core.fused_stream import _forward_of
from repro_torch.kernels.fused_stream import LONG_SLOT
from repro_torch.sparse.format import csc_from_dense
from torch_k1_walk import BATCH_TILE, DEPTH, THREADS, walk_model
from torch_parity import ADVERSARIAL, adversarial

K1 = importlib.import_module("repro_torch.kernels.fused_stream")
SOURCE = (Path(K1.__file__).resolve().parent.parent / "csrc"
          / "fused_stream.cu").read_text()


def _constant(name: str) -> int:
    found = re.findall(r"constexpr int %s = (\d+);" % name, SOURCE)
    assert len(found) == 1, name
    return int(found[0])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _arrow(n=80, seed=0):
    """An iprob-shaped matrix: a dense first row and column and the
    diagonal, normal values."""
    rng = np.random.default_rng(seed)
    d = np.diag(rng.standard_normal(n))
    d[0] = rng.standard_normal(n)
    d[:, 0] = rng.standard_normal(n)
    return csc_from_dense(d)


def _views(plan):
    fs = fused_stream(plan)
    return {"forward": fs.forward, "grad_a": fs.grad_a, "grad_b": fs.grad_b}


def _expected_long(view, threshold):
    lens = np.diff(view.seg_ptr.numpy())
    return np.flatnonzero(lens > threshold)


# --- the list of long slots -------------------------------------------------


def test_the_threshold_is_the_kernels():
    """The host's copies of the kernel's constants equal the .cu's: the
    wrapper's LONG_SLOT, the one copy that the view builder and the walk
    model read, and the walk model's others."""
    assert K1.LONG_SLOT == _constant("kLongSlot")
    assert DEPTH == _constant("kDepth")
    assert BATCH_TILE == _constant("kBatchTile")
    assert THREADS == _constant("kThreads")


@pytest.mark.parametrize("threshold", [LONG_SLOT, 2])
@pytest.mark.parametrize("case", ADVERSARIAL + ("arrow",))
def test_every_view_lists_its_long_slots(case, threshold, monkeypatch):
    monkeypatch.setattr(K1, "LONG_SLOT", threshold)
    a, b = (_arrow(),) * 2 if case == "arrow" else adversarial(case)
    plan = plan_spgemm(a, b, device="cpu")
    views = _views(plan)
    products = plan.stream.n_products
    if products:   # past the guard: the transient forward view
        guarded = plan_spgemm(a, b, device="cpu", stream_limit=products - 1)
        assert guarded.stream is None
        views["transient_forward"] = _forward_of(guarded)[0]
    for name, view in views.items():
        assert view.long_slots.dtype == torch.int32, name
        np.testing.assert_array_equal(view.long_slots.numpy(),
                                      _expected_long(view, threshold),
                                      err_msg=name)
    if case == "arrow" and threshold == LONG_SLOT:
        # the iprob shape: one long forward slot, a long slot per entry of
        # the dense column in both gradient views
        assert views["forward"].long_slots.tolist() == [0]
        assert len(views["grad_a"].long_slots) >= 79
        assert len(views["grad_b"].long_slots) >= 79


def test_view_bytes_count_the_long_slots():
    plan_cache_clear()
    a = _arrow()
    spgemm(a, a, device="cpu", engine="fused")
    plan = cached_plan(a, a, device="cpu")
    fs = fused_stream(plan)
    for view in (fs.forward, fs.grad_a, fs.grad_b):
        assert view.long_slots.numel() > 0
        assert view.nbytes == sum(t.nbytes for t in (
            view.idx_x, view.idx_y, view.seg_ptr, view.long_slots,
            view.out_map) if t is not None)
    assert plan_cache_info()["fused_stream_bytes"] == fs.nbytes
    assert fs.nbytes == (fs.forward.nbytes + fs.grad_a.nbytes
                         + fs.grad_b.nbytes + fs.c_rows.nbytes
                         + fs.c_col_ptr.nbytes)


def test_wrapper_checks_and_derives_the_list():
    p = 4 + LONG_SLOT
    idx = torch.zeros(p, dtype=torch.int32)
    ptr = torch.tensor([0, 3, p], dtype=torch.int32)
    v = torch.ones(4)
    assert K1.long_slots_of(ptr).tolist() == [1]
    assert K1.long_slots_of(ptr).dtype == torch.int32
    with pytest.raises(TypeError):
        kernels.fused_stream(idx, idx, ptr, v, v,
                             long_slots=torch.tensor([1]))
    with pytest.raises(ValueError, match="1-D"):
        kernels.fused_stream(idx, idx, ptr, v, v,
                             long_slots=torch.ones((1, 1), dtype=torch.int32))
    got = kernels.fused_stream(idx, idx, ptr, v, v,
                               long_slots=K1.long_slots_of(ptr))
    assert torch.equal(got, torch.tensor([3.0, p - 3.0]))


# --- the walk against the plain version -------------------------------------


def _lens_case():
    """Slot lengths with long slots (at thresholds 2 and 4) first, last,
    next to each other and beside empty slots, and a slot of exactly 32,
    33, 64 and 65 products (one round, one past it, a whole batch of rounds
    at depth 2, one past it)."""
    return np.array([9, 0, 3, 5, 4, 0, 0, 7, 1, 2, 0, 33, 32, 64, 65, 0, 6,
                     2, 1, 0, 12, 11, 3, 70])


def _stream(lens, n_x, n_y, seed):
    rng = np.random.default_rng(seed)
    p = int(lens.sum())
    seg_ptr = torch.from_numpy(np.concatenate(([0], np.cumsum(lens))).astype(
        np.int32))
    return (torch.from_numpy(rng.integers(0, n_x, p).astype(np.int32)),
            torch.from_numpy(rng.integers(0, n_y, p).astype(np.int32)),
            seg_ptr)


def _values(batch, n, seed, zeros=False):
    rng = np.random.default_rng([seed, batch, n])
    v = rng.standard_normal((batch, n)).astype(np.float32)
    if zeros:   # signed zeros among the values: products of -0.0
        v[:, ::3] = 0.0
        v[:, 1::3] = -0.0
    return torch.from_numpy(v)


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("threshold", [2, 4])
@pytest.mark.parametrize("batch", [1, 3, 8, 9])
def test_walk_equals_plain_bit_for_bit(batch, threshold, zeros):
    idx_x, idx_y, seg_ptr = _stream(_lens_case(), 50, 60, seed=batch)
    x, y = _values(batch, 50, 1, zeros), _values(batch, 60, 2, zeros)
    lens = torch.diff(seg_ptr)
    long_slots = torch.nonzero(lens > threshold).flatten().int()
    assert long_slots[0] == 0 and long_slots[-1] == len(lens) - 1
    want = kernels.fused_stream_batched_plain(idx_x, idx_y, seg_ptr, x, y)
    for depth, threads, tile in ((DEPTH, THREADS, BATCH_TILE), (4, 64, 2),
                                 (2, 32, 3)):
        got = walk_model(idx_x, idx_y, seg_ptr, long_slots, x, y,
                         long_slot=threshold, depth=depth, threads=threads,
                         batch_tile=tile)
        assert torch.equal(_bits(got), _bits(want)), (depth, threads, tile)
        if batch == 1:
            one = kernels.fused_stream_plain(idx_x, idx_y, seg_ptr, x[0],
                                             y[0])
            assert torch.equal(_bits(got[0]), _bits(one))


@pytest.mark.parametrize("batch", [1, 3])
def test_walk_on_the_arrow_views_at_the_kernels_constants(batch):
    a = _arrow(n=72)
    plan = plan_spgemm(a, a, device="cpu")
    rng = np.random.default_rng(batch)
    av = torch.from_numpy(rng.standard_normal((batch, a.nnz)).astype(
        np.float32))
    n_c = fused_stream(plan).forward.n_out
    g = torch.from_numpy(rng.standard_normal((batch, n_c)).astype(
        np.float32))
    for name, view in _views(plan).items():
        assert view.long_slots.numel() > 0, name
        x = av if name == "forward" else g
        want = kernels.fused_stream_batched_plain(
            view.idx_x, view.idx_y, view.seg_ptr, x, av)
        got = walk_model(view.idx_x, view.idx_y, view.seg_ptr,
                         view.long_slots, x, av)
        assert torch.equal(_bits(got), _bits(want)), name


def test_walk_matches_the_reference_kernel_on_integers():
    """The walk on the arrow's forward view equals the JAX package's
    Pallas kernel (interpret mode) exactly on integer values."""
    a = _arrow(n=48)
    plan = plan_spgemm(a, a, device="cpu")
    s = plan.stream
    view = fused_stream(plan).forward
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, a.nnz).astype(np.float32)
    seg_ids = np.repeat(np.arange(view.n_out), np.diff(view.seg_ptr.numpy()))
    ref_view = ref_pallas_stream._build_view(s.a_pos, s.b_pos, seg_ids, 128,
                                             view.n_out)
    want = np.asarray(ref_pallas_stream._fused_call(ref_view, jnp.asarray(x),
                                                    jnp.asarray(x)))
    xt = torch.from_numpy(x)[None]
    got = walk_model(view.idx_x, view.idx_y, view.seg_ptr, view.long_slots,
                     xt, xt)
    np.testing.assert_array_equal(got[0].numpy(), want)
