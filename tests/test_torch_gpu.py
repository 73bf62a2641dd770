"""The CUDA kernels on the card: each against its plain PyTorch version on
the same CUDA tensors, and spgemm() on the card against spgemm() on the
CPU, on the per-group path and on the fused path (K1, forward and
backward).  Every test needs a card (marker ``gpu``) and skips without one.

On the card these run without the JAX-importing conftest, which that
machine cannot import::

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \
        tests/test_torch_gpu.py

Each cell takes its products in one order in the kernel and in its plain
version, with no fused multiply-add, so they must agree exactly — on
real-valued inputs too.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.core import cached_plan, fused_stream, plan_spgemm, spgemm
from repro_torch.core.analysis import hash_table_size
from repro_torch.sparse import generate
from repro_torch.sparse.format import _np, csc_to_padded_columns
from repro_torch.sparse.stats import ops_per_column, steps_per_column

pytestmark = pytest.mark.gpu

METHODS = ("spa", "spars-16/64", "spars-40/40", "h-spa-16/64", "h-spa-40/40",
           "hash-32/256", "hash-256/256", "h-hash-32/256", "h-hash-256/256")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _operands(dev, n=200, block=32, seed=0):
    a = generate.random_powerlaw_csc(n, 6.0, seed=seed)
    ar, av, an = csc_to_padded_columns(a)
    n_pad = -(-n // block) * block
    steps = np.zeros(n_pad, np.int64)
    steps[:n] = steps_per_column(a, a)
    pad = n_pad - n
    return dict(
        ab=tuple(x.to(dev) for x in (
            ar, av.float(), an,
            torch.nn.functional.pad(ar, (0, 0, 0, pad)),
            torch.nn.functional.pad(av.float(), (0, 0, 0, pad)),
            torch.nn.functional.pad(an, (0, pad)))),
        steps=torch.from_numpy(steps.reshape(-1, block).max(axis=1)
                               .astype(np.int32)).to(dev),
        m=n, block=block,
        h=hash_table_size(int(ops_per_column(a, a).max())))


def test_spa_kernel_equals_plain(cuda):
    op = _operands(cuda)
    before = kernels.spa_spgemm.n_launches
    got = kernels.spa_spgemm(*op["ab"], m=op["m"], block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.spa_spgemm.n_launches == before + 1
    want = kernels.spa_spgemm_plain(*op["ab"], m=op["m"])
    assert torch.equal(got, want)


def test_spars_kernel_equals_plain(cuda):
    op = _operands(cuda)
    before = kernels.spars_spgemm.n_launches
    acc, flags = kernels.spars_spgemm(*op["ab"], op["steps"], m=op["m"],
                                      block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.spars_spgemm.n_launches == before + 1
    want_acc, want_flags = kernels.spars_spgemm_plain(
        *op["ab"], op["steps"], m=op["m"], block_cols=op["block"])
    assert torch.equal(acc, want_acc) and torch.equal(flags, want_flags)


def test_hash_kernel_equals_plain(cuda):
    op = _operands(cuda)
    before = kernels.hash_spgemm.n_launches
    keys, vals = kernels.hash_spgemm(*op["ab"], op["steps"], m=op["m"],
                                     h=op["h"], block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.hash_spgemm.n_launches == before + 1
    want_keys, want_vals = kernels.hash_spgemm_plain(
        *op["ab"], op["steps"], h=op["h"], block_cols=op["block"])
    assert torch.equal(keys, want_keys) and torch.equal(vals, want_vals)


@pytest.mark.parametrize("method", METHODS)
def test_spgemm_on_card_equals_cpu(cuda, method):
    a = generate.random_powerlaw_csc(300, 5.0, seed=4)
    got = spgemm(a, a, method)               # device=None: the card
    assert got.values.device.type == "cuda"
    want = spgemm(a, a, method, device="cpu")
    for f in ("col_ptr", "row_indices", "values"):
        assert np.array_equal(_np(getattr(got, f)), _np(getattr(want, f))), f


@pytest.mark.parametrize("method", ["spa", "h-spa-16/64", "h-hash-256/256"])
def test_execute_waits_for_the_card_once(cuda, method):
    """Every group is gathered, launched and compacted without a host sync;
    the one sync of an execution reads the result's nnz."""
    a = generate.random_powerlaw_csc(600, 8.0, seed=5).to(cuda)
    plan = cached_plan(a, a, method)
    assert len(plan.layout.groups) > 1
    plan.execute(a, a)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        plan.execute(a, a)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]


def test_wrapper_rejects_bad_cuda_operands(cuda):
    op = _operands(cuda)
    ab = list(op["ab"])
    ab[1] = ab[1].double()
    with pytest.raises(TypeError):
        kernels.spa_spgemm(*ab, m=op["m"], block_cols=op["block"])
    with pytest.raises(ValueError):
        kernels.spa_spgemm(*op["ab"], m=op["m"], block_cols=op["block"],
                           device="cpu")


def _fused_operands(dev, seed=6):
    a = generate.random_powerlaw_csc(300, 5.0, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.nnz).astype(np.float32)
    return a, x


def test_fused_kernel_equals_plain_on_every_view(cuda):
    a, x = _fused_operands(cuda)
    fs = fused_stream(plan_spgemm(a, a))
    v = torch.from_numpy(x).to(cuda)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        fs.forward.n_out).astype(np.float32)).to(cuda)
    for view, first in ((fs.forward, v), (fs.grad_a, g), (fs.grad_b, g)):
        before = kernels.fused_stream.n_launches
        got = kernels.fused_stream(view.idx_x, view.idx_y, view.seg_ptr,
                                   first, v)
        torch.cuda.synchronize()
        assert kernels.fused_stream.n_launches == before + 1
        want = kernels.fused_stream_plain(view.idx_x, view.idx_y,
                                          view.seg_ptr, first, v)
        assert torch.equal(got, want)


def test_fused_backward_on_card_equals_plain(cuda):
    """Forward and gradient of sum(w * C) through stream_apply on the card
    equal the same on the CPU (the plain versions), bit for bit."""
    a, x = _fused_operands(cuda)
    results = []
    for dev in (cuda, torch.device("cpu")):
        plan = plan_spgemm(a, a, device=dev)
        w = torch.from_numpy(np.random.default_rng(8).standard_normal(
            plan.stream.nnz).astype(np.float32)).to(dev)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        before = kernels.fused_stream.n_launches
        c = plan.stream_apply(xt, xt, engine="fused")
        grad, = torch.autograd.grad((w * c).sum(), xt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.fused_stream.n_launches == before + 3
        results.append((c.detach().cpu(), grad.cpu()))
    (c_card, g_card), (c_cpu, g_cpu) = results
    assert torch.equal(c_card, c_cpu) and torch.equal(g_card, g_cpu)


def test_fused_spgemm_on_card_equals_cpu(cuda):
    a, _ = _fused_operands(cuda)
    got = spgemm(a, a, engine="fused")
    assert got.values.device.type == "cuda"
    want = spgemm(a, a, engine="fused", device="cpu")
    for f in ("col_ptr", "row_indices", "values"):
        assert np.array_equal(_np(getattr(got, f)), _np(getattr(want, f))), f


def test_fused_execute_never_waits_for_the_card(cuda):
    """The fused result's nnz is fixed by the plan: an execute on operands
    already on the card makes no host sync.  A guarded plan gives the same
    values through its transient path."""
    a = generate.random_powerlaw_csc(600, 8.0, seed=5).to(cuda)
    plan = cached_plan(a, a)
    plan.execute(a, a, engine="fused")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        plan.execute(a, a, engine="fused")
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]
    stats: dict = {}
    guarded = plan_spgemm(a, a, stream_limit=1)
    got = guarded.execute(a, a, engine="fused", stats=stats)
    assert not stats["stream_cached"] and stats["n_launches"] == 1
    assert torch.equal(got.values, plan.execute(a, a, engine="fused").values)
