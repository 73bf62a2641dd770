"""Two edges of the port's executors, on the CPU (the kernels' plain
versions), held against the JAX package where it answers:

- an A with no rows: C is the empty ``0 x n`` CSC under every method and
  both engines, through ``spgemm``, ``plan.execute``, ``execute_batched`` and
  ``spgemm_batched``, with no launch, as the JAX package's host backend
  gives it;
- a batch larger than ``MAX_BATCH`` value sets: ``plan.execute_batched``,
  ``spgemm_batched`` and ``SparseMatmul.batched`` split it into launches of
  at most ``MAX_BATCH`` (lowered here to 3), and every element equals a
  looped execute bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import spgemm as ref_spgemm
from repro_torch.core import plan_spgemm, spgemm, spgemm_batched
from repro_torch.core.backends import HOST_ONLY_METHODS
from repro_torch.core.planner import ALGORITHMS
from repro_torch.kernels import _checks, bsr_spmm_batched
from repro_torch.models import SparseMatmul
from repro_torch.sparse import generate
from repro_torch.sparse.format import BatchedCSC, CSC, _np, csc_from_dense
from torch_parity import assert_same_csc, to_ref, value_stack

# None: spgemm()'s default; the methods with a kernel family
METHODS = (None,) + tuple(m for m in ALGORITHMS if m not in HOST_ONLY_METHODS)


def _zero_row_operands():
    """A 0 x 6 A and a 6 x 5 B with entries in every column but one."""
    b = np.zeros((6, 5), np.float32)
    b[[0, 2, 5], 0] = (1.0, 2.0, 3.0)
    b[1, 1] = 2.0
    b[:, 3] = np.arange(1.0, 7.0)
    b[4, 4] = -1.0
    return csc_from_dense(np.zeros((0, 6), np.float32)), csc_from_dense(b)


def _stack(m: CSC, batch: int, seed: int, values: str = "int"):
    return BatchedCSC.from_values(m, torch.from_numpy(
        value_stack(m, batch, values, seed)))


def _equal(x: CSC, y: CSC) -> bool:
    return (tuple(x.shape) == tuple(y.shape)
            and all(torch.equal(torch.as_tensor(_np(getattr(x, f))),
                                torch.as_tensor(_np(getattr(y, f))))
                    for f in ("col_ptr", "row_indices", "values")))


@pytest.mark.parametrize("engine", [None, "fused"])
@pytest.mark.parametrize("method", METHODS)
def test_zero_row_a_gives_the_empty_csc(method, engine):
    a, b = _zero_row_operands()
    want = ref_spgemm(to_ref(a), to_ref(b), method, backend="host")
    assert tuple(want.shape) == (0, 5)
    assert_same_csc(spgemm(a, b, method, device="cpu", engine=engine), want,
                    exact=True)
    plan = plan_spgemm(a, b, *(() if method is None else (method,)),
                       device="cpu")
    stats: dict = {}
    assert_same_csc(plan.execute(a, b, engine=engine, stats=stats), want,
                    exact=True)
    assert stats["n_launches"] == 0
    sa, sb = _stack(a, 3, 1), _stack(b, 3, 2)
    stats = {}
    got = plan.execute_batched(sa, sb, engine=engine, stats=stats)
    assert len(got) == 3 and stats["n_launches"] == 0
    got += spgemm_batched(sa, sb, method, device="cpu", engine=engine)
    for c in got:
        assert_same_csc(c, want, exact=True)


@pytest.mark.parametrize("engine", [None, "fused"])
@pytest.mark.parametrize("method", ["h-spa-16/64", "h-hash-256/256"])
def test_a_batch_past_max_batch_splits_into_launches(monkeypatch, method,
                                                     engine):
    """B = 7 with MAX_BATCH = 3: three launches of at most three value sets
    per group (the wrappers refuse more), each element equal to a looped
    execute."""
    monkeypatch.setattr(_checks, "MAX_BATCH", 3)
    a = generate.random_powerlaw_csc(60, 4.0, seed=2)
    plan = plan_spgemm(a, a, method, device="cpu")
    assert len({g.kind for g in plan.layout.groups}) == 2
    sa, sb = _stack(a, 7, 3, "real"), _stack(a, 7, 4, "real")
    one: dict = {}
    plan.execute(sa.element(0), sb.element(0), engine=engine, stats=one)
    stats: dict = {}
    got = plan.execute_batched(sa, sb, engine=engine, stats=stats)
    assert stats["batch"] == 7
    assert stats["n_launches"] == 3 * one["n_launches"] > 0   # ceil(7 / 3)
    again = spgemm_batched(sa, sb, method, device="cpu", engine=engine)
    assert len(got) == len(again) == 7
    for b in range(7):
        want = plan.execute(sa.element(b), sb.element(b), engine=engine)
        assert _equal(got[b], want) and _equal(again[b], want)


def test_sparse_matmul_batch_past_max_batch_splits(monkeypatch):
    monkeypatch.setattr(_checks, "MAX_BATCH", 3)
    rng = np.random.default_rng(5)
    sm = SparseMatmul.from_dense(rng.normal(size=(32, 48)).astype(np.float32),
                                 keep_density=0.4, device="cpu")
    assert sm.path == "bsr"
    xs = torch.from_numpy(rng.normal(size=(7, 48, 16)).astype(np.float32))
    got = sm.batched(xs)
    assert got.shape == (7, 32, 16)
    for b in range(7):
        assert torch.equal(got[b], sm(xs[b]))
    with pytest.raises(ValueError, match="3"):   # one launch takes 3 at most
        bsr_spmm_batched(sm.block_idx, sm.block_nnz, sm.blocks, xs, bn=16)
