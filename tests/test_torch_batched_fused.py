"""The port's batched fused engine (``execute_batched(engine="fused")``,
one K1-b launch) against the JAX package's, on the CPU.

Two value sets per operand, A's different from B's.  The reference runs
``execute_batched(..., engine="fused")`` of a pallas plan (``jit(vmap)``
of its fused contraction, the Pallas kernel in interpret mode); the port
the same call with ``device="cpu"``, where K1-b's wrapper takes its batched
plain version.  Structure must be bit-identical, values exact (atol=0) on
integer-valued operands and within ``FUSED_RTOL``/``FUSED_ATOL`` on real
ones.  Past the stream guard the reference falls back to its host stream
engine and the port rebuilds the stream for the call and still runs K1-b:
the two must agree all the same.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.planner import plan_spgemm as ref_plan_spgemm
from repro_torch.core import plan_spgemm, spgemm_batched
from repro_torch.sparse.format import _np
from torch_parity import (
    ADVERSARIAL,
    FUSED_ATOL,
    FUSED_RTOL,
    adversarial,
    assert_same_csc,
    batched_pair,
)

DEFAULT = "h-hash-256/256"


def _reference(a, b, ref_ops, **plan_kw):
    ra, rb = ref_ops
    plan = ref_plan_spgemm(ra[0], rb[0], DEFAULT, backend="pallas", **plan_kw)
    stats: dict = {}
    return plan.execute_batched(ra, rb, engine="fused", stats=stats), stats


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_fused_batched_matches_reference(case, values):
    a, b = adversarial(case)
    (pa, pb), ref_ops = batched_pair(a, b, values, batch=2)
    want, ref_stats = _reference(a, b, ref_ops)
    stats: dict = {}
    got = plan_spgemm(a, b, device="cpu").execute_batched(
        pa, pb, engine="fused", stats=stats)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same_csc(g, w, exact=values == "int", rtol=FUSED_RTOL,
                        atol=FUSED_ATOL)
    assert stats["engine"] == "fused" and stats["batch"] == ref_stats["batch"]
    assert stats["n_launches"] == (1 if stats["stream_products"] else 0)
    assert stats["stream_products"] == ref_stats["stream_products"]
    assert stats["stream_cached"] is True


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ["random", "dup_heavy", "rect_chain"])
def test_guarded_fused_batched_matches_reference(case, values):
    a, b = adversarial(case)
    (pa, pb), ref_ops = batched_pair(a, b, values, batch=3)
    want, ref_stats = _reference(a, b, ref_ops, stream_limit=1)
    assert ref_stats["fallback"] == "host"
    stats: dict = {}
    got = plan_spgemm(a, b, device="cpu", stream_limit=1).execute_batched(
        pa, pb, engine="fused", stats=stats)
    assert stats["stream_cached"] is False and stats["n_launches"] == 1
    for g, w in zip(got, want):
        assert_same_csc(g, w, exact=values == "int", rtol=FUSED_RTOL,
                        atol=FUSED_ATOL)


@pytest.mark.parametrize("case", ["random", "empty_cols", "rect_chain"])
def test_spgemm_batched_reaches_the_fused_engine(case):
    a, b = adversarial(case)
    (pa, pb), ref_ops = batched_pair(a, b, "int", batch=2)
    want, _ = _reference(a, b, ref_ops)
    got = spgemm_batched(pa, pb, device="cpu", engine="fused")
    for g, w in zip(got, want):
        assert_same_csc(g, w, exact=True)
    assert all(np.array_equal(_np(g.col_ptr), _np(got[0].col_ptr))
               for g in got)
