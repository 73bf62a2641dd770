"""The port's spgemm() against the JAX package's, on the adversarial
patterns of the differential harness: SPA, SPARS and H-SPA methods (the
HASH family is in test_torch_spgemm_hash.py, to keep each file short).

Both run their default device path — the per-group kernel schedule — the
JAX package through its Pallas kernels in interpret mode, the port through
its kernels' plain versions (``device="cpu"``).  Structure must be
identical, values exact on integer-valued inputs and within
``REAL_RTOL``/``REAL_ATOL`` otherwise; both plans must launch the same groups.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.core import spgemm
from repro_torch.kernels import spgemm_cuda
from repro_torch.sparse.format import _np
from torch_parity import ADVERSARIAL, adversarial, check_spgemm_parity

METHODS = ("spa", "spars-16/64", "spars-40/40", "h-spa-16/64", "h-spa-40/40")


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("method", METHODS)
def test_spgemm_matches_reference(method, case, values):
    a, b = adversarial(case)
    check_spgemm_parity(a, b, method, values)


@pytest.mark.parametrize("method", ["esc", "expand", "spars-128/128", "auto"])
def test_methods_without_kernel_family_raise(method):
    """The JAX package's host-only methods have no kernel family on the
    "cuda" backend (its "pallas" error), spgemm() does not know unregistered
    family names, as the reference's spgemm() rejects them, and a cuda
    ``auto`` grid takes no host-only candidate."""
    a, b = adversarial("random")
    kw = dict(candidates=("expand",)) if method == "auto" else {}
    with pytest.raises(ValueError, match="unknown method|host-only"):
        spgemm(a, b, method, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(backend="jax"), dict(engine="stream"),
                                dict(backend="pallas"), dict(backend="mesh")])
def test_only_the_cuda_backend_and_naive_engine(kw):
    """The reference's backend names "jax" and "pallas" are "torch" and
    "cuda" here, the mesh is not ported, and the "cuda" backend's engines
    are "naive" (the default) and "fused" (tests/test_torch_fused.py):
    "stream" is the host and torch backends'."""
    a, b = adversarial("random")
    with pytest.raises(ValueError, match="backend|engine"):
        spgemm(a, b, device="cpu", **kw)
    got = spgemm(a, b, device="cpu", backend="cuda", engine="naive")
    want = spgemm(a, b, device="cpu")
    assert (_np(got.values) == _np(want.values)).all()


@pytest.mark.parametrize("method", ["spa", "h-spa-40/40", "h-hash-32/256"])
def test_spgemm_cuda_is_plan_then_execute(method):
    """``kernels.spgemm_cuda`` (the counterpart of ``spgemm_pallas``) gives
    spgemm()'s result, with the paper's t=40 for the hybrids."""
    a, b = adversarial("random")
    got = spgemm_cuda(a, b, method, device="cpu")
    want = spgemm(a, b, method, device="cpu")
    for f in ("col_ptr", "row_indices", "values"):
        assert (_np(getattr(got, f)) == _np(getattr(want, f))).all(), f
