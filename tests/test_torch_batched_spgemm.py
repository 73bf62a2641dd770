"""The port's batched per-group path (``spgemm_batched``, kernels K2-b and
K3-b) against the JAX package's ``execute_batched`` on the adversarial
patterns of the differential harness: the SPA, SPARS and H-SPA methods
(the HASH family is in test_torch_batched_hash.py, to keep each file
short).

Two value sets per operand, A's different from B's (mixed operands).  The
JAX package runs its vmapped Pallas kernels in interpret mode, the port its
batched kernels' plain versions (``device="cpu"``).  Structure must be
identical per element, values exact on integer-valued inputs and within
``REAL_RTOL``/``REAL_ATOL`` otherwise; both must launch the same groups and
report the same batched tiles.
"""

import pytest

pytest.importorskip("torch")

from torch_parity import ADVERSARIAL, adversarial, check_batched_parity

METHODS = ("spa", "spars-16/64", "spars-40/40", "h-spa-16/64", "h-spa-40/40")


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("method", METHODS)
def test_batched_spgemm_matches_reference(method, case, values):
    a, b = adversarial(case)
    check_batched_parity(a, b, method, values)
