"""The port's spgemm() against the JAX package's on the adversarial
patterns, for the HASH and H-HASH methods (the default method among them);
see test_torch_spgemm.py for what is compared.

The fully dense pattern under the pure HASH methods (tables of 512 slots
probed in interpret mode) takes the reference about 12 s a run, so it lives
in test_torch_spgemm_hash_dense.py, on integer values.
"""

import pytest

pytest.importorskip("torch")

from torch_parity import ADVERSARIAL, adversarial, check_spgemm_parity

METHODS = ("hash-32/256", "hash-256/256", "h-hash-32/256", "h-hash-256/256")
SLOW = {("hash-32/256", "all_dense_cols"), ("hash-256/256", "all_dense_cols")}
PAIRS = [(m, c) for m in METHODS for c in ADVERSARIAL if (m, c) not in SLOW]


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("method,case", PAIRS)
def test_spgemm_matches_reference(method, case, values):
    a, b = adversarial(case)
    check_spgemm_parity(a, b, method, values)
