"""The port's batched per-group path (kernel K4-b beside K2-b) against the
JAX package's ``execute_batched`` on the adversarial patterns, for the HASH
and H-HASH methods (the default method among them); see
test_torch_batched_spgemm.py for what is compared.

The fully dense pattern under the pure HASH methods (tables of 512 slots
probed in interpret mode: about 45 s a run at B = 2) is left out;
test_torch_spgemm_hash_dense.py holds the unbatched path on it to the JAX
package, and test_torch_batched_api.py the batched path to a loop of
unbatched executes.
"""

import pytest

pytest.importorskip("torch")

from torch_parity import ADVERSARIAL, adversarial, check_batched_parity

METHODS = ("hash-32/256", "hash-256/256", "h-hash-32/256", "h-hash-256/256")
SLOW = {("hash-32/256", "all_dense_cols"), ("hash-256/256", "all_dense_cols")}
PAIRS = [(m, c) for m in METHODS for c in ADVERSARIAL if (m, c) not in SLOW]


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("method,case", PAIRS)
def test_batched_spgemm_matches_reference(method, case, values):
    a, b = adversarial(case)
    check_batched_parity(a, b, method, values)
