"""``str_200`` (Table 1) under the pure HASH methods, port against the JAX
package on integer values (atol=0).  Seed 4, as in test_torch_table1.py:
the heaviest column holds 428 products, so the first lane block probes
tables of 512 slots.  See
test_torch_table1.py."""

import pytest

pytest.importorskip("torch")

from repro_torch.sparse.suitesparse import synthesize_suitesparse
from torch_parity import check_spgemm_parity


@pytest.mark.parametrize("method", ["hash-32/256", "hash-256/256"])
def test_str_200_hash_matches_reference(method):
    a = synthesize_suitesparse("str_200", seed=4)[0]
    check_spgemm_parity(a, a, method, "int")
