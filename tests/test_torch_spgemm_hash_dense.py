"""The port's spgemm() against the JAX package's on the fully dense
adversarial pattern under the pure HASH methods: every column holds 400
products, so the tables have 512 slots (see test_torch_spgemm.py for what
is compared).  Integer values, compared with atol=0."""

import pytest

pytest.importorskip("torch")

from torch_parity import adversarial, check_spgemm_parity


@pytest.mark.parametrize("method", ["hash-32/256", "hash-256/256"])
def test_spgemm_matches_reference_dense(method):
    a, b = adversarial("all_dense_cols")
    check_spgemm_parity(a, b, method, "int")
