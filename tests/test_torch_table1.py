"""The port's spgemm() against the JAX package's on two of the paper's
Table-1 matrices, synthesized by the port (deterministic in every process)
and carried across as numpy arrays: ``oscil_dcop_30`` (430×430, HASH
tables up to 64 slots, seed 0) and ``str_200`` (363×363; seed 4, whose
heaviest column holds 428 products, near the published 449).  C = A·A for every kernel-family method on integer values
(atol=0), and on the synthesized real values for ``oscil_dcop_30``.
``str_200`` under the pure HASH methods (tables of 512 slots, about 15 s a
run in the reference's interpret mode) is in test_torch_table1_hash.py.
"""

import functools

import pytest

pytest.importorskip("torch")

from repro_torch.sparse.suitesparse import synthesize_suitesparse
from torch_parity import KERNEL_METHODS, check_spgemm_parity

SLOW = ("hash-32/256", "hash-256/256")
SEEDS = {"oscil_dcop_30": 0, "str_200": 4}


@functools.lru_cache(maxsize=None)
def table1(name):
    return synthesize_suitesparse(name, seed=SEEDS[name])[0]


CASES = ([("oscil_dcop_30", m, v) for m in KERNEL_METHODS
          for v in ("int", "real")]
         + [("str_200", m, "int") for m in KERNEL_METHODS if m not in SLOW])


@pytest.mark.parametrize("name,method,values", CASES)
def test_table1_matches_reference(name, method, values):
    a = table1(name)
    check_spgemm_parity(a, a, method, values)
