"""K4 HASH: the table layouts the warp-per-lane kernel must reproduce, and
its launch layout.

The kernel (``csrc/hash_spgemm.cu``) finds a round of 32 steps' slots at once
and commits new rows up to the first clash, so its hard cases are probing
that wraps from slot h-1 to 0, a lane whose rows all share one home slot,
one row with many products in a lane (a small arrow), a lane with more
distinct rows than one round of 32, and an empty A column met first (key 0
with a ±0 product, then real products on row 0).  On the CPU the wrapper
runs its plain version, held here slot for slot against the JAX package's
Pallas kernel in interpret mode (integer values exactly; normal values
within REAL_RTOL/REAL_ATOL, as XLA and torch on the CPU may round
differently); ``tests/test_torch_gpu.py`` holds the kernel against the plain
version on the same cases on the card, in both table tiers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.hash_spgemm import hash_spgemm as ref_hash
from repro_torch import kernels
from repro_torch.core.analysis import HASH_C, hash_table_size
from repro_torch.kernels import hash_spgemm
from repro_torch.kernels.hash_spgemm import (
    MAX_LANES, SETS, SMEM_BYTES, TIERS, cta_bytes, hash_layout,
)
from repro_torch.sparse.format import CSC, csc_from_dense, \
    csc_to_padded_columns
from repro_torch.sparse.stats import ops_per_column, steps_per_column
from test_torch_gpu import HASH_BLOCK as BLOCK, _hash_case
from torch_parity import REAL_ATOL, REAL_RTOL

# the cases of tests/test_torch_gpu.py small enough for the reference in
# interpret mode (its "tier_global" table of 32768 slots is not)
CASES = ("wrap", "one_home", "small_arrow", "many_rows", "empty_a_first")


def home(r, h):
    return (r * (HASH_C & 0x7FFFFFFF)) % h


def with_values(pattern, values: str, seed: int) -> CSC:
    """The CSC of a 0/1 pattern with values in {1, 2, 3} ("int") or standard
    normal ("real")."""
    m = csc_from_dense(pattern)
    rng = np.random.default_rng(seed)
    v = (rng.integers(1, 4, m.nnz) if values == "int"
         else rng.standard_normal(m.nnz)).astype(np.float32)
    return CSC(torch.from_numpy(v), m.row_indices, m.col_ptr, m.shape)


def operands(name, values):
    """Padded K4 operands of one case as CPU tensors; h None is the
    planner's size for the largest Op_j."""
    a, b, h = _hash_case(name)
    a, b = with_values(a, values, 1), with_values(b, values, 2)
    ar, av, an = csc_to_padded_columns(a)
    br, bv, bn = csc_to_padded_columns(b)
    steps = steps_per_column(a, b).reshape(-1, BLOCK).max(axis=1)
    return dict(
        ab=(ar, av.float(), an, br, bv.float(), bn),
        steps=torch.from_numpy(steps.astype(np.int32)), m=a.n_rows,
        h=h if h is not None else hash_table_size(
            int(ops_per_column(a, b).max(initial=0))))


def _jax(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_hash_case_matches_pallas(case, values):
    op = operands(case, values)
    keys, vals = hash_spgemm(*op["ab"], op["steps"], m=op["m"], h=op["h"],
                             block_cols=BLOCK)
    want_keys, want_vals = ref_hash(*map(_jax, op["ab"]), _jax(op["steps"]),
                                    m=op["m"], h=op["h"], block_cols=BLOCK,
                                    interpret=True)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want_keys))
    if values == "int":
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    else:
        np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals),
                                   rtol=REAL_RTOL, atol=REAL_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_hash_case_has_its_shape(case):
    """Each case's tables show what it is meant to exercise."""
    op = operands(case, "int")
    keys, vals = hash_spgemm(*op["ab"], op["steps"], m=op["m"], h=op["h"],
                             block_cols=BLOCK)
    h = op["h"]
    lane0 = keys[:, 0].tolist()
    if case == "wrap":
        assert [lane0[7], lane0[0], lane0[1]] == [7, 15, 23]
        assert lane0.index(0) == 2 and lane0.index(8) == 3
    elif case == "one_home":
        taken = [s for s, k in enumerate(lane0) if k >= 0]
        assert len(taken) == 12
        assert all(home(k, h) == 5 for k in lane0 if k >= 0)
        assert lane0[4] == -1 and lane0[0] >= 0   # the chain wrapped
    elif case == "small_arrow":
        slot = lane0.index(39)
        assert vals[slot, 0] >= 60               # 60 products of at least 1
    elif case == "many_rows":
        assert sum(k >= 0 for k in lane0) == 50 and h == 64
    else:
        lane1 = keys[:, 1].tolist()
        assert 0 in lane0 and 0 in lane1
        assert vals[lane1.index(0), 1] == 0.0    # the trap alone: ±0
        assert vals[lane0.index(0), 0] > 0.0     # the trap, then row 0


@pytest.mark.parametrize("h", [1, 2, 8, 64, 1024, 4096, 8192, 16384])
@pytest.mark.parametrize("batch", [1, 2, 3, 8])
def test_shared_tier_layout_fits(h, batch):
    """Up to h = 16384 the tables stay on chip: the CTA's tables and staging
    fit its shared memory, lanes a power of two, and the value sets a CTA
    holds never exceed the batch's next power of two."""
    tier, lanes, sets = hash_layout(h, batch)
    assert tier == "shared"
    assert cta_bytes(h, lanes, sets) <= SMEM_BYTES
    assert lanes in (1, 2, 4) and lanes <= MAX_LANES
    assert sets in SETS and sets < 2 * batch or sets == 1
    # the most sets that fit, then the most lanes
    bigger = [s for s in SETS if sets < s < 2 * batch]
    assert all(cta_bytes(h, 1, s) > SMEM_BYTES for s in bigger)
    assert lanes == MAX_LANES or cta_bytes(h, 2 * lanes, sets) > SMEM_BYTES


@pytest.mark.parametrize("h", [32768, 65536, 1 << 20])
def test_global_tier_past_shared_memory(h):
    """Past 8 h bytes of shared memory, one value set a CTA on tables in
    device memory; the tier depends on h alone."""
    assert cta_bytes(h, 1, 1) > SMEM_BYTES
    assert {hash_layout(h, b) for b in (1, 3, 8)} == {("global", MAX_LANES,
                                                       1)}
    assert cta_bytes(h, MAX_LANES, 1, "global") <= SMEM_BYTES


def test_the_timed_groups_table_size():
    """iprob's largest HASH group (h = 16384) is one lane a CTA, and two
    value sets a CTA at B = 8: 128 and 512 CTAs for a group of 128."""
    assert hash_layout(16384, 1) == ("shared", 1, 1)
    assert hash_layout(16384, 8) == ("shared", 1, 2)
    assert hash_layout(64, 8) == ("shared", 4, 8)


def test_cpu_wrappers_count_no_tier():
    """On the CPU the wrappers run the plain version: no launch, in no tier;
    reset_launch_counts zeroes the per-tier counts too."""
    op = operands("wrap", "int")
    kernels.reset_launch_counts()
    hash_spgemm(*op["ab"], op["steps"], m=op["m"], h=op["h"],
                block_cols=BLOCK)
    for fn in (kernels.hash_spgemm, kernels.hash_spgemm_batched):
        assert fn.n_launches == 0
        assert fn.n_launches_by_tier == dict.fromkeys(TIERS, 0)
    kernels.hash_spgemm.n_launches_by_tier["shared"] = 5
    kernels.reset_launch_counts()
    assert kernels.hash_spgemm.n_launches_by_tier["shared"] == 0
