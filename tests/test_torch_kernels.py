"""K2 SPA, K3 SPARS and K4 HASH: the port's kernel wrappers against the JAX
package's Pallas kernels, on the same padded operands.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them on the CPU; the port's wrappers get CPU tensors, so they run their
kernels' plain versions (the CUDA kernels themselves are held against those
plain versions on the card, in test_torch_gpu.py and chip_smoke.py).

On integer-valued inputs every output must be equal with atol=0: SPA's
tile, SPARS's accumulator *and* flags, HASH's keys slot for slot and its
values.  On real-valued inputs values agree within REAL_RTOL/REAL_ATOL
(XLA and torch on the CPU may round differently); keys and flags, which do
not depend on values, stay exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.hash_spgemm import hash_spgemm as ref_hash
from repro.kernels.ref import spars_ref as jax_spars_ref
from repro.kernels.spa import spa_spgemm as ref_spa
from repro.kernels.spars import spars_spgemm as ref_spars
from repro_torch.core.analysis import HASH_C, hash_table_size
from repro_torch.kernels import hash_spgemm, spa_spgemm, spars_spgemm
from repro_torch.kernels.ref import (
    hash_tables_to_dense, spars_ref, spgemm_padded_ref,
)
from repro_torch.sparse import generate as tgen
from repro_torch.sparse.format import csc_from_dense, csc_to_padded_columns
from repro_torch.sparse.stats import ops_per_column, steps_per_column
from torch_parity import REAL_ATOL, REAL_RTOL, integer_valued

BLOCK = 16


def _case(name):
    """(a, b, h or None) — h None means the planner's size for max Op_j."""
    rng = np.random.default_rng(7)
    if name == "random":
        a = tgen.random_powerlaw_csc(40, 3.0, seed=3)
        return a, a, None
    if name == "empty_a_col":
        # B entries on empty A columns 0 and 7 around a real product: the
        # lock-step kernels still take a step for each (the trap)
        ad = np.zeros((12, 12))
        ad[[1, 4], 3] = (2.0, 3.0)
        bd = np.zeros((12, 16))
        bd[[0, 3, 7], 5] = (1.0, 4.0, 1.0)
        bd[0, 9] = 2.0                      # a lane with nothing but the trap
        bd[3, 2] = 1.0
        return csc_from_dense(ad), csc_from_dense(bd), None
    if name == "empty_b_cols":
        d = rng.normal(size=(20, 32)) * (rng.uniform(size=(20, 32)) < 0.3)
        d[:, ::2] = 0.0
        a = csc_from_dense(rng.normal(size=(24, 20))
                           * (rng.uniform(size=(24, 20)) < 0.3))
        return a, csc_from_dense(d), None
    if name == "all_empty":
        a = tgen.random_uniform_csc(16, 0)
        return a, a, None
    if name == "table_full":
        # Op_j = 3 on rows {1, 2, 3} plus a B entry on the empty A column 1,
        # which inserts key 0: 4 distinct keys fill the H = 4 table
        ad = np.zeros((8, 8))
        ad[[1, 2, 3], 0] = (1.0, 2.0, 3.0)
        bd = np.zeros((8, 16))
        bd[[0, 1], 4] = (2.0, 5.0)
        bd[0, 6] = 1.0
        return csc_from_dense(ad), csc_from_dense(bd), None
    if name == "chain_full":
        # 4 rows in one probe chain of a 4-slot table (below the planner's
        # size): every slot fills and the probe wraps the whole table
        h = 4
        rows = np.arange(h) * h + 1
        assert len(set((rows * HASH_C) % h)) == 1
        ad = np.zeros((h * h + 2, 16))
        ad[rows, 0] = np.arange(1.0, h + 1)
        bd = np.zeros((16, 16))
        bd[0, :3] = (2.0, -1.0, 0.5)
        return csc_from_dense(ad), csc_from_dense(bd), h
    if name == "h2":
        ad = np.eye(16)[:, rng.permutation(16)]
        bd = np.eye(16) * 3.0
        return csc_from_dense(ad), csc_from_dense(bd), 2
    if name == "pad_lanes":
        # 10 real lanes, padded to two blocks: the second is all padding
        a = tgen.random_powerlaw_csc(24, 3.0, seed=5)
        bd = rng.normal(size=(24, 10)) * (rng.uniform(size=(24, 10)) < 0.3)
        return a, csc_from_dense(bd), None
    raise AssertionError(name)


CASES = ("random", "empty_a_col", "empty_b_cols", "all_empty", "table_full",
         "chain_full", "h2", "pad_lanes")


def operands(name, values):
    """Padded operands of one case as CPU tensors, B padded to whole lane
    blocks, plus per-block trip counts and the table size."""
    a, b, h = _case(name)
    if values == "int":
        a, b = integer_valued(a, seed=1), integer_valued(b, seed=2)
    ar, av, an = csc_to_padded_columns(a)
    br, bv, bn = csc_to_padded_columns(b)
    n_real = b.n_cols
    n_pad = -(-max(n_real, 1) // BLOCK) * BLOCK
    if name == "pad_lanes":
        n_pad = 2 * BLOCK

    def pad(t):
        out = torch.zeros((n_pad,) + tuple(t.shape[1:]), dtype=t.dtype)
        out[:n_real] = t
        return out

    steps = np.zeros(n_pad, np.int64)
    steps[:n_real] = steps_per_column(a, b)
    ops = ops_per_column(a, b)
    return dict(
        a_rows=ar, a_vals=av.float(), a_nnz=an,
        b_rows=pad(br), b_vals=pad(bv.float()), b_nnz=pad(bn),
        steps=torch.from_numpy(
            steps.reshape(-1, BLOCK).max(axis=1).astype(np.int32)),
        m=a.n_rows,
        h=h if h is not None else hash_table_size(int(ops.max(initial=0))),
    )


def _jax(x):
    return jnp.asarray(x.numpy())


def _assert_values(got, want, values):
    got = got.numpy()
    want = np.asarray(want)
    if values == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=REAL_RTOL, atol=REAL_ATOL)


def _ab(op):
    return (op["a_rows"], op["a_vals"], op["a_nnz"], op["b_rows"],
            op["b_vals"], op["b_nnz"])


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_spa_matches_pallas(case, values):
    op = operands(case, values)
    got = spa_spgemm(*_ab(op), m=op["m"], block_cols=BLOCK)
    want = ref_spa(*map(_jax, _ab(op)), m=op["m"], block_cols=BLOCK,
                   interpret=True)
    _assert_values(got, want, values)


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_spars_matches_pallas(case, values):
    op = operands(case, values)
    acc, flags = spars_spgemm(*_ab(op), op["steps"], m=op["m"],
                              block_cols=BLOCK)
    want_acc, want_flags = ref_spars(*map(_jax, _ab(op)), _jax(op["steps"]),
                                     m=op["m"], block_cols=BLOCK,
                                     interpret=True)
    _assert_values(acc, want_acc, values)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags))


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_hash_matches_pallas(case, values):
    op = operands(case, values)
    keys, vals = hash_spgemm(*_ab(op), op["steps"], m=op["m"], h=op["h"],
                             block_cols=BLOCK)
    want_keys, want_vals = ref_hash(*map(_jax, _ab(op)), _jax(op["steps"]),
                                    m=op["m"], h=op["h"], block_cols=BLOCK,
                                    interpret=True)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want_keys))
    _assert_values(vals, want_vals, values)


def test_empty_a_column_trap():
    """A B entry on an empty A column takes a step: SPARS flags row 0 of its
    lane and HASH inserts key 0 with value 0 — as the reference kernels do,
    and unlike ``spars_ref`` (both packages' oracle leaves the flag unset)."""
    op = operands("empty_a_col", "int")
    acc, flags = spars_spgemm(*_ab(op), op["steps"], m=op["m"],
                              block_cols=BLOCK)
    _, oracle_flags = spars_ref(*_ab(op), op["m"])
    _, jax_oracle_flags = jax_spars_ref(*map(_jax, _ab(op)), op["m"])
    np.testing.assert_array_equal(oracle_flags.numpy(),
                                  np.asarray(jax_oracle_flags))
    # lane 9 holds only the trap entry; lane 5 has it around a real product
    assert flags[0, 9] == 1.0 and oracle_flags[0, 9] == 0.0
    assert flags[0, 5] == 1.0 and oracle_flags[0, 5] == 0.0
    assert acc[0, 9] == 0.0
    diff = (flags != oracle_flags).nonzero().tolist()
    assert diff == [[0, 5], [0, 9]]
    keys, vals = hash_spgemm(*_ab(op), op["steps"], m=op["m"], h=op["h"],
                             block_cols=BLOCK)
    slot = (keys[:, 9] == 0).nonzero().flatten().tolist()
    assert len(slot) == 1 and vals[slot[0], 9] == 0.0


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_agree_with_oracles(case):
    """On integer values every kernel's dense result equals the
    straightforward padded product (``kernels.ref``)."""
    op = operands(case, "int")
    want = spgemm_padded_ref(*_ab(op), op["m"]).numpy()
    np.testing.assert_array_equal(
        spa_spgemm(*_ab(op), m=op["m"], block_cols=BLOCK).numpy(), want)
    acc, _ = spars_spgemm(*_ab(op), op["steps"], m=op["m"], block_cols=BLOCK)
    np.testing.assert_array_equal(acc.numpy(), want)
    if case != "chain_full":  # the white-box table is smaller than planned
        keys, vals = hash_spgemm(*_ab(op), op["steps"], m=op["m"], h=op["h"],
                                 block_cols=BLOCK)
        np.testing.assert_array_equal(
            hash_tables_to_dense(keys, vals, op["m"]).numpy(), want)


def test_table_full_is_full():
    op = operands("table_full", "int")
    keys, _ = hash_spgemm(*_ab(op), op["steps"], m=op["m"], h=op["h"],
                          block_cols=BLOCK)
    assert op["h"] == 4
    assert sorted(keys[:, 4].tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "block", "steps",
                                 "h", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    op = operands("random", "int")
    args = list(_ab(op))
    kw = dict(m=op["m"], h=op["h"], block_cols=BLOCK)
    steps = op["steps"]
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "noncontig":
        args[4] = args[4].t().contiguous().t()
    elif bad == "block":
        kw["block_cols"] = 2 * BLOCK   # n_b = 48 is no multiple of 32
    elif bad == "steps":
        steps = steps[:-1] if len(steps) > 1 else steps.repeat(2)
    elif bad == "h":
        kw["h"] = 12
    elif bad == "device":
        kw["device"] = "cuda"   # CPU tensors may not run where CUDA was asked
    with pytest.raises((TypeError, ValueError)):
        hash_spgemm(*args, steps, **kw)
    if bad not in ("h", "steps"):
        kw.pop("h")
        with pytest.raises((TypeError, ValueError)):
            spa_spgemm(*args, **kw)
        with pytest.raises((TypeError, ValueError)):
            spars_spgemm(*args, steps, **kw)
