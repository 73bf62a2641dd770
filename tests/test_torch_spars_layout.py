"""K3 SPARS on K2's slice design: the cases the kernel must get right.

The kernel (``csrc/spars.cu`` on ``csrc/slice_kernel.cuh``) is K2's slice
kernel in lock-step, so its hard cases are where SPARS leaves SPA: an entry
on an empty A column takes one step on that column's padding slot 0 (here a
``-0.0`` product under a negative B value, and padding slots holding other
rows and values than 0), trip counts that cut a lane inside an A column or
are 0, lane blocks of 8 and 32 columns with different trip counts, a small
arrow, and ``m`` off a multiple of the kernel's 512-row slice.  On the CPU
the wrapper runs its plain version, held here against the JAX package's
Pallas SPARS kernel in interpret mode: integer values bit for bit, normal
values within REAL_RTOL/REAL_ATOL (XLA and torch on the CPU may round
differently), flags exactly.  Only finite values: on a product that is not
finite the reference's one-hot store spreads NaN over its whole lane, the
port keeps it in the product's row (ROADMAP Queue C), and
``tests/test_torch_gpu.py`` holds kernel against plain version there.

The design's premise is checked too: at full trip counts, on plan-built
operands, SPARS's accumulator equals SPA's bit for bit, since both add each
cell's products in (B entry, A entry) order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.spars import spars_spgemm as ref_spars
from repro_torch.core import plan_spgemm
from repro_torch.core.planner import BLOCK_COLS
from repro_torch.kernels import spa_spgemm_plain, spars_spgemm, \
    spars_spgemm_plain
from repro_torch.sparse import CSC, generate
from repro_torch.sparse.format import _np, padded_values
from torch_parity import REAL_ATOL, REAL_RTOL

# (m, A column lengths, B column lengths, arrow): "arrow" puts row m - 1 in
# every nonempty A column
CASES = {
    "empty_a_first": (40, [0, 4, 0, 6, 3, 0, 5, 2], [3, 5, 1, 0, 4, 2, 6, 3]
                      * 2, False),
    "cut_inside_a_column": (60, [5, 7, 6, 5, 7, 6] * 4, [4, 6, 5, 3] * 4,
                            False),
    "caps_per_block": (80, [3, 0, 4, 5, 2, 6] * 8, list(range(1, 9)) * 8,
                       False),
    "small_arrow": (70, [3] * 60 + [30], [40] + [4] * 15, True),
    "m_off_the_slice": (515, [9, 0, 12, 7] * 10, [6, 2, 9, 4] * 4, False),
}


def operands(case, values, seed=0):
    """Padded K3 operands of CASES[case] as CPU tensors: A's rows unsorted;
    A's padding slots hold random rows and values, which the step on an
    empty A column reads (slot 0) and no other step does; B's padding random
    too.  "empty_a_first" instead pads as a plan does (row 0, value 0) and
    opens each B column with a negative value on an empty A column, so that
    its first step adds -0.0 to row 0.  ``values``: "int" (signed integers,
    sums exact) or "real" (standard normal)."""
    m, a_lens, b_lens, arrow = CASES[case]
    rng = np.random.default_rng([seed, len(case)])
    n_a, n_b = len(a_lens), len(b_lens)
    za, zb = max(a_lens), max(b_lens)

    def vals(dims):
        if values == "int":
            return (rng.integers(1, 4, dims)
                    * rng.choice([-1, 1], dims)).astype(np.float32)
        return rng.standard_normal(dims).astype(np.float32)

    a_rows = rng.integers(0, m, (n_a, za)).astype(np.int32)
    a_vals = vals((n_a, za))
    for k, n in enumerate(a_lens):
        a_rows[k, :n] = rng.choice(m, n, replace=False)
        if arrow and n and m - 1 not in a_rows[k, :n]:
            a_rows[k, rng.integers(n)] = m - 1
    b_rows = rng.integers(0, n_a, (n_b, zb)).astype(np.int32)
    b_vals = vals((n_b, zb))
    for c, n in enumerate(b_lens):
        b_rows[c, :n] = np.sort(rng.choice(n_a, n, replace=False))
    if case == "empty_a_first":
        empty = [k for k, n in enumerate(a_lens) if n == 0]
        a_rows[empty] = 0
        a_vals[empty] = 0.0
        for c, n in enumerate(b_lens):
            if n:
                first = empty[c % len(empty)]
                rest = np.setdiff1d(np.arange(n_a), [first])
                b_rows[c, :n] = np.r_[first, np.sort(rng.choice(
                    rest, n - 1, replace=False))]
                b_vals[c, 0] = -abs(b_vals[c, 0])
    return (torch.from_numpy(a_rows), torch.from_numpy(a_vals),
            torch.tensor(a_lens, dtype=torch.int32), torch.from_numpy(b_rows),
            torch.from_numpy(b_vals), torch.tensor(b_lens, dtype=torch.int32))


def lane_steps(ab):
    """Steps of each lane at full trip count: sum of max(nnz(A[:, k]), 1)
    over its B entries."""
    _, _, a_nnz, b_rows, _, b_nnz = ab
    per = torch.clamp(a_nnz, min=1)[b_rows.long()]
    live = torch.arange(b_rows.shape[1])[None, :] < b_nnz[:, None]
    return (per * live).sum(1).numpy()


def trip_counts(ab, block, cut):
    """Per lane block of ``block`` columns: "full" (the block's largest
    lane), "half" (half of it, rounded up: lanes stop inside A columns),
    "mixed" (block i keeps i/(n-1) of its full count, so block 0 takes 0
    steps and the last all of them)."""
    full = lane_steps(ab).reshape(-1, block).max(1)
    if cut == "half":
        full = (full + 1) // 2
    elif cut == "mixed":
        n = len(full)
        full = full * np.arange(n) // max(n - 1, 1)
    return torch.from_numpy(full.astype(np.int32))


def _jax(x):
    return jnp.asarray(x.numpy())


def bits(x):
    return torch.as_tensor(np.array(x)).contiguous().view(torch.int32)


def check_against_pallas(ab, steps, m, block, values):
    acc, flags = spars_spgemm(*ab, steps, m=m, block_cols=block,
                              device="cpu")
    want_acc, want_flags = ref_spars(*map(_jax, ab), _jax(steps), m=m,
                                     block_cols=block)
    assert torch.equal(flags, torch.from_numpy(np.array(want_flags)))
    if values == "int":
        # bit for bit, -0.0 against +0.0 included
        assert torch.equal(bits(acc), bits(want_acc))
    else:
        np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc),
                                   rtol=REAL_RTOL, atol=REAL_ATOL)
    return acc, flags


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("cut", ["full", "half", "mixed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spars_case_matches_pallas(case, cut, values):
    ab = operands(case, values)
    m = CASES[case][0]
    block = 8
    check_against_pallas(ab, trip_counts(ab, block, cut), m, block, values)


def test_empty_a_column_first_adds_minus_zero_as_plus_zero():
    """Each lane's first step multiplies a padding value 0 by a negative B
    value: the cell of row 0 takes -0.0 onto +0.0, stays +0.0, and is
    flagged."""
    ab = operands("empty_a_first", "int")
    m = CASES["empty_a_first"][0]
    steps = torch.ones(2, dtype=torch.int32)   # the first step alone
    acc, flags = check_against_pallas(ab, steps, m, 8, "int")
    lanes = ab[5] > 0
    assert torch.equal(bits(acc), torch.zeros_like(bits(acc)))
    assert torch.equal(flags[0], lanes.float())
    assert flags[1:].sum() == 0


@pytest.mark.parametrize("block", [8, 32])
def test_lane_blocks_take_their_own_trip_counts(block):
    """Lane blocks of 8 and of 32 columns in one launch, each cut at its own
    count; a lane past its count adds nothing more, and a block with count
    0 yields zeros and no flags."""
    ab = operands("caps_per_block", "int")
    m = CASES["caps_per_block"][0]
    steps = trip_counts(ab, block, "mixed")
    assert steps[0] == 0 and len(set(steps.tolist())) > 1
    acc, flags = check_against_pallas(ab, steps, m, block, "int")
    assert not acc[:, :block].any() and not flags[:, :block].any()
    full = spars_spgemm_plain(*ab, trip_counts(ab, block, "full"), m=m,
                              block_cols=block)
    assert torch.equal(acc[:, -block:], full[0][:, -block:])


def test_half_trip_counts_cut_inside_an_a_column():
    """At half its full count some lane stops inside an A column: part of
    that column's rows are flagged, the rest not."""
    ab = operands("cut_inside_a_column", "int")
    m = CASES["cut_inside_a_column"][0]
    steps = trip_counts(ab, 8, "half")
    _, flags = check_against_pallas(ab, steps, m, 8, "int")
    a_rows, _, a_nnz, b_rows, _, b_nnz = ab
    cut = 0
    for c in range(b_rows.shape[0]):
        cap = int(steps[c // 8])
        s = 0
        for e in range(int(b_nnz[c])):
            k = int(b_rows[c, e])
            n = int(a_nnz[k])
            if s < cap < s + n:
                rows = a_rows[k, :n].long()
                assert flags[rows[:cap - s], c].all()
                cut += 1
            s += max(n, 1)
    assert cut > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spars_accumulator_equals_spa_on_plan_operands(seed):
    """At full trip counts on a plan's operands (padding row 0, value 0),
    SPARS's acc equals SPA's tile bit for bit, and its flags mark exactly
    the cells a product touched: the pattern of A·B, and row 0 of each lane
    with a B entry on an empty A column."""
    a = generate.random_powerlaw_csc(300, 6.0, seed=seed)
    rng = np.random.default_rng(seed)
    a = CSC(torch.from_numpy(rng.standard_normal(a.nnz).astype(np.float32)),
            a.row_indices, a.col_ptr, a.shape)
    plan = plan_spgemm(a, a, "spars-16/64", device="cpu")
    lay = plan.layout
    av = padded_values(a.values, lay.a_gather, lay.a_mask)
    dense_a = np.zeros(a.shape)
    cp, ri = _np(a.col_ptr), _np(a.row_indices)
    for k in range(a.n_cols):
        dense_a[ri[cp[k]:cp[k + 1]], k] = 1.0
    empty = np.diff(cp) == 0
    groups = [g for g in lay.groups if g.kind == "spars"]
    assert groups
    for g in groups:
        ab = (lay.a_rows, av, lay.a_nnz, g.b_rows,
              padded_values(a.values, g.b_vgather, g.b_vmask), g.b_nnz)
        acc, flags = spars_spgemm_plain(*ab, g.steps, m=a.n_rows,
                                        block_cols=BLOCK_COLS)
        assert torch.equal(bits(acc), bits(spa_spgemm_plain(*ab,
                                                            m=a.n_rows)))
        b = np.zeros((a.n_cols, g.b_rows.shape[0]))
        on_empty = np.zeros(g.b_rows.shape[0], bool)
        for c in range(g.b_rows.shape[0]):
            ks = g.b_rows[c, :int(g.b_nnz[c])].numpy()
            b[ks, c] = 1.0
            on_empty[c] = empty[ks].any()
        touched = dense_a @ b > 0
        touched[0] |= on_empty
        assert torch.equal(flags, torch.from_numpy(touched).float())
