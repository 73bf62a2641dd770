"""The CUDA kernels on the card: each against its plain PyTorch version on
the same CUDA tensors, and spgemm() on the card against spgemm() on the
CPU, on the per-group path and on the fused path (K1, forward and
backward); the batched kernels K1-b … K4-b against their plain versions
and, slice by slice, against the unbatched kernels, and the batched
executes' host waits; K5 and K5-b (the BSR kernel) against their plain
versions and each other, in f32 and on bf16 operands (launched, never
widened around the f32 kernel), and the sparse FFN on the card against the
same FFN on the CPU, on f32 and bf16 activations; the torch stream (``backend="torch"``) on the card
against its CPU run and the fused engine on integer values, bit-stable and
batched == looped on real ones, with no host wait; and the gradient of
``[B, nnz]`` stacks on both stream engines against a loop; and the tiled
path (``method="auto"``): the card's merge of row blocks against the host's
numpy merge of the same children, bit-stable, batched == looped, its host
waits; and the machine profile's calibration on the card (its fingerprint
names the card, its ``fused`` ladder launches K1); and the dense model stack
with its FFNs on the SpGEMM stream: a smoke-size sparse ``decode_step`` on
the card against the dense oracle, with no host wait after its first step,
and K1 against the torch stream on one FFN plan; and the MoE, SSM and
hybrid families: a smoke-size ``decode_step`` on the card against the same
model on the CPU, with no host wait after its first step, and the MoE
dispatch as SpGEMM launching K2, exact on integer values; and the
serving engine on the VLM and encoder-decoder families: the CPU engine's
tokens and logits, one host sync a tick, bit-stable ticks, and params on
another device refused; and training: a smoke-size train step on the card
against the same step on the CPU, bit-stable run to run with no op that
PyTorch knows to be nondeterministic, and the sparse-FFN train step warm
with no host sync and no plan built, its gradient through K1 equal to the
torch stream's; and the SpGEMM mesh with its shards on the card: the
host stream bit for bit on integer values, the torch plan's gradients, no
host wait an execute, and more shards than cards refused without
``device=``; and the multi-device pieces on the one card: the pipelined
smoke-size stack bit for bit the unpipelined one, ``psum_compressed`` on
2 shards bit-stable and the hand-computed mean, and
``restore_checkpoint(shardings=)`` placing each leaf on the card; and the
model stack on bf16 params: a decode step with no host wait, bit-stable,
near the f32 run on the same weights, two train steps bit-stable, and a
bf16 product refused while cuBLAS may reduce it in bf16.  Every test
needs a card (marker ``gpu``) and skips without one; the ``cuda`` fixture
sets ``allow_bf16_reduced_precision_reduction`` to False.

The module pins ``REPRO_PROFILE_DIR`` to a path nothing writes before any
profile is consulted (as ``tests/conftest.py`` does for the CPU suite,
which this run skips), so a profile in the user's cache never re-ranks the
tiled tests' picks; the calibration tests write into their own ``tmp_path``.

On the card these run without the JAX-importing conftest, which that
machine cannot import::

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \
        tests/test_torch_gpu.py

Each cell takes its products in one order in the kernel and in its plain
version, with no fused multiply-add, so they must agree exactly — on
real-valued inputs too.  The one exception is K5's tensor-core body (8x8
blocks on bf16 x), which sums in the MMA's order: it is held to the bound
``kernels.bsr_mma_check`` derives, and exactly on integer values, batched
against looped and run against run.
"""

import itertools
import os
import tempfile
import warnings

import numpy as np
import pytest

os.environ.setdefault(
    "REPRO_PROFILE_DIR",
    os.path.join(tempfile.gettempdir(), "repro-torch-gpu-profiles-unwritten"))
os.environ.pop("REPRO_PROFILE_FILE", None)
os.environ.pop("REPRO_AUTO_CALIBRATE", None)

torch = pytest.importorskip("torch")  # noqa: E402

from repro_torch import kernels
from repro_torch.core import cached_plan, fused_stream, plan_spgemm, spgemm, \
    spgemm_batched
from repro_torch.core.analysis import hash_table_size
from repro_torch.sparse import generate
from repro_torch.sparse.format import BatchedCSC, _np, csc_to_padded_columns
from repro_torch.sparse.stats import ops_per_column, steps_per_column

pytestmark = pytest.mark.gpu

METHODS = ("spa", "spars-16/64", "spars-40/40", "h-spa-16/64", "h-spa-40/40",
           "hash-32/256", "hash-256/256", "h-hash-32/256", "h-hash-256/256")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    # the model's bf16 products sum in f32, as the reference's bf16 dot
    # (models.layers.check_full_f32 refuses them otherwise)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _operands(dev, n=200, block=32, seed=0):
    a = generate.random_powerlaw_csc(n, 6.0, seed=seed)
    ar, av, an = csc_to_padded_columns(a)
    n_pad = -(-n // block) * block
    steps = np.zeros(n_pad, np.int64)
    steps[:n] = steps_per_column(a, a)
    pad = n_pad - n
    return dict(
        ab=tuple(x.to(dev) for x in (
            ar, av.float(), an,
            torch.nn.functional.pad(ar, (0, 0, 0, pad)),
            torch.nn.functional.pad(av.float(), (0, 0, 0, pad)),
            torch.nn.functional.pad(an, (0, pad)))),
        steps=torch.from_numpy(steps.reshape(-1, block).max(axis=1)
                               .astype(np.int32)).to(dev),
        m=n, block=block,
        h=hash_table_size(int(ops_per_column(a, a).max())))


def test_spa_kernel_equals_plain(cuda):
    op = _operands(cuda)
    before = kernels.spa_spgemm.n_launches
    got = kernels.spa_spgemm(*op["ab"], m=op["m"], block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.spa_spgemm.n_launches == before + 1
    want = kernels.spa_spgemm_plain(*op["ab"], m=op["m"])
    assert torch.equal(got, want)


# K2's edge cases (columns, slices of 512 rows, CTAs of 8 columns), as (m,
# A column lengths, B column lengths, shape): A's rows are drawn without
# order, the padding slots hold rows and values that must never be read;
# "arrow": every short A column holds row m - 1, "hub": every B column
# names A column 0
SPA_CASES = {
    # iprob's shape: one B column of 3000 entries over A columns of 3 rows,
    # each holding the arrow row m - 1
    "long_b_column": (3001, [3] * 3000 + [3000], [3000] + [4] * 127, "arrow"),
    # one A column of 2500 entries named by every B column
    "long_a_column": (2600, [2500] + [3] * 399, [20] * 64, "hub"),
    "m_not_a_multiple_of_the_slice": (1000, [30] * 300, [40] * 32, None),
    "m_below_one_slice": (5, [3] * 20, [10] * 16, None),
    "m_past_four_slices": (2300, [400] * 100, [60] * 16, None),
    "empty_a_and_b_columns": (300, [0, 5, 0, 0, 17, 0] * 10,
                              [0, 3, 0, 12, 0, 0, 60, 0], None),
    "one_cta_of_columns_and_padding": (400, [60] * 200,
                                       [150, 7, 0, 90] + [0] * 4, None),
}


def _spa_operands(dev, case, integer, batch=None):
    """Padded K2 operands of SPA_CASES[case]: A's rows unsorted, padding
    slots filled with rows and values that are never read."""
    m, a_lens, b_lens, shape = SPA_CASES[case]
    rng = np.random.default_rng(len(case))
    n_a, n_b = len(a_lens), len(b_lens)
    za, zb = max(a_lens), max(b_lens)
    lead = () if batch is None else (batch,)

    def vals(dims):
        if integer:
            return rng.integers(1, 4, dims).astype(np.float32)
        return rng.standard_normal(dims).astype(np.float32)

    a_rows = rng.integers(0, m, (n_a, za)).astype(np.int32)
    for k, n in enumerate(a_lens):
        a_rows[k, :n] = rng.choice(m, n, replace=False)
        if shape == "arrow" and 0 < n < za and m - 1 not in a_rows[k, :n]:
            a_rows[k, rng.integers(n)] = m - 1
    b_rows = rng.integers(0, n_a, (n_b, zb)).astype(np.int32)
    for c, n in enumerate(b_lens):
        b_rows[c, :n] = np.sort(rng.choice(n_a, n, replace=False))
        if shape == "hub" and n and 0 not in b_rows[c, :n]:
            b_rows[c, :n] = np.sort(np.r_[0, b_rows[c, 1:n]])
    ops = (a_rows, vals(lead + (n_a, za)), np.array(a_lens, np.int32),
           b_rows, vals(lead + (n_b, zb)), np.array(b_lens, np.int32))
    return tuple(torch.from_numpy(x).to(dev) for x in ops), m


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", sorted(SPA_CASES))
def test_spa_kernel_edge_cases_equal_plain(cuda, case, integer):
    ab, m = _spa_operands(cuda, case, integer)
    before = kernels.spa_spgemm.n_launches
    got = kernels.spa_spgemm(*ab, m=m, block_cols=ab[3].shape[0])
    torch.cuda.synchronize()
    assert kernels.spa_spgemm.n_launches == before + 1
    assert torch.equal(got, kernels.spa_spgemm_plain(*ab, m=m))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", sorted(SPA_CASES))
def test_spa_batched_kernel_edge_cases_equal_plain_and_slices(cuda, case,
                                                              integer):
    ab, m = _spa_operands(cuda, case, integer, batch=3)
    got = kernels.spa_spgemm_batched(*ab, m=m, block_cols=ab[3].shape[0])
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.spa_spgemm_batched_plain(*ab, m=m))
    ar, av, an, br, bv, bn = ab
    for b in range(3):
        assert torch.equal(got[b], kernels.spa_spgemm(
            ar, av[b].contiguous(), an, br, bv[b].contiguous(), bn, m=m,
            block_cols=br.shape[0]))


def test_spars_kernel_equals_plain(cuda):
    op = _operands(cuda)
    before = kernels.spars_spgemm.n_launches
    acc, flags = kernels.spars_spgemm(*op["ab"], op["steps"], m=op["m"],
                                      block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.spars_spgemm.n_launches == before + 1
    want_acc, want_flags = kernels.spars_spgemm_plain(
        *op["ab"], op["steps"], m=op["m"], block_cols=op["block"])
    assert torch.equal(acc, want_acc) and torch.equal(flags, want_flags)


SPARS_BLOCK = 8   # K3's lane blocks on K2's edge cases: a trip count each


def _spars_steps(ab, cut):
    """Trip counts of K2-style operands per lane block of SPARS_BLOCK
    columns: the block's largest lane ("full": sum of max(nnz(A[:, k]), 1)
    over its B entries) or half of it, rounded up ("half": lanes stop inside
    A columns, each block at its own count)."""
    _, _, a_nnz, b_rows, _, b_nnz = ab
    per = torch.clamp(a_nnz, min=1)[b_rows.long()]
    live = (torch.arange(b_rows.shape[1], device=b_rows.device)[None, :]
            < b_nnz[:, None])
    full = (per * live).sum(1).reshape(-1, SPARS_BLOCK).max(1).values
    return (full if cut == "full" else (full + 1) // 2).int().contiguous()


@pytest.mark.parametrize("cut", ["full", "half"])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", sorted(SPA_CASES))
def test_spars_kernel_edge_cases_equal_plain(cuda, case, integer, cut):
    """K3 on K2's edge cases, whose A padding slots hold random rows and
    values (the step on an empty A column reads slot 0), at full and at
    half trip counts."""
    ab, m = _spa_operands(cuda, case, integer)
    steps = _spars_steps(ab, cut)
    before = kernels.spars_spgemm.n_launches
    got = kernels.spars_spgemm(*ab, steps, m=m, block_cols=SPARS_BLOCK)
    torch.cuda.synchronize()
    assert kernels.spars_spgemm.n_launches == before + 1
    want = kernels.spars_spgemm_plain(*ab, steps, m=m,
                                      block_cols=SPARS_BLOCK)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("cut", ["full", "half"])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", sorted(SPA_CASES))
def test_spars_batched_kernel_edge_cases_equal_plain_and_slices(
        cuda, case, integer, cut):
    ab, m = _spa_operands(cuda, case, integer, batch=3)
    steps = _spars_steps(ab, cut)
    got = kernels.spars_spgemm_batched(*ab, steps, m=m,
                                       block_cols=SPARS_BLOCK)
    torch.cuda.synchronize()
    want = kernels.spars_spgemm_batched_plain(*ab, steps, m=m,
                                              block_cols=SPARS_BLOCK)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ar, av, an, br, bv, bn = ab
    for b in range(3):
        one = kernels.spars_spgemm(ar, av[b].contiguous(), an, br,
                                   bv[b].contiguous(), bn, steps, m=m,
                                   block_cols=SPARS_BLOCK)
        assert all(torch.equal(g[b], w) for g, w in zip(got, one))


def test_spars_kernel_keeps_a_non_finite_product_in_its_row(cuda):
    """inf in B against empty A columns (padding value 0: 0 * inf is NaN)
    and -inf against others, over phase-mode and list-mode columns (more
    than 64 B entries) and two row slices: kernel and plain version give the
    same NaN and inf cells, and a NaN stays in its product's row."""
    rng = np.random.default_rng(15)
    m, n_a = 700, 120
    a_lens = rng.integers(1, 9, n_a) * (np.arange(n_a) % 3 != 0)
    b_lens = np.array([90, 5, 70, 0, 12, 100, 1, 30] * 2)
    za, zb = int(a_lens.max()), int(b_lens.max())
    a_rows = rng.integers(0, m, (n_a, za)).astype(np.int32)
    a_vals = rng.standard_normal((n_a, za)).astype(np.float32)
    for k, n in enumerate(a_lens):
        a_rows[k, :n] = rng.choice(m, n, replace=False)
    a_vals[a_lens == 0, 0] = 0.0
    b_rows = rng.integers(0, n_a, (len(b_lens), zb)).astype(np.int32)
    b_vals = rng.standard_normal((len(b_lens), zb)).astype(np.float32)
    for c, n in enumerate(b_lens):
        b_rows[c, :n] = rng.choice(n_a, n, replace=False)
        b_vals[c, :n][a_lens[b_rows[c, :n]] == 0] = np.inf
        b_vals[c, :n][rng.uniform(size=n) < 0.02] = -np.inf
    ab = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in (
        a_rows, a_vals, a_lens.astype(np.int32), b_rows, b_vals,
        b_lens.astype(np.int32)))
    for cut in ("full", "half"):
        steps = _spars_steps(ab, cut)
        acc, flags = kernels.spars_spgemm(*ab, steps, m=m,
                                          block_cols=SPARS_BLOCK)
        torch.cuda.synchronize()
        want_acc, want_flags = kernels.spars_spgemm_plain(
            *ab, steps, m=m, block_cols=SPARS_BLOCK)
        assert want_acc.isnan().any() and want_acc.isinf().any()
        assert not want_acc.isnan().all(0).any()
        torch.testing.assert_close(acc, want_acc, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.equal(flags, want_flags)


def test_hash_kernel_equals_plain(cuda):
    op = _operands(cuda)
    before = kernels.hash_spgemm.n_launches
    keys, vals = kernels.hash_spgemm(*op["ab"], op["steps"], m=op["m"],
                                     h=op["h"], block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.hash_spgemm.n_launches == before + 1
    want_keys, want_vals = kernels.hash_spgemm_plain(
        *op["ab"], op["steps"], h=op["h"], block_cols=op["block"])
    assert torch.equal(keys, want_keys) and torch.equal(vals, want_vals)


# K4's edge cases (tests/test_torch_hash_layout.py holds their plain
# version to the JAX package on the CPU), as (A pattern, B pattern, h or
# None for the planner's size): probing that wraps from slot h-1 to 0 (rows
# 7, 15, 23 homed at slot 7 of 8), a lane whose 12 rows share home slot 5
# of 16, a small arrow (row 39 in 60 A columns that lane 0 names), a lane
# with 50 distinct rows (more than a round of 32, at a load of 50/64), an
# empty A column met first (key 0 with ±0, then row 0's real products); and
# a table of 32768 slots, past shared memory (tier "global")
HASH_BLOCK = 16


def _hash_case(name):
    rng = np.random.default_rng(11)
    c = 0x1E3779B1   # HASH_C's low 31 bits
    if name == "wrap":
        a = np.zeros((64, 2))
        a[[7, 15, 23], 0] = 1
        a[[8, 0], 1] = 1
        b = np.zeros((2, HASH_BLOCK))
        b[:, 0] = b[1, 1] = b[0, 2] = 1
        return a, b, 8
    if name == "one_home":
        rows = [r for r in range(200) if r * c % 16 == 5][:12]
        a = np.zeros((200, 3))
        for k in range(3):
            a[rows[4 * k:4 * k + 4], k] = 1
        b = np.zeros((3, HASH_BLOCK))
        b[:, 0] = 1
        b[[0, 2], 1] = b[1, 2] = 1
        return a, b, 16
    if name == "small_arrow":
        a = np.zeros((40, 60))
        a[39] = 1
        for k in range(60):
            a[rng.choice(39, 2, replace=False), k] = 1
        b = (rng.uniform(size=(60, HASH_BLOCK)) < 0.15).astype(float)
        b[:, 0] = 1
        return a, b, None
    if name == "many_rows":
        a = np.zeros((120, 10))
        for k in range(10):
            a[5 * k:5 * k + 5, k] = 1
        b = (rng.uniform(size=(10, HASH_BLOCK)) < 0.3).astype(float)
        b[:, 0] = 1
        return a, b, None
    if name == "empty_a_first":
        a = np.zeros((10, 4))
        a[[0, 3, 5], 1] = 1
        a[[0, 7], 2] = 1
        a[[2, 9], 3] = 1
        b = np.zeros((4, HASH_BLOCK))
        b[[0, 1, 2], 0] = 1
        b[0, 1] = 1
        b[[0, 3], 2] = 1
        return a, b, None
    if name == "tier_global":
        a = (rng.uniform(size=(300, 80)) < 0.08).astype(float)
        b = (rng.uniform(size=(80, 2 * HASH_BLOCK)) < 0.2).astype(float)
        return a, b, 32768
    raise AssertionError(name)


HASH_CASES = ("wrap", "one_home", "small_arrow", "many_rows",
              "empty_a_first", "tier_global")


def _hash_operands(dev, name, integer, batch=None):
    """Padded K4 operands of one case on ``dev``, with values in {1, 2, 3}
    or standard normal, ``batch`` value sets of the pattern when given."""
    from repro_torch.sparse.format import csc_from_dense

    a, b, h = _hash_case(name)
    a, b = csc_from_dense(a), csc_from_dense(b)
    ar, _, an = csc_to_padded_columns(a)
    br, _, bn = csc_to_padded_columns(b)
    rng = np.random.default_rng(len(name))
    lead = () if batch is None else (batch,)

    def vals(rows):
        v = (rng.integers(1, 4, lead + tuple(rows.shape)) if integer
             else rng.standard_normal(lead + tuple(rows.shape)))
        return torch.from_numpy(v.astype(np.float32))

    steps = steps_per_column(a, b).reshape(-1, HASH_BLOCK).max(axis=1)
    return dict(
        ab=tuple(x.to(dev) for x in (ar, vals(ar), an, br, vals(br), bn)),
        steps=torch.from_numpy(steps.astype(np.int32)).to(dev), m=a.n_rows,
        block=HASH_BLOCK,
        h=h if h is not None else hash_table_size(
            int(ops_per_column(a, b).max(initial=0))))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_kernel_edge_cases_equal_plain(cuda, case, integer):
    op = _hash_operands(cuda, case, integer)
    tier = "global" if op["h"] > 16384 else "shared"
    before = dict(kernels.hash_spgemm.n_launches_by_tier)
    keys, vals = kernels.hash_spgemm(*op["ab"], op["steps"], m=op["m"],
                                     h=op["h"], block_cols=op["block"])
    torch.cuda.synchronize()
    after = kernels.hash_spgemm.n_launches_by_tier
    assert after[tier] == before[tier] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want_keys, want_vals = kernels.hash_spgemm_plain(
        *op["ab"], op["steps"], h=op["h"], block_cols=op["block"])
    assert torch.equal(keys, want_keys) and torch.equal(vals, want_vals)


@pytest.mark.parametrize("h", [None, 32768])
@pytest.mark.parametrize("case", ["small_arrow", "many_rows"])
def test_hash_batched_kernel_in_each_tier(cuda, case, h):
    """K4-b at B = 3 in tier "shared" (the case's own table size) and
    "global" (32768 slots): equal to its plain version, and slice b to K4 on
    value set b, bit for bit."""
    op = _hash_operands(cuda, case, False, batch=3)
    if h is not None:
        op["h"] = h
    tier = "global" if op["h"] > 16384 else "shared"
    before = kernels.hash_spgemm_batched.n_launches_by_tier[tier]
    got = kernels.hash_spgemm_batched(*op["ab"], op["steps"], m=op["m"],
                                      h=op["h"], block_cols=op["block"])
    torch.cuda.synchronize()
    assert kernels.hash_spgemm_batched.n_launches_by_tier[tier] == before + 1
    want = kernels.hash_spgemm_batched_plain(
        *op["ab"], op["steps"], h=op["h"], block_cols=op["block"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ar, av, an, br, bv, bn = op["ab"]
    for b in range(3):
        one = kernels.hash_spgemm(ar, av[b].contiguous(), an, br,
                                  bv[b].contiguous(), bn, op["steps"],
                                  m=op["m"], h=op["h"],
                                  block_cols=op["block"])
        assert all(torch.equal(g[b], w) for g, w in zip(got, one))


@pytest.mark.parametrize("method", METHODS)
def test_spgemm_on_card_equals_cpu(cuda, method):
    a = generate.random_powerlaw_csc(300, 5.0, seed=4)
    got = spgemm(a, a, method)               # device=None: the card
    assert got.values.device.type == "cuda"
    want = spgemm(a, a, method, device="cpu")
    for f in ("col_ptr", "row_indices", "values"):
        assert np.array_equal(_np(getattr(got, f)), _np(getattr(want, f))), f


@pytest.mark.parametrize("method", ["spa", "h-spa-16/64", "h-hash-256/256"])
def test_execute_waits_for_the_card_once(cuda, method):
    """Every group is gathered, launched and compacted without a host sync;
    the one sync of an execution reads the result's nnz."""
    a = generate.random_powerlaw_csc(600, 8.0, seed=5).to(cuda)
    plan = cached_plan(a, a, method)
    assert len(plan.layout.groups) > 1
    plan.execute(a, a)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        plan.execute(a, a)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]


@pytest.mark.parametrize("method", (None,) + METHODS)
def test_zero_row_a_gives_the_empty_csc_on_card(cuda, method):
    """C of a 0 x n A is the empty 0 x n CSC, with no launch: K3 would step
    on the padding row of an empty A column."""
    from repro_torch.sparse.format import csc_from_dense

    b = np.zeros((6, 5), np.float32)
    b[[0, 2, 5], 0] = (1.0, 2.0, 3.0)
    b[:, 3] = np.arange(1.0, 7.0)
    a, b = csc_from_dense(np.zeros((0, 6), np.float32)), csc_from_dense(b)
    stacks = [BatchedCSC.from_values(m, torch.ones((2, m.nnz)))
              for m in (a, b)]
    kernels.reset_launch_counts()
    got = [spgemm(a, b, method)]
    got += spgemm_batched(*stacks, method)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values())
    assert kernels.spars_spgemm.n_launches == 0
    for c in got:
        assert c.shape == (0, 5) and c.values.device.type == "cuda"
        assert _np(c.col_ptr).tolist() == [0] * 6 and c.nnz == 0


@pytest.mark.parametrize("engine", [None, "fused"])
def test_a_batch_past_max_batch_on_card(cuda, engine):
    """65,537 value sets: two launches per group (65,535 and 2), elements 0,
    65,535 and 65,536 equal to single executes."""
    from repro_torch.kernels._checks import MAX_BATCH

    a = generate.random_powerlaw_csc(12, 3.0, seed=16)
    batch = MAX_BATCH + 2
    rng = np.random.default_rng(17)
    a_vals, b_vals = (torch.from_numpy(rng.integers(
        1, 4, (batch, a.nnz)).astype(np.float32)).to(cuda) for _ in range(2))
    plan = plan_spgemm(a, a, "h-spa-16/64")
    stats: dict = {}
    got = plan.execute_batched(a_vals, b_vals, engine=engine, stats=stats)
    one: dict = {}
    plan.execute(a_vals[0], b_vals[0], engine=engine, stats=one)
    assert len(got) == batch and stats["n_launches"] == 2 * one["n_launches"]
    for b in (0, MAX_BATCH, MAX_BATCH + 1):
        want = plan.execute(a_vals[b], b_vals[b], engine=engine)
        for f in ("col_ptr", "row_indices", "values"):
            assert torch.equal(getattr(got[b], f), getattr(want, f))


def test_wrapper_rejects_bad_cuda_operands(cuda):
    op = _operands(cuda)
    ab = list(op["ab"])
    ab[1] = ab[1].double()
    with pytest.raises(TypeError):
        kernels.spa_spgemm(*ab, m=op["m"], block_cols=op["block"])
    with pytest.raises(ValueError):
        kernels.spa_spgemm(*op["ab"], m=op["m"], block_cols=op["block"],
                           device="cpu")


def _fused_operands(dev, seed=6):
    a = generate.random_powerlaw_csc(300, 5.0, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.nnz).astype(np.float32)
    return a, x


def test_fused_kernel_equals_plain_on_every_view(cuda):
    a, x = _fused_operands(cuda)
    fs = fused_stream(plan_spgemm(a, a))
    v = torch.from_numpy(x).to(cuda)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        fs.forward.n_out).astype(np.float32)).to(cuda)
    for view, first in ((fs.forward, v), (fs.grad_a, g), (fs.grad_b, g)):
        before = kernels.fused_stream.n_launches
        got = kernels.fused_stream(view.idx_x, view.idx_y, view.seg_ptr,
                                   first, v)
        torch.cuda.synchronize()
        assert kernels.fused_stream.n_launches == before + 1
        want = kernels.fused_stream_plain(view.idx_x, view.idx_y,
                                          view.seg_ptr, first, v)
        assert torch.equal(got, want)


def test_fused_backward_on_card_equals_plain(cuda):
    """Forward and gradient of sum(w * C) through stream_apply on the card
    equal the same on the CPU (the plain versions), bit for bit."""
    a, x = _fused_operands(cuda)
    results = []
    for dev in (cuda, torch.device("cpu")):
        plan = plan_spgemm(a, a, device=dev)
        w = torch.from_numpy(np.random.default_rng(8).standard_normal(
            plan.stream.nnz).astype(np.float32)).to(dev)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        before = kernels.fused_stream.n_launches
        c = plan.stream_apply(xt, xt, engine="fused")
        grad, = torch.autograd.grad((w * c).sum(), xt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.fused_stream.n_launches == before + 3
        results.append((c.detach().cpu(), grad.cpu()))
    (c_card, g_card), (c_cpu, g_cpu) = results
    assert torch.equal(c_card, c_cpu) and torch.equal(g_card, g_cpu)


def test_fused_spgemm_on_card_equals_cpu(cuda):
    a, _ = _fused_operands(cuda)
    got = spgemm(a, a, engine="fused")
    assert got.values.device.type == "cuda"
    want = spgemm(a, a, engine="fused", device="cpu")
    for f in ("col_ptr", "row_indices", "values"):
        assert np.array_equal(_np(getattr(got, f)), _np(getattr(want, f))), f


def test_fused_execute_never_waits_for_the_card(cuda):
    """The fused result's nnz is fixed by the plan: an execute on operands
    already on the card makes no host sync.  A guarded plan gives the same
    values through its transient path."""
    a = generate.random_powerlaw_csc(600, 8.0, seed=5).to(cuda)
    plan = cached_plan(a, a)
    plan.execute(a, a, engine="fused")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        plan.execute(a, a, engine="fused")
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]
    stats: dict = {}
    guarded = plan_spgemm(a, a, stream_limit=1)
    got = guarded.execute(a, a, engine="fused", stats=stats)
    assert not stats["stream_cached"] and stats["n_launches"] == 1
    assert torch.equal(got.values, plan.execute(a, a, engine="fused").values)


BATCH = 3


def _batched_operands(dev, seed=9):
    """The padded operands of :func:`_operands` with B = 3 normal value sets
    of the same pattern for A and (other ones) for B."""
    op = _operands(dev)
    ar, av, an, br, bv, bn = op["ab"]
    rng = np.random.default_rng(seed)

    def stack(v):
        vals = rng.standard_normal((BATCH,) + tuple(v.shape))
        return torch.from_numpy(vals.astype(np.float32)).to(dev) * (v != 0)

    return dict(op, ab=(ar, stack(av).contiguous(), an, br,
                        stack(bv).contiguous(), bn))


def _run_batched(kind, op, plain=False):
    """(outputs,) of the batched kernel (or its plain version) of ``kind``
    on ``op``."""
    if kind == "spa":
        fn = (kernels.spa_spgemm_batched_plain if plain
              else kernels.spa_spgemm_batched)
        return (fn(*op["ab"], m=op["m"], **({} if plain else dict(
            block_cols=op["block"]))),)
    if kind == "spars":
        fn = (kernels.spars_spgemm_batched_plain if plain
              else kernels.spars_spgemm_batched)
        return fn(*op["ab"], op["steps"], m=op["m"], block_cols=op["block"])
    fn = (kernels.hash_spgemm_batched_plain if plain
          else kernels.hash_spgemm_batched)
    kw = {} if plain else dict(m=op["m"])
    return fn(*op["ab"], op["steps"], h=op["h"], block_cols=op["block"], **kw)


def _run_single(kind, op, b):
    """(outputs,) of the unbatched kernel of ``kind`` on value set b."""
    ar, av, an, br, bv, bn = op["ab"]
    ab = (ar, av[b].contiguous(), an, br, bv[b].contiguous(), bn)
    if kind == "spa":
        return (kernels.spa_spgemm(*ab, m=op["m"], block_cols=op["block"]),)
    if kind == "spars":
        return kernels.spars_spgemm(*ab, op["steps"], m=op["m"],
                                    block_cols=op["block"])
    return kernels.hash_spgemm(*ab, op["steps"], m=op["m"], h=op["h"],
                               block_cols=op["block"])


@pytest.mark.parametrize("kind", ["spa", "spars", "hash"])
def test_batched_kernel_equals_plain(cuda, kind):
    op = _batched_operands(cuda)
    wrapper = getattr(kernels, {"spa": "spa_spgemm_batched",
                                "spars": "spars_spgemm_batched",
                                "hash": "hash_spgemm_batched"}[kind])
    before = wrapper.n_launches
    got = _run_batched(kind, op)
    torch.cuda.synchronize()
    assert wrapper.n_launches == before + 1
    want = _run_batched(kind, op, plain=True)
    for g, w in zip(got, want):
        assert g.shape[0] == BATCH and torch.equal(g, w)


@pytest.mark.parametrize("kind", ["spa", "spars", "hash"])
def test_batched_kernel_slices_equal_unbatched(cuda, kind):
    """Slice b of one batched launch is the unbatched kernel on value set
    b, bit for bit; HASH's keys are equal across the batch."""
    op = _batched_operands(cuda)
    got = _run_batched(kind, op)
    for b in range(BATCH):
        for g, w in zip(got, _run_single(kind, op, b)):
            assert torch.equal(g[b], w)
    if kind == "hash":
        assert all(torch.equal(got[0][b], got[0][0]) for b in range(BATCH))


def test_fused_batched_kernel_equals_plain_and_slices(cuda):
    a, _ = _fused_operands(cuda)
    view = fused_stream(plan_spgemm(a, a)).forward
    rng = np.random.default_rng(10)
    x, y = (torch.from_numpy(rng.standard_normal((BATCH, a.nnz)).astype(
        np.float32)).to(cuda) for _ in range(2))
    before = kernels.fused_stream_batched.n_launches
    got = kernels.fused_stream_batched(view.idx_x, view.idx_y, view.seg_ptr,
                                       x, y)
    torch.cuda.synchronize()
    assert kernels.fused_stream_batched.n_launches == before + 1
    assert torch.equal(got, kernels.fused_stream_batched_plain(
        view.idx_x, view.idx_y, view.seg_ptr, x, y))
    for b in range(BATCH):
        assert torch.equal(got[b], kernels.fused_stream(
            view.idx_x, view.idx_y, view.seg_ptr, x[b], y[b]))


def _long_slot_view(dev, seed=11):
    """K1 operands around its long-slot threshold L: slots of L - 1, L,
    L + 1 and many more products, long slots first, last, side by side
    and beside empty ones."""
    from repro_torch.kernels.fused_stream import LONG_SLOT, long_slots_of

    rng = np.random.default_rng(seed)
    big = LONG_SLOT + 1
    lens = np.concatenate(([3000, 0, big, big, 0], rng.choice(
        [0, 1, LONG_SLOT - 1, LONG_SLOT, big, 700], 2000), [0, 4321]))
    seg_ptr = torch.from_numpy(np.concatenate(([0], np.cumsum(lens))).astype(
        np.int32))
    p, n_val = int(seg_ptr[-1]), 500
    idx = [torch.from_numpy(rng.integers(0, n_val, p).astype(np.int32)).to(
        dev) for _ in range(2)]
    return (*idx, seg_ptr.to(dev)), long_slots_of(seg_ptr).to(dev), n_val


@pytest.mark.parametrize("batch", [1, 3, 8, 9, 17])
def test_fused_kernel_tiers_equal_plain_and_loop(cuda, batch):
    """Both tiers of K1 bit for bit against the plain version, K1-b's tiles
    slice by slice against K1, and a launch without the list (the wrapper
    builds it) the same."""
    view, long_slots, n_val = _long_slot_view(cuda)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    x, y = (torch.randn((batch, n_val), generator=gen, device=cuda)
            for _ in range(2))
    got = kernels.fused_stream_batched(*view, x, y, long_slots=long_slots)
    want = kernels.fused_stream_batched_plain(*view, x, y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for b in range(batch):
        one = kernels.fused_stream(*view, x[b], y[b], long_slots=long_slots)
        assert torch.equal(one.view(torch.int32), got[b].view(torch.int32))
    assert torch.equal(kernels.fused_stream_batched(*view, x, y), got)


@pytest.mark.parametrize("engine", [None, "fused"])
def test_batched_execute_waits_once_or_never(cuda, engine):
    """A batched execute on operands already on the card waits for the card
    once (naive: all B nnz in one read) or never (fused), whatever B; its
    results equal a loop of executes and the same call on the CPU."""
    a = generate.random_powerlaw_csc(600, 8.0, seed=5)
    rng = np.random.default_rng(11)
    stacks = [BatchedCSC.from_values(a, torch.from_numpy(
        rng.integers(1, 4, (4, a.nnz)).astype(np.float32)))
        for _ in range(2)]
    a_dev, b_dev = (s.to(cuda) for s in stacks)
    plan = cached_plan(a, a)
    plan.execute_batched(a_dev, b_dev, engine=engine)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        got = plan.execute_batched(a_dev, b_dev, engine=engine)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == (0 if engine else 1), [str(w.message)
                                                for w in syncs]
    on_cpu = spgemm_batched(*stacks, device="cpu", engine=engine)
    for b, c in enumerate(got):
        want = plan.execute(a_dev[b], b_dev[b], engine=engine)
        for f in ("col_ptr", "row_indices", "values"):
            assert np.array_equal(_np(getattr(c, f)), _np(getattr(want, f)))
            assert np.array_equal(_np(getattr(c, f)),
                                  _np(getattr(on_cpu[b], f)))


def _bsr_operands(dev, bm=8, bk=8, seed=12):
    """A [24 bm, 40 bk] weight pruned to about a third of its blocks (some
    block-rows empty, so max_nb pads the rest) and x [B = 3, 40 bk, 256]."""
    from repro_torch.models import prune_blocks

    rng = np.random.default_rng(seed)
    w = rng.normal(size=(24 * bm, 40 * bk)).astype(np.float32)
    w[2 * bm: 4 * bm] *= 1e-3
    w, _ = prune_blocks(w, bm, bk, 0.3)
    ops = tuple(torch.from_numpy(a).to(dev)
                for a in kernels.bsr_from_dense(w, bm, bk))
    xs = torch.from_numpy(rng.normal(size=(3, 40 * bk, 256)).astype(
        np.float32)).to(dev)
    return w, ops, xs


@pytest.mark.parametrize("bm,bk", [(8, 8), (8, 16), (16, 16)])
def test_bsr_kernel_equals_plain(cuda, bm, bk):
    w, ops, xs = _bsr_operands(cuda, bm, bk)
    assert not ops[1][2:4].any() and (ops[1] < ops[0].shape[1]).any()
    before = kernels.bsr_spmm.n_launches
    got = kernels.bsr_spmm(*ops, xs[0])
    torch.cuda.synchronize()
    assert kernels.bsr_spmm.n_launches == before + 1
    assert got.shape == (w.shape[0], 256)
    assert torch.equal(got, kernels.bsr_spmm_plain(*ops, xs[0]))
    want = torch.from_numpy(w).double() @ xs[0].cpu().double()
    assert float((got.cpu().double() - want).norm() / want.norm()) <= 1e-5


@pytest.mark.parametrize("bm,bk", [(8, 8), (16, 16)])
def test_bsr_batched_kernel_equals_plain_and_slices(cuda, bm, bk):
    _, ops, xs = _bsr_operands(cuda, bm, bk, seed=13)
    before = kernels.bsr_spmm_batched.n_launches
    got = kernels.bsr_spmm_batched(*ops, xs)
    torch.cuda.synchronize()
    assert kernels.bsr_spmm_batched.n_launches == before + 1
    assert torch.equal(got, kernels.bsr_spmm_batched_plain(*ops, xs))
    for b in range(xs.shape[0]):
        assert torch.equal(got[b], kernels.bsr_spmm(*ops, xs[b]))


def test_bsr_wrapper_rejects_bad_cuda_operands(cuda):
    _, (bi, bnnz, blocks), xs = _bsr_operands(cuda)
    x = xs[0]
    for args, kw in (((bi, bnnz, blocks, x.double()), {}),
                     ((bi.long(), bnnz, blocks, x), {}),
                     ((bi, bnnz, blocks, x.cpu()), {}),
                     ((bi, bnnz, blocks, x[:, ::2]), {}),
                     ((bi, bnnz, blocks, x), {"bn": 96}),
                     ((bi, bnnz, blocks, x.cpu()), {"device": "cuda"})):
        with pytest.raises((TypeError, ValueError)):
            kernels.bsr_spmm(*args, **kw)
    with pytest.raises(ValueError):
        kernels.bsr_spmm(bi.cpu(), bnnz.cpu(), blocks.cpu(), x.cpu(),
                         device="cuda")


@pytest.mark.parametrize("keep", [0.9, 0.25])
def test_sparse_ffn_on_card_equals_cpu(cuda, keep):
    """smoke(granite-20b) widths: the FFN on the card (K5 / K5-b, or the
    dense matmul) equals the same FFN on the CPU within 1e-5 (the dense
    path's matmul sums in another order on the card)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import SparseFFN, ffn_table, init_params, smoke

    cfg = smoke(ARCHS["granite-20b"])
    p = init_params(ffn_table(cfg), torch.Generator().manual_seed(14),
                    device="cpu")
    x = torch.randn((3, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(15))
    on_cpu = SparseFFN.from_params(p, keep_density=keep, device="cpu")
    on_card = SparseFFN.from_params(p, keep_density=keep, device=cuda)
    path = on_card.gate.path
    assert path == ("dense" if keep > 0.75 else "bsr")
    kernels.reset_launch_counts()
    got3 = on_card(x.to(cuda))
    got2 = on_card(x[0].to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["bsr_spmm_batched"] == counts["bsr_spmm"] == (
        3 if path == "bsr" else 0)
    for got, want in ((got3, on_cpu(x)), (got2, on_cpu(x[0]))):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# K5's walk (a CTA a group of 16 8-row units x a column tile, K in
# ascending chunks of whole block-columns), as (n_rb, n_cb, bm, bk, N): the
# 8x8 instance (N a multiple of 4) and the generic one (any other shape)
BSR_WALK_CASES = {
    # 3 groups, the last 5 units; 70 block-columns, 5 chunks, the last cut
    # short; a 128-column tile and one of 8
    "8x8_groups_chunks_tiles": (37, 70, 8, 8, 136),
    # 8 columns a lane: 256-column tiles; and 257 groups of 128 columns,
    # a tile an element (K5-b: 771 CTAs)
    "8x8_wide_tiles": (21, 70, 8, 8, 512),
    "8x8_many_groups": (4100, 24, 8, 8, 128),
    "8x8_n200": (20, 33, 8, 8, 200),
    "8x8_n_not_a_multiple_of_4": (20, 33, 8, 8, 130),
    "8x16": (19, 40, 8, 16, 72),
    "16x16": (11, 40, 16, 16, 40),
    "16x8_two_slabs": (9, 50, 16, 8, 64),
    "3x5_odd": (30, 120, 3, 5, 33),
    "12x20_cut_slab_and_piece": (13, 30, 12, 20, 48),
    "8x256_widest": (18, 5, 8, 256, 32),
}


def _bsr_walk_operands(dev, case, integer, batch=3, keep=0.3, seed=21):
    """BSR operands of BSR_WALK_CASES[case] (about ``keep`` of the blocks
    kept, some block-rows empty) and xs [batch, K, N], integer-valued in
    {-2 ... 2} or normal."""
    n_rb, n_cb, bm, bk, n = BSR_WALK_CASES[case]
    rng = np.random.default_rng([seed, len(case)])
    kept = rng.uniform(size=(n_rb, n_cb)) < keep
    kept[rng.uniform(size=n_rb) < 0.15] = False
    if integer:
        w = rng.integers(-2, 3, (n_rb, bm, n_cb, bk)).astype(np.float32)
        xs = rng.integers(-2, 3, (batch, n_cb * bk, n)).astype(np.float32)
    else:
        w = rng.standard_normal((n_rb, bm, n_cb, bk)).astype(np.float32)
        xs = rng.standard_normal((batch, n_cb * bk, n)).astype(np.float32)
    w = (w * kept[:, None, :, None]).reshape(n_rb * bm, n_cb * bk)
    return w, _bsr_lift(w, bm, bk, dev), torch.from_numpy(xs).to(dev)


def _bsr_lift(w, bm, bk, dev):
    return tuple(torch.from_numpy(a).to(dev)
                 for a in kernels.bsr_from_dense(w, bm, bk))


def _check_bsr_both(ops, xs):
    """K5 on each slice and K5-b on xs, each against its plain version bit
    for bit and counted once a launch; K5-b's slices equal K5's."""
    b_before = kernels.bsr_spmm_batched.n_launches
    got_b = kernels.bsr_spmm_batched(*ops, xs, bn=xs.shape[2])
    torch.cuda.synchronize()
    assert kernels.bsr_spmm_batched.n_launches == b_before + 1
    assert torch.equal(got_b, kernels.bsr_spmm_batched_plain(*ops, xs))
    for b in range(xs.shape[0]):
        before = kernels.bsr_spmm.n_launches
        got = kernels.bsr_spmm(*ops, xs[b], bn=xs.shape[2])
        torch.cuda.synchronize()
        assert kernels.bsr_spmm.n_launches == before + 1
        assert torch.equal(got, kernels.bsr_spmm_plain(*ops, xs[b]))
        assert torch.equal(got_b[b], got)
    return got_b


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", sorted(BSR_WALK_CASES))
def test_bsr_kernel_walk_cases_equal_plain(cuda, case, integer):
    w, ops, xs = _bsr_walk_operands(cuda, case, integer)
    got = _check_bsr_both(ops, xs)
    if integer:   # every sum exact in f32: the f64 product
        want = torch.from_numpy(w).double().to(cuda) @ xs.double()
        assert torch.equal(got.double(), want)


@pytest.mark.parametrize("integer", [True, False])
def test_bsr_kernel_one_block_row_far_longer_than_its_group(cuda, integer):
    """Block-row 5 keeps every block of 60 block-columns, its group's other
    15 one block each (max_nb pads them to 60): their warps wait at every
    chunk for block-row 5's."""
    n_rb, n_cb = 32, 60
    rng = np.random.default_rng(22)
    w = (rng.integers(-2, 3, (n_rb * 8, n_cb * 8)) if integer
         else rng.standard_normal((n_rb * 8, n_cb * 8))).astype(np.float32)
    keep = np.zeros((n_rb, n_cb), bool)
    keep[np.arange(n_rb), rng.integers(0, n_cb, n_rb)] = True
    keep[5] = True
    w *= np.repeat(np.repeat(keep, 8, 0), 8, 1)
    ops = _bsr_lift(w, 8, 8, cuda)
    assert int(ops[1].max()) == n_cb == ops[0].shape[1]
    xs = torch.from_numpy((rng.integers(-2, 3, (2, n_cb * 8, 256)) if integer
                           else rng.standard_normal((2, n_cb * 8, 256)))
                          .astype(np.float32)).to(cuda)
    _check_bsr_both(ops, xs)


@pytest.mark.parametrize("bm,bk", [(8, 8), (16, 16)])
def test_bsr_kernel_all_empty_groups_write_zeros(cuda, bm, bk):
    """The first two groups' block-rows keep nothing (their CTAs stage no
    chunk), a later one keeps one block; an all-zero weight gives zeros."""
    rng = np.random.default_rng(23)
    w = np.zeros((40 * bm, 20 * bk), np.float32)
    w[35 * bm: 36 * bm, 7 * bk: 8 * bk] = rng.standard_normal((bm, bk))
    xs = torch.from_numpy(rng.standard_normal((2, 20 * bk, 64)).astype(
        np.float32)).to(cuda)
    got = _check_bsr_both(_bsr_lift(w, bm, bk, cuda), xs)
    assert not got[:, : 35 * bm].any() and got[:, 35 * bm: 36 * bm].any()
    zero = _check_bsr_both(_bsr_lift(np.zeros_like(w), bm, bk, cuda), xs)
    assert not zero.any()


def test_bsr_kernel_on_an_unaligned_x(cuda):
    """x starting 4 bytes past a 16-byte boundary (a contiguous view) takes
    the generic instance at 8x8 blocks, still equal to the plain version."""
    _, ops, xs = _bsr_walk_operands(cuda, "8x8_groups_chunks_tiles", False)
    flat = torch.empty(xs.numel() + 1, device=cuda)
    shifted = flat[1:].view(xs.shape)
    shifted.copy_(xs)
    assert shifted.data_ptr() % 16 == 4
    assert kernels.bsr_layout(37, 8, 8, 136, aligned=False)["instance"] \
        == "generic"
    _check_bsr_both(ops, shifted)


def test_bsr_layout_model_equals_the_kernels_choice(cuda):
    """``kernels.bsr_layout``, the launch shape that ``csrc/bsr_spmm.cu``
    chooses, equals the CPU tests' model of it (``torch_bsr_walk``), which
    gives the walk model its tiles and chunks: every instance, alignment,
    the batch, and group and tile borders."""
    from torch_bsr_walk import model_layout

    blocks = ((8, 8), (8, 16), (16, 16), (16, 8), (3, 5), (8, 256))
    for n_rb, (bm, bk), n, batch, aligned in itertools.product(
            (1, 37, 768, 3072, 4100), blocks,
            (32, 128, 130, 132, 200, 256, 2048), (1, 3, 8), (True, False)):
        args = (n_rb, bm, bk, n, batch, aligned)
        assert kernels.bsr_layout(*args) == model_layout(*args), args


def test_bsr_layout_model_equals_the_kernels_choice_on_bf16_x(cuda):
    """The same on bf16 x, whose 8x8 instances need N a multiple of 8 and
    whose stages hold twice the rows."""
    from torch_bsr_walk import model_layout

    blocks = ((8, 8), (16, 16), (3, 5), (8, 256))
    for n_rb, (bm, bk), n, batch, aligned in itertools.product(
            (1, 37, 3072), blocks, (32, 128, 130, 132, 136, 200, 2048),
            (1, 8), (True, False)):
        args = (n_rb, bm, bk, n, batch, aligned, torch.bfloat16)
        assert kernels.bsr_layout(*args) == model_layout(*args), args


# K5 and K5-b on bf16 x, with f32 or bf16 blocks: N = 132 is aligned for f32
# but not for bf16 (the generic instance, SIMT, bit for bit), N = 136 and
# 256 take the tensor-core body (128-column tiles, the second 8 wide, and
# one 256-column tile), held to its bound; the full width of a bsr-path FFN
# is chip_smoke.py's
BF16_PAIRS = [(torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16)]


def _bf16_bsr_operands(dev, n, w_dtype, integer, batch=8, seed=24):
    n_rb, n_cb = 37, 70
    rng = np.random.default_rng([seed, n, integer])
    kept = rng.uniform(size=(n_rb, n_cb)) < 0.3
    kept[[3, 4, 36]] = False
    draw = ((lambda s: rng.integers(-2, 3, s)) if integer
            else rng.standard_normal)
    w = (draw((n_rb, 8, n_cb, 8)).astype(np.float32)
         * kept[:, None, :, None]).reshape(n_rb * 8, n_cb * 8)
    bi, bnnz, blocks = _bsr_lift(w, 8, 8, dev)
    xs = torch.from_numpy(draw((batch, n_cb * 8, n)).astype(np.float32))
    return w, (bi, bnnz, blocks.to(w_dtype)), xs.to(dev).bfloat16()


def _check_bsr_mma(ops, xs):
    """The tensor-core body: K5-b on xs and K5 on each slice within the
    bound of their plain versions (``kernels.bsr_mma_check``), K5-b's
    slices bit for bit K5's, a second launch bit for bit the first, each
    launch counted (and as bf16).  Returns (K5-b's output, the largest
    |kernel - plain| / S)."""
    assert kernels.bsr_layout(ops[0].shape[0], 8, 8, xs.shape[2],
                              xs.shape[0], True, xs.dtype)["instance"] \
        == "mma"
    before = (kernels.bsr_spmm_batched.n_launches,
              kernels.bsr_spmm_batched.n_launches_bf16)
    got_b = kernels.bsr_spmm_batched(*ops, xs, bn=xs.shape[2])
    torch.cuda.synchronize()
    assert (kernels.bsr_spmm_batched.n_launches,
            kernels.bsr_spmm_batched.n_launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert got_b.dtype == torch.bfloat16
    rep = kernels.bsr_mma_check(
        *ops, xs, got_b, kernels.bsr_spmm_batched_plain(*ops, xs))
    assert rep["ok"], rep
    assert torch.equal(kernels.bsr_spmm_batched(*ops, xs, bn=xs.shape[2]),
                       got_b)
    ratio = rep["max_err_over_sum"]
    for b in range(xs.shape[0]):
        got = kernels.bsr_spmm(*ops, xs[b], bn=xs.shape[2])
        torch.cuda.synchronize()
        assert torch.equal(got, got_b[b])
        rep = kernels.bsr_mma_check(
            *ops, xs[b][None], got[None],
            kernels.bsr_spmm_plain(*ops, xs[b])[None])
        assert rep["ok"], rep
        ratio = max(ratio, rep["max_err_over_sum"])
    return got_b, ratio


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("n", [132, 136, 256])
@pytest.mark.parametrize("w_dtype,x_dtype", BF16_PAIRS,
                         ids=["f32_blocks", "bf16_blocks"])
def test_bsr_kernel_on_bf16_equals_plain(cuda, w_dtype, x_dtype, n, integer,
                                         batch):
    """Each bf16 launch against its plain version: the generic instance
    (N = 132) bit for bit, the tensor-core body (N = 136, 256) within its
    bound; K5-b's slices equal K5 bit for bit, and integer values give the
    f64 product rounded once to bf16 on both bodies."""
    w, ops, xs = _bf16_bsr_operands(cuda, n, w_dtype, integer, batch)
    assert kernels.bsr_layout(37, 8, 8, n, batch, True, x_dtype)[
        "instance"] == ("generic" if n == 132 else "mma")
    if n == 132:
        before = (kernels.bsr_spmm_batched.n_launches,
                  kernels.bsr_spmm_batched.n_launches_bf16)
        got = _check_bsr_both(ops, xs)
        assert (kernels.bsr_spmm_batched.n_launches,
                kernels.bsr_spmm_batched.n_launches_bf16) == (
            before[0] + 1, before[1] + 1)
    else:
        got, _ = _check_bsr_mma(ops, xs)
    assert got.dtype == torch.bfloat16
    if integer:
        want = torch.from_numpy(w).double().to(cuda) @ xs.double()
        assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("w_dtype,x_dtype", BF16_PAIRS,
                         ids=["f32_blocks", "bf16_blocks"])
def test_bsr_kernel_on_bf16_launches_without_widening(cuda, w_dtype,
                                                      x_dtype):
    """A bf16 call on the card launches the kernel (both counts rise) and
    allocates its bf16 output and nothing else: no f32 copy of x or of the
    output around an f32 launch."""
    _, ops, xs = _bf16_bsr_operands(cuda, 256, w_dtype, False, batch=4)
    out_bytes = ops[0].shape[0] * 8 * xs.shape[2] * 2
    for fn, x, n_out in ((kernels.bsr_spmm, xs[0], out_bytes),
                         (kernels.bsr_spmm_batched, xs, 4 * out_bytes)):
        torch.cuda.synchronize()
        before = (fn.n_launches, fn.n_launches_bf16)
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        got = fn(*ops, x)
        torch.cuda.synchronize()
        assert (fn.n_launches, fn.n_launches_bf16) == (before[0] + 1,
                                                       before[1] + 1)
        assert got.dtype == torch.bfloat16
        assert torch.cuda.max_memory_allocated(cuda) - base \
            <= -(-n_out // 512) * 512
        xb = x if x.dim() == 3 else x[None]
        want = kernels.bsr_spmm_batched_plain(*ops, xb)
        assert kernels.bsr_mma_check(*ops, xb, got.reshape(want.shape),
                                     want)["ok"]


def _chunk_pattern_operands(dev, w_dtype, seed=25):
    """Block-row 0 keeps block-columns 0, 2, 15 of chunk 0 (16 block-columns
    a chunk at 256 columns of bf16): a k16 pair then a k8, 15 and 16
    consecutive across the border, then 16, 17, 18, 20 of chunk 1 (two
    pairs); block-row 1 keeps one block; block-row 2 every block of 3
    chunks; the rest random.  Integer values."""
    n_rb, n_cb = 20, 48
    rng = np.random.default_rng(seed)
    kept = rng.uniform(size=(n_rb, n_cb)) < 0.3
    kept[:3] = False
    kept[0, [0, 2, 15, 16, 17, 18, 20]] = True
    kept[1, 9] = True
    kept[2] = True
    w = (rng.integers(-2, 3, (n_rb, 8, n_cb, 8)).astype(np.float32)
         * kept[:, None, :, None]).reshape(n_rb * 8, n_cb * 8)
    bi, bnnz, blocks = _bsr_lift(w, 8, 8, dev)
    return w, (bi, bnnz, blocks.to(w_dtype))


@pytest.mark.parametrize("n", [136, 256])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_blocks", "bf16_blocks"])
def test_bsr_mma_odd_blocks_and_chunk_borders(cuda, w_dtype, n):
    """An odd number of a block-row's blocks in a chunk (the last as k8),
    consecutive blocks across a chunk's border (never a pair), a block-row
    of one block and one of every block: integer values exact, real ones
    (the same pattern) within the bound; the walk model's steps pair as
    the kernel's layout says."""
    from torch_bsr_walk import walk_model

    w, ops = _chunk_pattern_operands(cuda, w_dtype)
    rng = np.random.default_rng(26)
    xs = torch.from_numpy(rng.integers(-2, 3, (3, w.shape[1], n)).astype(
        np.float32)).to(cuda).bfloat16()
    got, _ = _check_bsr_mma(ops, xs)
    want = torch.from_numpy(w).double().to(cuda) @ xs.double()
    assert torch.equal(got, want.bfloat16())
    steps = []
    cpu = tuple(t.cpu() for t in ops)
    assert torch.equal(walk_model(*cpu, xs.cpu(), steps=steps), got.cpu())
    chunk = kernels.bsr_layout(20, 8, 8, n, 3, True, torch.bfloat16)["chunk"]
    assert chunk == (16 if n == 256 else 32)
    if n == 256:
        assert [s for s in steps if s[0] == 0] == [
            (0, 0, (0, 1)), (0, 0, (2,)), (0, 1, (3, 4)), (0, 1, (5, 6))]
    real = ops[:2] + (torch.randn(ops[2].shape, device=cuda, generator=(
        torch.Generator(device=cuda).manual_seed(27))).to(w_dtype),)
    _check_bsr_mma(real, torch.randn(xs.shape, device=cuda).bfloat16())


def test_bsr_mma_on_an_infinite_x(cuda):
    """An infinite x: under bf16 blocks, and under f32 blocks whose weights
    are bf16-exact (their mid and lo passes skipped), the kernel gives the
    plain version's infinities and NaNs (0 x inf) exactly; where an f32
    weight that is bf16-exact meets the infinity in a step whose other
    weights are not, the zero mid part gives NaN where the plain version
    gives the infinity (ROADMAP C22), and the finite elements keep the
    bound."""
    def same(a, b):
        return bool(((a == b) | (a.isnan() & b.isnan())).all())

    w, ops, xs = _bf16_bsr_operands(cuda, 256, torch.float32, True, batch=2)
    row = 8 * int(ops[0][0, 0]) + 2
    xs[0, row, 3] = float("inf")
    xs[1, row, 5] = -float("inf")
    for blocks in (ops[2], ops[2].bfloat16()):
        o = ops[:2] + (blocks,)
        got = kernels.bsr_spmm_batched(*o, xs)
        want = kernels.bsr_spmm_batched_plain(*o, xs)
        assert torch.isinf(want).any() and torch.isnan(want).any()
        assert same(got, want)
        assert kernels.bsr_mma_check(*o, xs, got, want)["ok"]
    mixed = ops[2] * (1 + 2.0 ** -12)
    mixed[..., 2] = ops[2][..., 2]
    o = ops[:2] + (mixed,)
    got = kernels.bsr_spmm_batched(*o, xs)
    want = kernels.bsr_spmm_batched_plain(*o, xs)
    inf = torch.isinf(want)
    assert inf.any() and torch.isnan(got[inf]).all()
    fin = torch.isfinite(want)
    assert same(got[~inf & ~fin], want[~inf & ~fin])
    assert torch.equal(got[fin], want[fin])   # integers: exact


def test_bsr_mma_sums_stay_within_the_bound_at_full_depth(cuda):
    """gate's shape at a 256-column slice: K = 6144, 192 kept blocks a
    block-row on average (n about 1,536 products an element, 4,608 parts
    in f32 blocks); both pairs within the bound, and |kernel - plain|
    within 2^-6 of S: one bf16 ulp of the output (2^-7 of it at most,
    |plain| <= S) and the bound (about 8e-4 S at this n)."""
    rng = np.random.default_rng(28)
    n_rb, n_cb = 64, 768
    kept = rng.uniform(size=(n_rb, n_cb)) < 0.25
    w = (rng.standard_normal((n_rb, 8, n_cb, 8)).astype(np.float32)
         * kept[:, None, :, None]).reshape(n_rb * 8, n_cb * 8)
    ops32 = _bsr_lift(w, 8, 8, cuda)
    xs = torch.randn((2, n_cb * 8, 256), device=cuda).bfloat16()
    for blocks in (ops32[2], ops32[2].bfloat16()):
        _, ratio = _check_bsr_mma(ops32[:2] + (blocks,), xs)
        assert ratio < 2.0 ** -6


@pytest.mark.parametrize("keep", [0.9, 0.25])
def test_sparse_ffn_on_bf16_card_equals_cpu(cuda, keep):
    """smoke(granite-20b) widths on bf16 activations: the FFN's dtype is
    the reference's (bf16 on the bsr path, f32 on the dense path), its
    launches bf16 K5 / K5-b on the bsr path and none on the dense path,
    and its values within 1e-2 normwise of the same FFN on the CPU (SiLU
    and the matmuls round to bf16 in other places on the two devices)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import SparseFFN, ffn_table, init_params, smoke

    cfg = smoke(ARCHS["granite-20b"])
    p = init_params(ffn_table(cfg), torch.Generator().manual_seed(14),
                    device="cpu")
    x = torch.randn((3, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(15)).bfloat16()
    on_cpu = SparseFFN.from_params(p, keep_density=keep, device="cpu")
    on_card = SparseFFN.from_params(p, keep_density=keep, device=cuda)
    bsr = on_card.gate.path == "bsr"
    kernels.reset_launch_counts()
    got3 = on_card(x.to(cuda))
    got2 = on_card(x[0].to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("bsr_spmm", "bsr_spmm_batched"):
        assert counts[name] == counts[f"{name}_bf16"] == (3 if bsr else 0)
    for got, want in ((got3, on_cpu(x)), (got2, on_cpu(x[0]))):
        assert got.dtype == want.dtype == (torch.bfloat16 if bsr
                                           else torch.float32)
        err = (got.cpu().double() - want.double()).norm() / want.double(
            ).norm()
        assert float(err) <= 1e-2


# --- the torch stream (backend="torch") and the batched gradient ------------


def _int_operands(seed=12):
    a = generate.random_powerlaw_csc(400, 6.0, seed=seed)
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 4, a.nnz) * rng.choice([-1, 1], a.nnz)
    return a, torch.from_numpy(vals.astype(np.float32))


def test_torch_stream_on_card_equals_cpu_and_fused_on_integers(cuda):
    """Integer values: every order gives the same sums, so the torch stream
    on the card equals its CPU run and the fused engine bit for bit."""
    a, v = _int_operands()
    plan = plan_spgemm(a, a, backend="torch")
    got = plan.execute(v.to(cuda), v.to(cuda))
    assert got.values.device.type == "cuda"
    cpu = plan_spgemm(a, a, backend="torch", device="cpu").execute(v, v)
    for f in ("col_ptr", "row_indices", "values"):
        assert np.array_equal(_np(getattr(got, f)), _np(getattr(cpu, f))), f
    fused = plan.execute(v.to(cuda), v.to(cuda), engine="fused")
    assert torch.equal(got.values, fused.values)


def test_torch_stream_is_bit_stable_and_batched_equals_looped(cuda):
    """Real values: two runs agree bit for bit, and a [B, nnz] stack (one
    flat segmented sum) equals a loop of unbatched executes bit for bit at
    B = 1, 3, 8 and at a stream length that is not a multiple of ALIGN."""
    from repro_torch.core.device_stream import ALIGN

    a = generate.random_powerlaw_csc(500, 9.0, seed=13)
    plan = plan_spgemm(a, a, backend="torch")
    assert plan.stream.n_products % ALIGN
    gen = torch.Generator(device=cuda).manual_seed(0)
    for batch in (1, 3, 8):
        xs = torch.randn((batch, a.nnz), generator=gen, device=cuda)
        ys = torch.randn((batch, a.nnz), generator=gen, device=cuda)
        outs = plan.execute_batched(xs, ys)
        for k in range(batch):
            one = plan.execute(xs[k], ys[k]).values
            assert torch.equal(outs[k].values.view(torch.int32),
                               one.view(torch.int32))
            assert torch.equal(one.view(torch.int32), plan.execute(
                xs[k], ys[k]).values.view(torch.int32))


def test_torch_stream_execute_never_waits_for_the_card(cuda):
    a = generate.random_powerlaw_csc(600, 8.0, seed=5).to(cuda)
    plan = plan_spgemm(a, a, backend="torch")
    stack = torch.stack([a.values] * 3)
    plan.execute(a, a)
    plan.execute_batched(stack, stack)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        plan.execute(a, a)
        plan.execute_batched(stack, stack)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]


@pytest.mark.parametrize("engine", [None, "fused"])
def test_stacked_backward_on_card_equals_looped(cuda, engine):
    """stream_apply on [B, nnz] stacks on the card: forward and both
    gradients equal a loop of unbatched calls bit for bit (the fused
    engine: K1-b on the forward view and on both gradient views, three
    launches), and equal the CPU on integer values."""
    a, v = _int_operands(seed=14)
    plan = plan_spgemm(a, a)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for batch in (1, 3, 9):
        xs = torch.randn((batch, a.nnz), generator=gen, device=cuda)
        ys = torch.randn((batch, a.nnz), generator=gen, device=cuda)
        w = torch.randn((batch, plan.stream.nnz), generator=gen,
                        device=cuda)
        x, y = xs.clone().requires_grad_(), ys.clone().requires_grad_()
        before = kernels.fused_stream_batched.n_launches
        c = plan.stream_apply(x, y, engine=engine)
        gx, gy = torch.autograd.grad((w * c).sum(), (x, y))
        torch.cuda.synchronize()
        if engine == "fused":
            assert kernels.fused_stream_batched.n_launches == before + 3
        for k in range(batch):
            xk = xs[k].clone().requires_grad_()
            yk = ys[k].clone().requires_grad_()
            ck = plan.stream_apply(xk, yk, engine=engine)
            gxk, gyk = torch.autograd.grad((w[k] * ck).sum(), (xk, yk))
            for got, want in ((c[k], ck), (gx[k], gxk), (gy[k], gyk)):
                assert torch.equal(got.detach().view(torch.int32),
                                   want.detach().view(torch.int32))
    vs = torch.stack([v, v.flip(0)])
    wv = torch.ones((2, plan.stream.nnz))
    results = []
    for dev in (cuda, torch.device("cpu")):
        p = plan_spgemm(a, a, device=dev)
        x = vs.to(dev).requires_grad_()
        c = p.stream_apply(x, x, engine=engine)
        g, = torch.autograd.grad((wv.to(dev) * c).sum(), x)
        results.append((c.detach().cpu(), g.cpu()))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])


# --- the tiled path (method="auto") ------------------------------------------


def _bits(c):
    cp = _np(c.col_ptr).astype(np.int64)
    nnz = int(cp[-1])
    vals = np.ascontiguousarray(_np(c.values)[:nnz].astype(np.float32))
    return cp, _np(c.row_indices)[:nnz].astype(np.int64), vals.view(np.int32)


def _same_bits(x, y):
    return all(np.array_equal(u, v) for u, v in zip(_bits(x), _bits(y)))


def _count_syncs(fn):
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_tiled_card_merge_equals_host_merge(cuda, backend):
    """A grid of several row blocks on the card: the card's merge equals the
    host's numpy merge of the same children bit for bit on real values,
    is bit-stable, and equals the same grid on the CPU."""
    from repro_torch.core import plan_spgemm_tiled
    from repro_torch.core.executor import _merge_and_stitch

    a = generate.random_powerlaw_csc(300, 6.0, seed=21)
    gen = torch.Generator(device=cuda).manual_seed(2)
    v = torch.randn(a.nnz, generator=gen, device=cuda)
    plan = plan_spgemm_tiled(a, a, backend=backend, tile=(70, 90),
                             cache=False)
    assert plan.grid[0] > 1 and plan.device.type == "cuda"
    got = plan.execute(v, v)
    assert got.values.device.type == "cuda"
    per_block = {ni: [] for ni in range(plan.grid[1])}
    for t in plan.tiles:
        lo, hi = t.a_vals
        per_block[t.n].append(t.plan.execute(v[lo:hi], v[t.b_index])
                              .to("cpu"))
    assert _same_bits(got, _merge_and_stitch(plan, per_block, np.float32))
    assert _same_bits(got, plan.execute(v, v))
    cpu = plan_spgemm_tiled(a, a, backend=backend, tile=(70, 90),
                            cache=False, device="cpu")
    assert cpu.methods == plan.methods
    if backend == "cuda":
        # the kernels equal their plain versions bit for bit
        assert _same_bits(got, cpu.execute(v.cpu(), v.cpu()))


def test_tiled_card_batched_equals_looped_and_syncs(cuda):
    from repro_torch.core import plan_spgemm_tiled

    a = generate.random_powerlaw_csc(300, 6.0, seed=22)
    plan = plan_spgemm_tiled(a, a, tile=(100, 100), cache=False)
    gen = torch.Generator(device=cuda).manual_seed(3)
    vs = torch.randn((8, a.nnz), generator=gen, device=cuda)
    stats = {}
    batched = plan.execute_batched(vs, vs, stats=stats)
    for b, c in enumerate(batched):
        assert _same_bits(c, plan.execute(vs[b], vs[b]))
    one = {}
    plan.execute(vs[0], vs[0], stats=one)
    assert one["host_syncs"] == len(plan.tiles) + 1
    assert _count_syncs(lambda: plan.execute(vs[0], vs[0])) == \
        one["host_syncs"]
    torch_grid = plan_spgemm_tiled(a, a, backend="torch", tile=(100, 100),
                                   candidates=("fused",), cache=False)
    torch_grid.execute(vs[0], vs[0])    # the children's K1 views built
    before = kernels.fused_stream.n_launches
    assert _count_syncs(lambda: torch_grid.execute(vs[0], vs[0])) == 1
    assert kernels.fused_stream.n_launches == before + len(torch_grid.tiles)


def test_tiled_auto_on_card_exact_and_host_grid_device_tiles(cuda):
    from repro_torch.core import spgemm

    from repro_torch.sparse.format import CSC

    a, v = _int_operands(seed=23)
    a = CSC(v, a.row_indices, a.col_ptr, a.shape)
    d = csc_to_dense_f64(a)
    for kw in (dict(), dict(tile=(64, 64)),
               dict(backend="torch", tile=(64, 64)),
               dict(backend="host", candidates=("fused",), tile=(64, 64))):
        c = spgemm(a, a, method="auto", cache=False, **kw)
        want_dev = "cpu" if kw.get("backend") == "host" else "cuda"
        assert c.values.device.type == want_dev
        np.testing.assert_array_equal(csc_to_dense_f64(c), d @ d)


def csc_to_dense_f64(c):
    from repro_torch.sparse.format import csc_to_dense

    return csc_to_dense(c).cpu().double().numpy()


@pytest.fixture
def own_profile_dir(tmp_path, monkeypatch):
    """A profile directory of the test's own, the stock guard and no
    installed profile before and after."""
    from repro_torch.core import fast, profile

    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    guard = fast.STREAM_MAX_PRODUCTS
    profile.reset()
    yield str(tmp_path)
    profile.reset()
    fast.STREAM_MAX_PRODUCTS = guard


def test_calibration_on_card_names_it_and_launches_k1(cuda, own_profile_dir):
    """The device ladders on the card: the fingerprint names this card and
    its count, the fused ladder launches K1 (``plan.execute(...,
    engine="fused")``), the torch ladder launches no kernel of ours, and the
    saved profile loads back with its tag."""
    from repro_torch.core import profile

    before = kernels.launch_counts()
    first = profile.calibrate_profile(scale=0.25, reps=1,
                                      sections=("torch",), tune=False,
                                      save=True)
    assert kernels.launch_counts() == before
    assert first.fitted == ("torch_base", "torch_prod")
    # the second calibration starts from the saved one and keeps its fit
    prof = profile.calibrate_profile(scale=0.25, reps=1,
                                     sections=("fused",), tune=False,
                                     save=True)
    assert prof.constants.torch_prod == first.constants.torch_prod
    assert kernels.fused_stream.n_launches > before["fused_stream"]
    fp = prof.fingerprint
    assert fp["platform"] == "cuda"
    assert fp["device_kind"] == torch.cuda.get_device_name(0)
    assert fp["device_count"] == torch.cuda.device_count()
    assert fp["cuda"] == torch.version.cuda
    assert prof.fitted == ("fused_base", "fused_prod", "torch_base",
                           "torch_prod")
    back = profile.load_profile()
    assert back.tag == prof.tag and back.constants == prof.constants
    assert profile.current_profile() is prof


def test_calibrated_profile_ranks_auto_on_card(cuda, own_profile_dir):
    """A whole smoke calibration on the card, then auto plans under it: the
    tuned guard applies, the tiled plans carry the profile's tag, and the
    torch and host grids stay exact whatever they pick."""
    from repro_torch.core import fast, plan_spgemm_tiled, profile, spgemm
    from repro_torch.sparse.format import CSC

    prof = profile.calibrate_profile(scale=0.25, reps=1)
    assert set(prof.tuning) == set(profile.TUNING_KEYS)
    assert profile.apply_tuning(prof) == {
        "stream_max_products": prof.tuning["stream_max_products"]}
    assert fast.STREAM_MAX_PRODUCTS == prof.tuning["stream_max_products"]
    profile.set_profile(prof)
    a, v = _int_operands(seed=24)
    a = CSC(v, a.row_indices, a.col_ptr, a.shape)
    d = csc_to_dense_f64(a)
    for backend in ("torch", "host"):
        plan = plan_spgemm_tiled(a, a, backend=backend, cache=False)
        assert dict(plan.params)["profile"] == prof.tag
        c = spgemm(a, a, method="auto", backend=backend)
        np.testing.assert_array_equal(csc_to_dense_f64(c), d @ d)


# -- the dense model stack with its FFNs on the SpGEMM stream ------------------


@pytest.fixture
def smoke_model(cuda):
    """smoke(granite-20b) on the card, its FFNs on the spgemm path (keep
    0.5), and the dense oracle on the pruned weights."""
    from repro_torch.configs import get_config
    from repro_torch.core import plan_cache_clear
    from repro_torch.models import densify_ffn_params, init_model, smoke, \
        sparsify_ffn_params

    plan_cache_clear()
    cfg = smoke(get_config("granite-20b"))
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
    sparse, overlay = sparsify_ffn_params(cfg, params, keep_density=0.5)
    yield cfg, sparse, overlay, densify_ffn_params(cfg, sparse, overlay)
    plan_cache_clear()


def _decode_inputs(cfg, cuda):
    from repro_torch.models import init_cache

    cache = init_cache(cfg, 3, 16, dtype=torch.float32)
    token = torch.tensor([[3], [5], [7]], device=cuda)
    cur = torch.tensor([0, 2, 5], dtype=torch.int32, device=cuda)
    return token, cache, cur


def test_sparse_decode_on_card_matches_dense_oracle(smoke_model, cuda):
    """decode_step with the overlay (the torch stream on the card) against
    decode_step on the densified weights (cuBLAS), and against the host
    stream's decode_step_loop; no kernel of ours runs."""
    from repro_torch.models import decode_step, decode_step_loop

    cfg, sparse, overlay, dense = smoke_model
    token, cache, cur = _decode_inputs(cfg, cuda)
    kernels.reset_launch_counts()
    got, _ = decode_step(sparse, cfg, token, cache, cur, sparse_ffn=overlay)
    assert set(kernels.launch_counts().values()) == {0}
    want, _ = decode_step(dense, cfg, token, cache, cur)
    loop, _ = decode_step_loop(sparse, cfg, token, cache, cur,
                               sparse_ffn=overlay, sparse_host=True)
    assert got.is_cuda and got.shape == (3, 1, cfg.vocab_padded)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loop.cpu().numpy(), got.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_sparse_decode_step_never_waits_for_the_card(smoke_model, cuda):
    """After the first step has built the plans, a sparse decode step on
    operands already on the card makes no host sync."""
    from repro_torch.models import decode_step

    cfg, sparse, overlay, _ = smoke_model
    token, cache, cur = _decode_inputs(cfg, cuda)
    _, cache = decode_step(sparse, cfg, token, cache, cur, sparse_ffn=overlay)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        logits, _ = decode_step(sparse, cfg, token, cache, cur + 1,
                                sparse_ffn=overlay)
        logits.argmax(-1)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]


def test_fused_engine_equals_torch_stream_on_an_ffn_plan(smoke_model, cuda):
    """K1 (``stream_apply(..., engine="fused")``) against the torch stream
    on an overlay matrix's one-token plan: bit for bit on integer values,
    within 1e-5 normwise on real ones (C5); K1 launches."""
    cfg, _, overlay, _ = smoke_model
    m = overlay["l0"].down
    plan = m._spgemm_plan(1)[0]
    assert plan.device.type == "cuda"
    gen = torch.Generator(device=cuda).manual_seed(1)
    w_int = torch.randint(-2, 3, (m.w_csc.nnz,), generator=gen,
                          device=cuda).float()
    x_int = torch.randint(-2, 3, (m.shape[1],), generator=gen,
                          device=cuda).float()
    kernels.reset_launch_counts()
    assert torch.equal(plan.stream_apply(w_int, x_int, engine="fused"),
                       plan.stream_apply(w_int, x_int))
    assert kernels.launch_counts()["fused_stream"] == 1
    x = torch.randn((m.shape[1],), generator=gen, device=cuda)
    k1 = plan.stream_apply(m.w_values, x, engine="fused").double()
    ts = plan.stream_apply(m.w_values, x).double()
    assert float((k1 - ts).norm() / ts.norm()) <= 1e-5


# -- the MoE, SSM and hybrid families ----------------------------------------


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_family_decode_on_card_matches_cpu(arch, cuda):
    """A smoke-size decode_step on the card (slots at different positions,
    an f32 cache) against the same model's on the CPU, three steps, logits
    and caches within 1e-5 normwise; then a warm step makes no host sync.
    cuBLAS and the CPU's products round differently in the last place, and
    the reference's ``fan_in`` rule (std 1/sqrt(n_rep) on a stacked leaf)
    saturates the attention softmax, which makes such a difference large:
    the stacked weights are rescaled to std 1/sqrt(d_in) first."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_model, smoke

    cfg = smoke(get_config(arch))
    params = _well_scaled(cfg, init_model(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    dparams = _to(params, cuda)
    cache = init_cache(cfg, 3, 16, dtype=torch.float32, device="cpu")
    dcache = _to(cache, cuda)
    token = torch.tensor([[3], [5], [7]])
    cur = torch.tensor([0, 2, 5], dtype=torch.int32)
    for step in range(3):
        want, cache = decode_step(params, cfg, token + step, cache,
                                  cur + step)
        got, dcache = decode_step(dparams, cfg, (token + step).to(cuda),
                                  dcache, (cur + step).to(cuda))
        assert got.is_cuda and got.shape == want.shape
        err = _normwise(got, want)
        assert err <= 1e-5, (step, err)
        for g, w in zip(_leaves(dcache), _leaves(cache)):
            assert g.dtype == w.dtype
            if w.any():
                assert _normwise(g, w) <= 1e-5, (step, _normwise(g, w))
    dtoken, dcur = (token + 3).to(cuda), (cur + 3).to(cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        logits, _ = decode_step(dparams, cfg, dtoken, dcache, dcur)
        logits.argmax(-1)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]


def _well_scaled(cfg, params):
    """``params`` with each stacked ``fan_in`` leaf at std 1/sqrt(d_in)."""
    from repro_torch.models import model_tables
    from repro_torch.models.params import Leaf

    def walk(t, p):
        if isinstance(t, Leaf):
            if t.init == "fan_in" and t.axes[0] == "layers" \
                    and len(t.shape) >= 3:
                return p * (t.shape[0] / t.shape[-2]) ** 0.5
            return p
        return {k: walk(t[k], p[k]) for k in p}

    return walk(model_tables(cfg), params)


def _normwise(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).norm() / want.norm())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_moe_ffn_on_card_is_bit_stable_and_matches_cpu(cuda):
    """moe_ffn at 4096 tokens (32 groups, drops) on the card: two runs bit
    for bit, and the CPU's within 1e-5 normwise."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe_ffn, moe_table, smoke
    from repro_torch.models.params import init_params

    cfg = smoke(get_config("qwen3-moe-30b-a3b"))
    p = init_params(moe_table(cfg), torch.Generator().manual_seed(1),
                    device="cpu")
    x = torch.randn((1, 4096, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    want = moe_ffn(p, cfg, x).double()
    dp, dx = _to(p, cuda), x.to(cuda)
    got = moe_ffn(dp, cfg, dx)
    assert torch.equal(got, moe_ffn(dp, cfg, dx))
    assert float((got.cpu().double() - want).norm() / want.norm()) <= 1e-5


def test_moe_dispatch_spgemm_on_card_launches_k2(cuda):
    """The dispatch R^T X through the cuda backend's default method: K2
    (SPA) launches for the experts' columns, and the result is exact on
    integer values (x in {-2..2}, gates in {1, 2, 3})."""
    from repro_torch.core import plan_cache_clear
    from repro_torch.models import moe_dispatch_spgemm

    t, d, e, k = 64, 32, 8, 2
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 3, size=(t, d)).astype(np.float32)
    idx = np.argsort(-rng.uniform(size=(t, e)), axis=1)[:, :k]
    gates = rng.integers(1, 4, size=(t, k)).astype(np.float32)
    plan_cache_clear()
    kernels.reset_launch_counts()
    got = moe_dispatch_spgemm(torch.from_numpy(x).to(cuda),
                              torch.from_numpy(idx).to(cuda),
                              torch.from_numpy(gates).to(cuda), e)
    assert kernels.launch_counts()["spa_spgemm"] > 0
    assert got.is_cuda and got.dtype == torch.float32
    r = np.zeros((t, e))
    np.put_along_axis(r, idx, gates.astype(np.float64), axis=1)
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.float64),
                                  r.T @ x.astype(np.float64))


# -- the cross-attention families and the serving engine ---------------------


def _serve_ticks(eng, prompts, max_new):
    """Serve ``prompts`` tick by tick: each tick's host logits and the host
    syncs it made (``torch.cuda.set_sync_debug_mode``) on the card."""
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    logits, syncs, decode = [], [], eng._decode
    eng._decode = lambda toks: logits.append(decode(toks)) or logits[-1]
    while eng.queue or any(eng.slots):
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                eng.step()
                torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("called a synchronizing CUDA operation"
                             in str(w.message) for w in caught))
        else:
            eng.step()
    return logits, syncs, {k: r.generated for k, r in eng.finished.items()}


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_engine_serves_cross_families_on_card(arch, cuda):
    """The engine at smoke size on the card, the memory installed from
    ``_memory_from_aux`` (every ``xgate`` at 0.7, weights well-scaled):
    the CPU engine's tokens, every tick's logits within 1e-5 normwise of
    the CPU's, one host sync a tick (the logits' copy, counted in
    ``stats()``), and a second engine on the card equal bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, smoke
    from repro_torch.models.lm import _memory_from_aux
    from repro_torch.serving import ServeEngine

    cfg = smoke(get_config(arch))
    params = _well_scaled(cfg, init_model(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    for sub in params["blocks"].values():
        if "xgate" in sub:
            sub["xgate"] = torch.full_like(sub["xgate"], 0.7)
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    x = torch.randn((3, n, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    prompts = ([1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11])
    dparams = _to(params, cuda)
    runs = []
    for dev, p in (("cpu", params), (cuda, dparams), (cuda, dparams)):
        eng = ServeEngine(cfg, p, max_batch=3, cache_len=32, device=dev,
                          aux=_memory_from_aux(p, cfg, x.to(dev)))
        runs.append(_serve_ticks(eng, prompts, 5) + (eng.stats(),))
    (want, _, want_tok, _), (got, syncs, got_tok, stats), \
        (again, _, _, _) = runs
    assert got_tok == want_tok and len(got) == len(want)
    for g, w in zip(got, want):
        assert _normwise(torch.from_numpy(g), torch.from_numpy(w)) <= 1e-5
    assert set(syncs) == {1}, syncs
    assert stats["host_syncs"] == stats["jit_ticks"] == len(got)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


def test_engine_refuses_params_on_another_device(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, smoke
    from repro_torch.serving import ServeEngine

    cfg = smoke(get_config("qwen2-0.5b"))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="params lie on cpu"):
        ServeEngine(cfg, params)
    with pytest.raises(ValueError, match="params lie on cuda"):
        ServeEngine(cfg, _to(params, cuda), device="cpu")


# -- training ----------------------------------------------------------------

TRAIN_ARCHS = ("qwen2-0.5b", "qwen3-moe-30b-a3b", "falcon-mamba-7b")


def _train_setup(arch, dev, quantize=False):
    """(cfg, step, state on ``dev``, batches on ``dev``): smoke size, the
    port's draw well scaled (as above), three ``synth_batch`` batches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, smoke
    from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, \
        adamw_init, build_train_step, synth_batch

    cfg = smoke(get_config(arch))
    tc = TrainConfig(total_steps=10, peak_lr=1e-3, warmup_steps=2,
                     opt=AdamWConfig(quantize_moments=quantize))
    params = _to(_well_scaled(cfg, init_model(
        cfg, torch.Generator().manual_seed(0), device="cpu")), dev)
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(cfg.vocab, 32, 4, seed=3), i).items()} for i in range(3)]
    return cfg, build_train_step(cfg, tc), state, batches


def _train(step, state, batches):
    from repro_torch.training.tree import tree_map

    state = tree_map(torch.clone, state)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, b, i)
        losses.append(m["loss"])
    return state, torch.stack(losses)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_on_card_match_cpu(arch, cuda):
    """Three train steps on the card against the same steps on the CPU:
    the loss at 1e-5 relative; the params at 1e-5 normwise, whole and per
    weight leaf; the zero-initialised biases at 1e-2, as in
    ``tests/test_torch_training_steps.py`` (their elements are AdamW's
    steps alone, about ``lr * sign(g)`` each, and the sign of a gradient
    element that is a cancelling sum's remainder differs with the order
    of the sum)."""
    cfg, step, state, batches = _train_setup(arch, cuda)
    got, losses = _train(step, state, batches)
    want, want_losses = _train(step, _to(state, "cpu"),
                               [_to(b, "cpu") for b in batches])
    assert float((losses.cpu() - want_losses).abs().max()) <= 1e-5 * float(
        want_losses.abs().max())
    g = {k: v for k, v in _paths(got["params"])}
    w = {k: v for k, v in _paths(want["params"])}
    assert _normwise(torch.cat([g[k].flatten() for k in sorted(g)]),
                     torch.cat([w[k].flatten() for k in sorted(w)])) <= 1e-5
    for k in w:
        tol = 1e-2 if k.endswith("/b") else 1e-5
        assert _normwise(g[k], w[k]) <= tol, k


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_on_card_are_bit_stable(arch, cuda):
    """Two runs of three steps from one state: every param and moment bit
    for bit (the embedding's and the MoE dispatch's backward add in a
    fixed order, ground rules)."""
    _, step, state, batches = _train_setup(arch, cuda, quantize=True)
    a, la = _train(step, state, batches)
    b, lb = _train(step, state, batches)
    assert torch.equal(la, lb)
    for (k, x), (_, y) in zip(_paths(a), _paths(b)):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_runs_no_op_known_nondeterministic(arch, cuda):
    """A train step under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: PyTorch warns for each op it knows to have no
    deterministic CUDA implementation, and none does (cuBLAS's own
    warning about its workspace setting aside: one stream's products are
    reproducible)."""
    _, step, state, batches = _train_setup(arch, cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(state, batches[0], 0)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = [str(w.message) for w in caught
               if "deterministic" in str(w.message)
               and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)]
    assert not flagged, flagged


def test_embedding_backward_on_card_is_fixed_order_without_a_sync(cuda):
    """The embedding's backward (a stable sort and ``segment_reduce``) at
    qwen2-0.5b's table, 4096 tokens with repeats: equal to indexing's
    backward within f32 reassociation, two runs bit for bit, and no host
    sync."""
    from repro_torch.models.layers import embed

    gen = torch.Generator(device=cuda).manual_seed(7)
    table = torch.randn((151936, 896), generator=gen, device=cuda,
                        requires_grad=True)
    tokens = torch.randint(0, 4096, (8, 512), generator=gen, device=cuda)
    g = torch.randn((8, 512, 896), generator=gen, device=cuda)

    def grad():
        return torch.autograd.grad(embed({"embedding": table}, tokens),
                                   table, g)[0]

    a = grad()
    out = []
    assert _count_syncs(lambda: out.append(grad())) == 0
    assert torch.equal(a, out[0])
    want, = torch.autograd.grad(table[tokens], table, g)
    assert _normwise(a, want) <= 1e-6


def _sparse_ffn(dev, seed=4, d=64, hid=96, keep=0.5):
    from repro_torch.models import SparseFFN

    rng = np.random.default_rng(seed)
    p = {"gate": {"w": rng.normal(size=(d, hid), scale=0.3)},
         "up": {"w": rng.normal(size=(d, hid), scale=0.3)},
         "down": {"w": rng.normal(size=(hid, d), scale=0.3)}}
    return SparseFFN.from_params(p, keep_density=keep, path="spgemm",
                                 device=dev)


def test_sparse_ffn_train_step_warm_makes_no_host_sync(cuda):
    """After its first step a sparse-FFN train step builds no plan, makes
    no host sync, launches none of our kernels (the torch stream), and its
    loss falls."""
    from repro_torch.core import plan_cache_info
    from repro_torch.training.train_loop import build_sparse_ffn_train_step

    sp = _sparse_ffn(cuda)
    step, state = build_sparse_ffn_train_step(sp, lr=5e-2)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((16, 64), generator=gen, device=cuda)
    y = torch.randn((16, 64), generator=gen, device=cuda)
    state, m0 = step(state, (x, y))
    misses = plan_cache_info()["misses"]
    kernels.reset_launch_counts()
    losses = [m0["loss"]]
    for _ in range(5):
        n = _count_syncs(lambda: losses.append(step(state, (x, y))[1]["loss"]))
        assert n == 0
    assert plan_cache_info()["misses"] == misses
    assert not any(kernels.launch_counts().values())
    losses = torch.stack(losses).cpu()
    assert float(losses[-1]) < 0.7 * float(losses[0]), losses


def test_sparse_ffn_gradient_through_k1_equals_torch_stream(cuda):
    """On each matrix's plan of a sparse-FFN train step, K1
    (``stream_apply(..., engine="fused")``, its ``grad_a``/``grad_b``
    kernels backward) against the torch stream: forward and both
    gradients bit for bit on integer values, within 1e-5 normwise on real
    ones (C5); K1 launches."""
    sp = _sparse_ffn(cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    kernels.reset_launch_counts()
    for m in (sp.gate, sp.up, sp.down):
        plan = m._spgemm_plan(16)[0]
        k = m.shape[1]
        for integer in (True, False):
            def draw(n):
                if integer:
                    return torch.randint(-2, 3, (n,), generator=gen,
                                         device=cuda).float()
                return torch.randn((n,), generator=gen, device=cuda)

            w, xv = draw(m.w_csc.nnz), draw(k * 16)
            g = draw(plan.stream.nnz)
            outs = []
            for engine in ("fused", None):
                wr, xr = w.clone().requires_grad_(), xv.clone().requires_grad_()
                c = plan.stream_apply(wr, xr, engine=engine)
                gw, gx = torch.autograd.grad(c, (wr, xr), g)
                outs.append((c.detach(), gw, gx))
            for got, want in zip(*outs):
                if integer:
                    assert torch.equal(got, want)
                else:
                    assert _normwise(got, want) <= 1e-5
    assert kernels.launch_counts()["fused_stream"] > 0


# -- faults, the plan builder and the engine's background warm -----------------


@pytest.fixture
def warm_model(cuda):
    """smoke(qwen2-0.5b) on the card, its FFNs on the spgemm path (keep
    0.5), with an empty plan LRU and no fault plan before and after."""
    from repro_torch.configs import get_config
    from repro_torch.core import faults, plan_cache_clear
    from repro_torch.models import init_model, smoke, sparsify_ffn_params

    plan_cache_clear()
    cfg = smoke(get_config("qwen2-0.5b"))
    params = init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
    sparse, overlay = sparsify_ffn_params(cfg, params, keep_density=0.5)
    yield cfg, sparse, overlay
    faults.uninstall()
    plan_cache_clear()


def _serve(eng, prompts, new=6):
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    for _ in range(200):
        if not (eng.queue or any(eng.slots)):
            break
        assert eng.step()
    return [eng.finished[r].generated for r in rids]


WARM_PROMPTS = ([1, 2, 3], [4, 5, 6, 7])


def test_builder_warmed_engine_promotes_and_equals_builder_free(warm_model,
                                                                cuda):
    """On the card: with the warm gated, ticks run the host stream (each
    tick's host syncs as the engine counts them); released, the engine
    promotes, its first device tick builds no plan, and its greedy tokens
    equal a builder-free engine's."""
    import threading

    from repro_torch.core import PlanBuilder, plan_cache_info
    from repro_torch.serving import ServeEngine

    cfg, sparse, overlay = warm_model
    want = _serve(ServeEngine(cfg, sparse, max_batch=2, cache_len=32,
                              sparse_ffn=overlay), WARM_PROMPTS)
    with PlanBuilder() as builder:
        gate = threading.Event()
        builder.submit_task(lambda: gate.wait(60), tag="gate")
        eng = ServeEngine(cfg, sparse, max_batch=2, cache_len=32,
                          sparse_ffn=overlay, plan_builder=builder)
        rids = [eng.submit(p, max_new_tokens=6) for p in WARM_PROMPTS]
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            assert eng.step()
            torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        assert len(syncs) == eng.stats()["host_syncs"] == 1 + 5 * cfg.n_layers
        assert eng.stats()["fallback_ticks"] == 1
        gate.set()
        assert eng.wait_sparse(120)
        misses = plan_cache_info()["misses"]
        assert eng.step()
        assert plan_cache_info()["misses"] == misses
        for _ in range(200):
            if not (eng.queue or any(eng.slots)):
                break
            assert eng.step()
        got = [eng.finished[r].generated for r in rids]
        assert builder.wait_idle(60)
    assert got == want
    assert eng.stats()["warm_failures"] == 0


def test_breaker_drill_on_card(warm_model, cuda):
    """``warm_compile`` fails twice: the engine walks degraded and pinned,
    a half-open probe recovers it, every tick completes, the tokens equal a
    fault-free run's, no builder worker is lost."""
    from repro_torch.core import PlanBuilder, faults
    from repro_torch.serving import CircuitBreaker, Health, ServeEngine

    cfg, sparse, overlay = warm_model
    want = _serve(ServeEngine(cfg, sparse, max_batch=2, cache_len=32,
                              sparse_ffn=overlay), WARM_PROMPTS[:1], 8)
    t = [0.0]
    br = CircuitBreaker(degrade_after=1, pin_after=2, cooldown=5.0,
                        clock=lambda: t[0])
    with faults.inject(faults.FaultRule("warm_compile", "fail", every=1,
                                        max_fires=2, match="serve-warm")):
        with PlanBuilder() as builder:
            eng = ServeEngine(cfg, sparse, max_batch=2, cache_len=32,
                              sparse_ffn=overlay, plan_builder=builder,
                              breaker=br)
            assert builder.wait_idle(60)
            assert br.health is Health.DEGRADED
            rid = eng.submit(WARM_PROMPTS[0], max_new_tokens=8)
            assert eng.step()
            assert builder.wait_idle(60)
            assert br.health is Health.FALLBACK_PINNED
            ticks = 0
            while not eng.sparse_ready() and (eng.queue or any(eng.slots)):
                assert eng.step()
                ticks += 1
                assert builder.wait_idle(60)
                if ticks == 2:
                    t[0] = 5.1
            assert eng.wait_sparse(120)
            done = eng.run_to_completion()
            assert builder.info()["workers"] == 1
    assert br.health is Health.HEALTHY
    assert eng.stats()["warm_failures"] == 2 and eng.stats()["jit_ticks"] > 0
    assert done[rid].generated == want[0]


def test_single_flight_on_a_torch_key(warm_model, cuda):
    """Two builder tasks ask for one torch plan at once (the owner slowed
    by an injected delay): one build, one miss, one hit, one plan; its
    device stream lifted once."""
    import threading

    from repro_torch.core import PlanBuilder, cached_plan, faults, \
        plan_cache_clear, plan_cache_info, warm_plan
    from repro_torch.models.sparse_ffn import _dense_pattern

    _, _, overlay = warm_model
    w = overlay["l0"].gate.w_csc
    x = _dense_pattern(w.shape[1], 3)
    plan_cache_clear()
    barrier = threading.Barrier(2, timeout=60)

    def task():
        barrier.wait()
        plan = cached_plan(w, x, "expand", backend="torch")
        warm_plan(plan)
        return plan

    with faults.inject(faults.FaultRule("plan_spgemm", "delay", every=1,
                                        seconds=0.3, match="torch")) as fp:
        with PlanBuilder(workers=2) as builder:
            builder.submit_task(task, tag=0)
            builder.submit_task(task, tag=1)
            assert builder.wait_idle(60)
            res = builder.poll()
        assert fp.fired("plan_spgemm") == 1
    info = plan_cache_info()
    assert all(r.ok for r in res) and res[0].plan is res[1].plan
    assert (info["misses"], info["hits"]) == (1, 1)
    assert res[0].plan.device.type == "cuda"
    assert info["device_stream_bytes"] > 0


def test_warm_failures_are_reported_not_hidden(warm_model, cuda):
    """A warm that fails on the card (``device_lift`` on the torch
    backend) shows in ``warm_failures``, the breaker's ``info()`` and the
    builder's failed count, while the host-stream ticks keep serving every
    request."""
    from repro_torch.core import PlanBuilder, faults
    from repro_torch.serving import CircuitBreaker, ServeEngine

    cfg, sparse, overlay = warm_model
    br = CircuitBreaker(pin_after=1, cooldown=3600.0)
    with faults.inject(faults.FaultRule("device_lift", "fail", every=1,
                                        match="torch")):
        with PlanBuilder() as builder:
            eng = ServeEngine(cfg, sparse, max_batch=2, cache_len=32,
                              sparse_ffn=overlay, plan_builder=builder,
                              breaker=br)
            assert builder.wait_idle(60)
            got = _serve(eng, WARM_PROMPTS, 3)
            info = builder.info()
    stats = eng.stats()
    assert stats["warm_failures"] == 1 and stats["jit_ticks"] == 0
    assert stats["health"] == "fallback-pinned"
    assert stats["breaker"]["trips"] == 1 and info["failed"] == 1
    assert all(len(g) == 3 for g in got)


# ---------------------------------------------------------------------------
# the SpGEMM mesh (backend="mesh"), its shards on one card
# ---------------------------------------------------------------------------


def _int_operand(n, z, seed, n_rows):
    m = generate.random_uniform_csc(n, z, seed=seed, n_rows=n_rows)
    rng = np.random.default_rng(seed + 100)
    return type(m)(torch.from_numpy(
        rng.integers(1, 8, m.nnz).astype(np.float32)), m.row_indices,
        m.col_ptr, m.shape)


@pytest.mark.parametrize("shards", [1, 4])
def test_mesh_on_card_equals_host_stream_without_a_sync(cuda, shards):
    """Every shard on the card: C equals the host stream bit for bit on
    integer values, two runs agree, batched equals looped, and an
    execute on card operands makes no host sync."""
    a = _int_operand(160, 8, 0, 120).to(cuda)
    b = _int_operand(120, 7, 1, 160).to(cuda)
    total = int(ops_per_column(a, b).sum())
    # past one shard's guard on 4 shards: only the mesh keeps the stream
    limit = total // 2 if shards > 1 else None
    plan = plan_spgemm(a, b, "expand", backend="mesh", shards=shards,
                       device="cuda", stream_limit=limit)
    want = plan_spgemm(a, b, "expand", backend="host").execute(
        a.to("cpu"), b.to("cpu"), engine="stream")
    c = plan.execute(a, b)
    assert c.values.device.type == "cuda"
    assert np.array_equal(_np(c.col_ptr), _np(want.col_ptr))
    assert np.array_equal(_np(c.row_indices), _np(want.row_indices))
    assert np.array_equal(_np(c.values), _np(want.values).astype(np.float32))
    assert torch.equal(plan.execute(a, b).values, c.values)
    stack = torch.stack([a.values, 2 * a.values])
    bstack = torch.stack([b.values, b.values])
    outs = plan.execute_batched(stack, bstack)
    for i in range(2):
        assert torch.equal(outs[i].values,
                           plan.execute(stack[i], bstack[i]).values)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        plan.execute(a, b)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]


def test_mesh_gradients_on_card_equal_the_torch_plan(cuda):
    a = _int_operand(50, 5, 2, 40).to(cuda)
    b = _int_operand(30, 4, 3, 50).to(cuda)
    mesh = plan_spgemm(a, b, "expand", backend="mesh", shards=4,
                       device="cuda")
    tplan = plan_spgemm(a, b, "expand", backend="torch", device=cuda)

    def grads(apply):
        x = a.values.clone().requires_grad_()
        y = b.values.clone().requires_grad_()
        return torch.autograd.grad((apply(x, y) ** 2).sum(), (x, y))

    for got, want in zip(grads(mesh.stream_apply), grads(tplan.stream_apply)):
        assert torch.equal(got, want)


def test_mesh_with_no_device_needs_a_card_a_shard(cuda):
    """``device=None`` puts shard d on ``cuda:d``: more shards than cards
    are refused at execute, the message naming ``device=``."""
    a = _int_operand(30, 3, 21, 30).to(cuda)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="device="):
        spgemm(a, a, "expand", backend="mesh", shards=cards + 1)


# -- the launch dry run and the donated decode step ------------------------


def _dryrun_args(cfg, b, s, dev, seed=0, dtype=None):
    """A decode cell's arguments on ``dev``: params in ``dtype``, by
    default the dry run's (bf16), and a bf16 cache drawn from ``seed``,
    tokens and per-slot ``cur_len`` below ``s``."""
    from repro_torch.launch.dryrun import PARAM_DTYPE
    from repro_torch.models import init_cache, init_model
    from repro_torch.training.tree import tree_leaves

    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_model(cfg, g, dev, dtype=dtype or PARAM_DTYPE)
    cache = init_cache(cfg, b, s, device=dev)
    for leaf in tree_leaves(cache):
        leaf.normal_(generator=g)
    token = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev,
                          dtype=torch.int32)
    cur = torch.randint(0, s, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    return params, token, cache, cur


def test_dryrun_decode_cell_on_card_matches_its_record(cuda):
    """Phase 20 (b) of ``chip_smoke.py`` at a small batch: qwen2-0.5b at
    full width and depth, B = 8, S = 2048, on the host mesh.  The record's
    argument bytes against the card's allocation (1 %), the flop count of
    the donated step on the card equal to the meta trace's, the cache
    updated in place, the logits finite and bit-stable."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import Cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training.tree import tree_paths

    cfg = get_config("qwen2-0.5b")
    shape = ShapeConfig("decode_32k", 2048, 8, "decode")
    cell = Cell(cfg, shape, make_host_mesh("meta"))
    out, secs, meta_flops = cell.trace()
    want = cell.record(out, secs, meta_flops)["memory"][
        "argument_size_in_bytes"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, token, cache, cur = _dryrun_args(cfg, 8, 2048, cuda)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    assert abs(allocated - want) <= 0.01 * want
    given = tree_paths(cache)
    ptrs = {k: t.data_ptr() for k, t in given.items()}
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        logits, new = decode_step(params, cfg, token, cache, cur,
                                  donate_cache=True)
    assert counter.get_total_flops() == meta_flops
    got = tree_paths(new)
    assert all(got[k] is given[k] and got[k].data_ptr() == ptrs[k]
               for k in given)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    with torch.no_grad():
        again, _ = decode_step(params, cfg, token, cache, cur,
                               donate_cache=True)
    assert torch.equal(again.view(torch.int32), logits.view(torch.int32))


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "qwen3-moe-30b-a3b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_donated_decode_on_card_equals_the_copying_step(arch, param_dtype,
                                                        cuda):
    """Smoke size on the card, bf16 (the dry run's) or f32 params, two
    steps: the donated step's logits and cache equal the copying step's
    bit for bit, and every cache leaf whose dtype stays is the given
    tensor (its storage unchanged).  On f32 params the first step's mamba
    window comes back f32 from the bf16 cache: a new tensor, which it must
    be for the mamba families."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, smoke
    from repro_torch.training.tree import tree_map, tree_paths

    cfg = smoke(ARCHS[arch])
    dtype = getattr(torch, param_dtype)
    params, token, cache, cur = _dryrun_args(cfg, 3, 64, cuda, seed=1,
                                             dtype=dtype)
    for i in range(2):
        with torch.no_grad():
            want, want_cache = decode_step(
                params, cfg, token, tree_map(torch.clone, cache), cur)
            given = tree_paths(cache)
            ptrs = {k: t.data_ptr() for k, t in given.items()}
            got, got_cache = decode_step(params, cfg, token, cache, cur,
                                         donate_cache=True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        gp, wp = tree_paths(got_cache), tree_paths(want_cache)
        assert gp.keys() == wp.keys()
        for k in gp:
            assert gp[k].dtype == wp[k].dtype and torch.equal(gp[k], wp[k])
            if gp[k].dtype == given[k].dtype:
                assert gp[k] is given[k] and gp[k].data_ptr() == ptrs[k]
        changed = [k for k in gp if gp[k].dtype != given[k].dtype]
        mamba = i == 0 and dtype == torch.float32 and any(
            "conv" in k for k in gp)
        assert bool(changed) == mamba, changed
        cache, cur = got_cache, cur + 1


def test_pipelined_stack_on_card_equals_unpipelined(cuda):
    """Smoke-size qwen2-0.5b in 2 and 4 stages on a ``pod`` mesh over the
    card: bit for bit the unpipelined stack, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipelined_apply, \
        stage_params_of
    from repro_torch.launch.dryrun import pipeline_stage_fn
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_model, smoke

    cfg = smoke(get_config("qwen2-0.5b"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_model(cfg, gen, cuda)
    x = torch.randn((3, 2, 32, cfg.d_model), generator=gen, device=cuda)
    fn = pipeline_stage_fn(cfg)
    with torch.no_grad():
        want = torch.stack([fn(params["blocks"], x[i]) for i in range(3)])
        for n_stages in (2, 4):
            got = pipelined_apply(
                Mesh(("pod",), (n_stages,), (cuda,)), fn,
                stage_params_of(params["blocks"], n_stages), x)
            assert got.is_cuda
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32))


def test_psum_compressed_on_card_is_bit_stable(cuda):
    """2 shards of the card: the mean of the dequantized shards added in
    shard order, bit for bit, twice."""
    from repro_torch.distributed import dequantize_tree, psum_compressed, \
        quantize_tree

    gen = torch.Generator(device=cuda).manual_seed(1)
    shards = [{"w": torch.randn((64, 300), generator=gen, device=cuda),
               "b": torch.randn((17,), generator=gen, device=cuda)}
              for _ in range(2)]
    got = psum_compressed(shards, [cuda, cuda])
    again = psum_compressed(shards, [cuda, cuda])
    deq = [dequantize_tree(quantize_tree(s)) for s in shards]
    for k in ("w", "b"):
        want = (deq[0][k] + deq[1][k]) / 2
        for tree in got + again:
            assert tree[k].is_cuda
            assert torch.equal(tree[k].view(torch.int32),
                               want.view(torch.int32))


def test_restore_with_shardings_places_each_leaf_on_card(cuda, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_sharding, \
        sharding_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_model, model_specs, smoke
    from repro_torch.training import restore_checkpoint, save_checkpoint
    from repro_torch.training.tree import tree_map, tree_paths

    cfg = smoke(get_config("qwen2-0.5b"))
    params = init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    path = save_checkpoint(str(tmp_path), 1, params)
    mesh = make_host_mesh()
    shardings = param_sharding(model_specs(cfg, sharding_rules(mesh)), mesh)
    template = tree_map(lambda t: t.to("meta"), params)
    got, step, _ = restore_checkpoint(path, template, shardings=shardings)
    assert step == 1
    want = tree_paths(params)
    for k, leaf in tree_paths(got).items():
        assert leaf.is_cuda, k
        assert torch.equal(leaf.cpu().view(torch.int32),
                           want[k].view(torch.int32)), k


# -- the model stack on bf16 params -------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b"])
def test_bf16_params_decode_on_card(arch, cuda):
    """A smoke-size decode step on bf16 params (an f32 cache, as the
    serving engine's): logits finite and within 3e-2 normwise of the same
    bf16 model's steps on the CPU (``tests/test_torch_bf16_params.py``'s
    bound between two bf16 runs that round differently; a bf16 run is not
    held to an f32 one here, since a bf16 router's tie can pick another
    expert), a second run bit for bit, and a warm step with no host
    sync."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_model, smoke

    cfg = smoke(get_config(arch))
    params = _well_scaled(cfg, init_model(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
        dtype=torch.bfloat16))
    token = torch.tensor([[3], [5], [7]])
    cur = torch.tensor([0, 2, 5], dtype=torch.int32)

    def run(p, dev, steps=3):
        cache = init_cache(cfg, 3, 16, dtype=torch.float32, device=dev)
        out = []
        with torch.no_grad():
            for i in range(steps):
                lg, cache = decode_step(p, cfg, (token + i).to(dev), cache,
                                        (cur + i).to(dev))
                out.append(lg)
        return torch.stack(out), cache

    got, cache = run(params, cuda)
    again, _ = run(params, cuda)
    want, _ = run(_to(params, "cpu"), "cpu")
    assert got.dtype == torch.float32
    assert torch.isfinite(got[..., :cfg.vocab]).all()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _normwise(got[..., :cfg.vocab].cpu(),
                     want[..., :cfg.vocab]) <= 3e-2
    dtoken, dcur = token.to(cuda), (cur + 3).to(cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        with torch.no_grad():
            decode_step(params, cfg, dtoken, cache, dcur)
        torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]


def test_bf16_product_refused_while_reduced_precision_reduction_is_on(cuda):
    """``dense`` and the unembedding on bf16 operands raise while cuBLAS
    may reduce a bf16 GEMM in bf16; an f32 product does not; with the flag
    False the bf16 product runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    from repro_torch.models.layers import dense, lm_logits

    cfg = smoke(get_config("qwen2-0.5b"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {"w": torch.randn((cfg.d_model, cfg.vocab_padded), generator=gen,
                          device=cuda)}
    x = torch.randn((2, 3, cfg.d_model), generator=gen, device=cuda)
    p16, x16 = {"w": p["w"].bfloat16()}, x.bfloat16()
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        for fn in (lambda: dense(p16, x16),
                   lambda: lm_logits(p16, cfg, x16)):
            with pytest.raises(RuntimeError,
                               match="allow_bf16_reduced_precision"):
                fn()
        assert dense(p, x).dtype == torch.float32
    finally:
        matmul.allow_bf16_reduced_precision_reduction = False
    assert dense(p16, x16).dtype == torch.bfloat16
    assert lm_logits(p16, cfg, x16).dtype == torch.float32


# ``tests/test_torch_bf16_params_train.py``'s bounds between two bf16 train
# steps that round differently (there the port's and the reference's; here
# the card's and the CPU's), each step from one state
BF16_LOSS_RTOL = 1e-3
BF16_PARAM_TOL = 5e-3


def _moments(tree):
    """An AdamW moment tree's values, f32 and flat, in ``_paths``'s order of
    the params: an 8-bit ``{"q", "scale"}`` leaf dequantized."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return (tree["q"].float() * tree["scale"]).flatten().cpu()
    if isinstance(tree, dict):
        return torch.cat([_moments(tree[k]) for k in sorted(tree)])
    return tree.float().flatten().cpu()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b"])
def test_bf16_train_steps_on_card_match_cpu(arch, cuda, record_property):
    """Two smoke-size steps on bf16 params with the dry run's train
    settings (``accum_steps=2``, a bf16 buffer, 8-bit moments) on the card,
    each against the same step on the CPU from the card's state before it:
    the f32 loss within BF16_LOSS_RTOL relative, the params within
    BF16_PARAM_TOL normwise and nearer each other than to where the step
    started, as the CPU file holds the port against the reference's step.
    The draw is well scaled before it is rounded to bf16, as there.

    Compared are the elements whose step is bounded: not those whose 8-bit
    second moment reads back 0 beside a first moment that does not (none
    in the first step).  There AdamW, the reference's rule, divides m by
    sqrt(0.05 g^2 / (1 - b2^t)) + eps, so a last-bit difference of a tiny
    g moves the param without limit (at the smoke models' second step a
    fifth of the elements, which move the params by 14-20 times their
    norm).  Each step's distances and the share left out are recorded as
    properties (``--junitxml``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, smoke
    from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, \
        adamw_init, build_train_step, synth_batch
    from repro_torch.training.tree import tree_map

    cfg = smoke(get_config(arch))
    tc = TrainConfig(total_steps=10, peak_lr=1e-3, warmup_steps=2,
                     accum_steps=2, accum_dtype="bfloat16",
                     opt=AdamWConfig(quantize_moments=True))
    params = tree_map(lambda t: t.to(cuda, torch.bfloat16), _well_scaled(
        cfg, init_model(cfg, torch.Generator().manual_seed(0),
                        device="cpu")))
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    step = build_train_step(cfg, tc)

    def flat(tree):
        return torch.cat([t.detach().cpu().double().flatten()
                          for _, t in _paths(tree)])

    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in synth_batch(
            DataConfig(cfg.vocab, 32, 4, seed=3), i).items()}
        cpu_state = tree_map(lambda t: t.to("cpu", copy=True), state)
        before = flat(state["params"])
        unbounded = (_moments(state["opt"]["v"]) == 0) & (
            _moments(state["opt"]["m"]) != 0)
        kept = ~unbounded
        want, wm = step(cpu_state, batch, i)
        state, m = step(state, _to(batch, cuda), i)
        loss, want_loss = float(m["loss"]), float(wm["loss"])
        assert m["loss"].dtype == torch.float32
        assert abs(loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss), i
        got, ref = flat(state["params"]), flat(want["params"])
        assert all(t.dtype == torch.bfloat16
                   for _, t in _paths(state["params"]))
        assert not unbounded.any() or i > 0
        apart = _normwise(got[kept], ref[kept])
        moved = _normwise(got[kept], before[kept])
        record_property(f"step{i}", dict(
            loss_rel=abs(loss - want_loss) / abs(want_loss),
            params_apart=apart, params_moved=moved,
            left_out=float(unbounded.double().mean())))
        assert apart <= BF16_PARAM_TOL and apart < moved, (i, apart)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b"])
def test_bf16_train_steps_on_card_are_bit_stable(arch, cuda):
    """Two runs of two steps from one state on bf16 params with the dry
    run's train settings (``accum_steps=2``, a bf16 buffer, 8-bit
    moments): finite f32 losses, bf16 params, every leaf bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, \
        build_train_step, init_train_state, synth_batch

    cfg = smoke(get_config(arch))
    tc = TrainConfig(total_steps=10, peak_lr=1e-3, warmup_steps=2,
                     accum_steps=2, accum_dtype="bfloat16",
                     opt=AdamWConfig(quantize_moments=True))
    state = init_train_state(cfg, tc, torch.Generator(device=cuda)
                             .manual_seed(0), cuda, dtype=torch.bfloat16)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in synth_batch(
        DataConfig(cfg.vocab, 32, 4, seed=3), i).items()} for i in range(2)]
    step = build_train_step(cfg, tc)
    a, la = _train(step, state, batches)
    b, lb = _train(step, state, batches)
    assert la.dtype == torch.float32 and torch.isfinite(la).all()
    assert torch.equal(la, lb)
    for (k, x), (_, y) in zip(_paths(a), _paths(b)):
        if k.startswith("params/"):
            assert x.dtype == torch.bfloat16, k
        raw = (lambda t: t.view(torch.int16)) \
            if x.dtype == torch.bfloat16 else (lambda t: t)
        assert torch.equal(raw(x), raw(y)), k
