"""K5's tensor-core body (8x8 blocks on bf16 x, ``csrc/bsr_spmm.cu``) on the
CPU: the split of an f32 weight into three bf16 parts, the bound that the
body's sums are held to (``kernels.bsr_mma_tolerance``, through
``kernels.bsr_mma_check``), and the walk model's pairing of a block-row's
blocks (``torch_bsr_walk.py``), against the plain version
``bsr_spmm_batched_plain`` and, through it, the JAX package's Pallas kernel
in interpret mode.  The card holds the kernel itself to the same bound
(``test_torch_gpu.py``, ``chip_smoke.py`` phase 10).

Tolerances: the split is exact (checked in f64) where |w| >= 2^-110 or w is
0, within 2^-133 below; integer values are exact in every order (every sum
below 2^24), so the walk equals the plain version there; on real values the
walk is held to the bound, which is derived in ``bsr_mma_tolerance``'s
docstring, not fitted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.bsr_spmm import bsr_spmm as ref_bsr_spmm
from repro_torch import kernels
from repro_torch.kernels.bsr_spmm import SPLIT_EXACT_FROM, U32, bf16_ulp
from torch_bsr_walk import model_layout, walk_model

F32_MAX = float(np.finfo(np.float32).max)


def split_sum(w: torch.Tensor) -> torch.Tensor:
    return sum(p.double() for p in kernels.split_bf16x3(w))


def bsr_operands(n_rb, n_cb, n, *, integer=False, keep=0.3, batch=2,
                 seed=0, w_dtype=torch.float32):
    """BSR operands of a random [8 n_rb, 8 n_cb] weight keeping about
    ``keep`` of its 8x8 blocks, and bf16 xs [batch, 8 n_cb, n]: integer
    values in {-2 ... 2} or normal ones; block-row 1 keeps nothing."""
    rng = np.random.default_rng([seed, n_rb, n_cb, n, integer])
    kept = rng.uniform(size=(n_rb, n_cb)) < keep
    kept[1] = False
    draw = ((lambda s: rng.integers(-2, 3, s)) if integer
            else rng.standard_normal)
    w = (draw((n_rb, 8, n_cb, 8)).astype(np.float32)
         * kept[:, None, :, None]).reshape(n_rb * 8, n_cb * 8)
    ops = tuple(torch.from_numpy(a) for a in kernels.bsr_from_dense(w, 8, 8))
    xs = torch.from_numpy(draw((batch, n_cb * 8, n)).astype(np.float32))
    return w, ops[:2] + (ops[2].to(w_dtype),), xs.bfloat16()


# -- the split -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "integers", "zeros", "near_max",
                                  "tiny", "bf16_exact"])
def test_split_sums_exactly_to_the_weight(kind):
    rng = np.random.default_rng(0)
    w = {"random": rng.standard_normal(4000) * 2.0 ** rng.integers(
             -100, 120, 4000),
         "integers": rng.integers(-2 ** 24, 2 ** 24, 4000),
         "zeros": np.array([0.0, -0.0]),
         "near_max": np.concatenate([[F32_MAX, -F32_MAX],
                                     F32_MAX * rng.uniform(0.5, 1, 500)]),
         "tiny": np.concatenate([
             rng.uniform(1, 2, 500) * 2.0 ** rng.integers(-110, -100, 500),
             [2.0 ** -110, -(2.0 ** -126), 2.0 ** -126 * 1.5]]),
         "bf16_exact": rng.standard_normal(500).astype(np.float32)}[kind]
    w = torch.from_numpy(np.asarray(w, np.float32))
    if kind == "bf16_exact":
        w = w.bfloat16().float()
    hi, mid, lo = kernels.split_bf16x3(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(split_sum(w), w.double())
    # hi is w's word cut to 16 bits: never larger, never of the other sign,
    # so no part overflows; mid is below hi's ulp, lo below mid's
    assert (hi.double().abs() <= w.double().abs()).all()
    assert (hi.double() * w.double() >= 0).all()
    for p in (hi, mid, lo):
        assert torch.isfinite(p).all()
    assert (mid.double().abs() <= bf16_ulp(w) + 0).all()
    if kind == "bf16_exact":
        assert torch.equal(hi.float(), w) and not mid.any() and not lo.any()


def test_split_below_its_floor_and_of_non_finite_weights():
    """Under 2^-110 (and on f32 subnormals) lo drops the bits under bf16's
    least subnormal, 2^-133: the sum is within that, and exact from 2^-110
    up; an infinite or NaN weight keeps its value in hi, zeros in mid and
    lo."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.uniform(1, 2, 2000) * 2.0 ** rng.integers(
        -149, -110, 2000) * rng.choice([-1, 1], 2000)).astype(np.float32))
    w = w[w != 0]
    err = (split_sum(w) - w.double()).abs()
    assert (err < 2.0 ** -133).all() and err.any()
    assert torch.equal(split_sum(w[w.abs() >= SPLIT_EXACT_FROM]),
                       w[w.abs() >= SPLIT_EXACT_FROM].double())
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, mid, lo = kernels.split_bf16x3(special)
    assert torch.equal(hi[:2].float(), special[:2]) and hi[2].isnan()
    assert not mid.any() and not lo.any()


# -- the bound -----------------------------------------------------------------


def plain_in_another_order(ops, xs, dtype=torch.bfloat16):
    """The plain version's products summed exactly (f64) and rounded once
    to f32, then to ``dtype``: the sums in another order."""
    bi, bnnz, blocks = ops
    dense = torch.zeros((bi.shape[0] * 8, xs.shape[1]), dtype=torch.float64)
    for i in range(bi.shape[0]):
        for nb in range(int(bnnz[i])):
            c = int(bi[i, nb]) * 8
            dense[i * 8: i * 8 + 8, c: c + 8] = blocks[i, nb].double()
    return (dense @ xs.double()).float().to(dtype)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_blocks", "bf16_blocks"])
def test_bound_accepts_another_order_and_rejects_past_it(w_dtype):
    w, ops, xs = bsr_operands(12, 40, 48, w_dtype=w_dtype)
    want = kernels.bsr_spmm_batched_plain(*ops, xs)
    other = plain_in_another_order(ops, xs)
    rep = kernels.bsr_mma_check(*ops, xs, other, want)
    assert rep["ok"] and rep["max_err_over_allowed"] <= 1, rep
    # the same on f32 outputs, where no bf16 rounding hides the sums:
    # another order within the bound, and one ulp a product, scaled past
    # the bound's constant, outside it
    want32 = kernels.bsr_spmm_batched_plain(*ops[:2], ops[2], xs.float())
    other32 = plain_in_another_order(ops, xs.float(), torch.float32)
    assert not torch.equal(other32, want32)
    rep = kernels.bsr_mma_check(*ops, xs, other32, want32)
    assert rep["ok"] and 0 < rep["max_err_over_allowed"] <= 1, rep
    sums = kernels.bsr_abs_sums(*ops, xs)
    tol = kernels.bsr_mma_tolerance(*ops, xs, sums)
    n_prod = (ops[1].double() * 8).repeat_interleave(8)[:, None]
    per_product = n_prod * U32 * sums   # one f32 ulp a product, about
    scale = float((tol / per_product).nan_to_num(nan=0).max())
    live = per_product > 0
    for factor, ok in ((0.9, True), (1.1, False)):
        bumped = (want32.double() + factor * scale * per_product).float()
        rep = kernels.bsr_mma_check(*ops, xs, bumped, want32)
        assert rep["ok"] is ok, (factor, rep)
    # on bf16 outputs one ulp of rounding is allowed beside the bound, and
    # the bound plus two ulps is not
    up = (want.double() + bf16_ulp(want)).bfloat16()
    assert kernels.bsr_mma_check(*ops, xs, up, want)["ok"]
    far = (want.double() + torch.where(live, 1.0, 0.0) * (
        tol + 2 * bf16_ulp(want) * 1.01)).bfloat16()
    assert not kernels.bsr_mma_check(*ops, xs, far, want)["ok"]


def test_bound_on_non_finite_values():
    """Where the plain result is not finite the check asks for the same
    value; an infinite x adds nothing to S."""
    _, ops, xs = bsr_operands(4, 6, 16, keep=0.6)
    xs[0, 8 * int(ops[0][0, 0]) + 3, 5] = float("inf")
    want = kernels.bsr_spmm_batched_plain(*ops, xs)
    assert not torch.isfinite(want).all()
    assert torch.isfinite(kernels.bsr_abs_sums(*ops, xs)).all()
    assert kernels.bsr_mma_check(*ops, xs, want.clone(), want)["ok"]
    flipped = torch.where(torch.isinf(want), -want, want)
    assert not kernels.bsr_mma_check(*ops, xs, flipped, want)["ok"]
    nan = torch.where(torch.isinf(want), float("nan"), want.float())
    assert not kernels.bsr_mma_check(*ops, xs, nan.bfloat16(), want)["ok"]


# -- the walk --------------------------------------------------------------------


def expected_steps(bi, bnnz, chunk):
    """(block-row, chunk, blocks) of the tensor-core body's walk: each
    block-row's kept blocks in ascending nb, two at a time where both fall
    in one chunk, else one."""
    steps = []
    for i in range(bi.shape[0]):
        nb = 0
        while nb < int(bnnz[i]):
            c = int(bi[i, nb]) // chunk
            pair = nb + 1 < int(bnnz[i]) and int(bi[i, nb + 1]) // chunk == c
            steps.append((i, c, (nb, nb + 1) if pair else (nb,)))
            nb += 1 + pair
    return steps


@pytest.mark.parametrize("over", [{}, dict(group=5, stage_floats=2048)],
                         ids=["kernel", "small"])
def test_walk_pairs_blocks_within_chunks(over):
    """Which blocks pair into k16 and which take k8: pairs of consecutive
    kept blocks of one chunk, a block left over alone, no pair across a
    chunk's border; every kept block once, in ascending nb."""
    w, ops, xs = bsr_operands(21, 70, 136, keep=0.45)
    steps = []
    walk_model(*ops, xs, steps=steps, **over)
    stage = over.get("stage_floats", 16384)
    chunk = stage * 4 // 2 // 128 // 8
    bi, bnnz, _ = ops
    assert sorted(steps) == sorted(expected_steps(bi, bnnz, chunk))
    by_row = {}
    for i, c, nbs in steps:
        assert all(int(bi[i, nb]) // chunk == c for nb in nbs)
        by_row.setdefault(i, []).extend(nbs)
    for i in range(bi.shape[0]):
        assert by_row.get(i, []) == list(range(int(bnnz[i])))
    singles = [s for s in steps if len(s[2]) == 1]
    pairs = [s for s in steps if len(s[2]) == 2]
    assert singles and pairs
    # a block-row whose run of consecutive block-columns crosses a chunk
    # border: the two blocks beside the border never pair
    borders = [(i, nb) for i in range(bi.shape[0])
               for nb in range(int(bnnz[i]) - 1)
               if int(bi[i, nb]) // chunk != int(bi[i, nb + 1]) // chunk]
    assert borders
    for i, nb in borders:
        assert not any(s[0] == i and s[2] == (nb, nb + 1) for s in pairs)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_blocks", "bf16_blocks"])
@pytest.mark.parametrize("n", [136, 256])
def test_walk_on_integers_equals_plain_and_on_reals_keeps_the_bound(n,
                                                                    w_dtype):
    """N = 136 (128-column tiles, the second 8 wide) and 256 (one
    256-column tile): integer values exact, real values within the
    bound."""
    lay = model_layout(21, 8, 8, n, 2, True, torch.bfloat16)
    assert lay["instance"] == "mma" and lay["cols"] == (128 if n == 136
                                                        else 256)
    for integer in (True, False):
        w, ops, xs = bsr_operands(21, 70, n, integer=integer,
                                  w_dtype=w_dtype)
        want = kernels.bsr_spmm_batched_plain(*ops, xs)
        got = walk_model(*ops, xs, group=5, stage_floats=4096)
        if integer:
            assert torch.equal(got, want)
            exact = torch.from_numpy(w).double() @ xs.double()
            assert torch.equal(got, exact.bfloat16())
        else:
            rep = kernels.bsr_mma_check(*ops, xs, got, want)
            assert rep["ok"], rep


def test_walk_odd_blocks_in_a_chunk_and_pairs_at_its_border():
    """Block-row 0 keeps block-columns 0, 2 and 7 of chunk 0 (a pair, then
    a k8), then 8, 11 and 12 of chunk 1 (a pair, then a k8): 7 and 8, a run
    across the border, never pair; on integer values exact."""
    chunk = 4096 * 4 // 2 // 128 // 8
    assert chunk == 8
    n_cb = 3 * chunk
    w = np.zeros((16, n_cb * 8), np.float32)
    rng = np.random.default_rng(2)
    for c in (0, 2, 7, 8, 11, 12):
        w[:8, c * 8: c * 8 + 8] = rng.integers(1, 3, (8, 8))
    w[8:16, 8: 16] = rng.integers(1, 3, (8, 8))
    ops = tuple(torch.from_numpy(a) for a in kernels.bsr_from_dense(w, 8, 8))
    xs = torch.from_numpy(rng.integers(-2, 3, (1, n_cb * 8, 136)).astype(
        np.float32)).bfloat16()
    steps = []
    got = walk_model(*ops, xs, stage_floats=4096, steps=steps)
    assert [s for s in steps if s[0] == 0] == [
        (0, 0, (0, 1)), (0, 0, (2,)), (0, 1, (3, 4)), (0, 1, (5,))]
    assert [s for s in steps if s[0] == 1] == [(1, 0, (0,))]
    assert torch.equal(got, kernels.bsr_spmm_batched_plain(*ops, xs))


def same_values(a, b) -> bool:
    """Equal element for element, NaN where the other is NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def test_walk_on_an_infinite_x():
    """An infinite x under f32 weights that are bf16-exact: the mid and lo
    passes are skipped (their parts are all zero), so the walk gives the
    plain version's values, infinities and NaNs (0 x inf) alike; where the
    infinity meets a bf16-exact weight in a step whose other weights are
    not, the zero mid part times it gives NaN where the plain version
    gives the infinity (ROADMAP C22)."""
    _, ops, xs = bsr_operands(6, 10, 16, keep=0.7, integer=True)
    xs[0, 8 * int(ops[0][0, 0]) + 2, 3] = float("inf")
    want = kernels.bsr_spmm_batched_plain(*ops, xs)
    assert torch.isinf(want).any()
    got = walk_model(*ops, xs)
    assert same_values(got, want)
    assert kernels.bsr_mma_check(*ops, xs, got, want)["ok"]
    mixed = ops[2] * (1 + 2.0 ** -12)
    mixed[..., 2] = ops[2][..., 2]   # kk 2, under the infinity: bf16-exact
    mixed = ops[:2] + (mixed,)
    got = walk_model(*mixed, xs)
    want = kernels.bsr_spmm_batched_plain(*mixed, xs)
    inf = torch.isinf(want)
    assert inf.any() and torch.isnan(got[inf]).all()
    assert same_values(got[~inf], want[~inf])


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_blocks", "bf16_blocks"])
def test_walk_ties_to_the_reference_kernel(w_dtype):
    """The walk of the tensor-core body against the JAX package's Pallas
    kernel in interpret mode, on the same bf16 operands: within one bf16
    ulp beside the bound (both round f32 sums once), exact on integers."""
    for integer in (True, False):
        w, ops, xs = bsr_operands(6, 12, 16, integer=integer, batch=1,
                                  w_dtype=w_dtype)
        want = np.asarray(ref_bsr_spmm(
            jnp.asarray(ops[0].numpy()), jnp.asarray(ops[1].numpy()),
            jnp.asarray(ops[2].float().numpy(),
                        jnp.bfloat16 if w_dtype == torch.bfloat16
                        else jnp.float32),
            jnp.asarray(xs[0].float().numpy(), jnp.bfloat16), bn=16))
        want = torch.from_numpy(want.astype(np.float32)).bfloat16()[None]
        got = walk_model(*ops, xs)
        if integer:
            assert torch.equal(got, want)
        else:
            assert kernels.bsr_mma_check(*ops, xs, got, want)["ok"]


def test_layout_takes_the_tensor_cores_on_bf16_x_only():
    bf16 = dict(x_dtype=torch.bfloat16)
    for n, f32_inst, bf16_inst in ((2048, "8x8", "mma"), (136, "8x8", "mma"),
                                   (128, "8x8", "mma"),
                                   (132, "8x8", "generic"),
                                   (130, "generic", "generic")):
        assert model_layout(3072, 8, 8, n)["instance"] == f32_inst
        assert model_layout(3072, 8, 8, n, **bf16)["instance"] == bf16_inst
        assert model_layout(3072, 8, 8, n)["mma"] == 0
    assert model_layout(3072, 8, 8, 2048, aligned=False, **bf16)[
        "instance"] == "generic"
    assert model_layout(3072, 16, 16, 2048, **bf16)["instance"] == "generic"
    lay = model_layout(3072, 8, 8, 2048, **bf16)
    assert (lay["cols"], lay["chunk"], lay["ctas"]) == (256, 16, 192 * 8)
