"""K5 and K5-b on bf16 operands, and the sparse FFN on bf16 activations: the
port's dtype contract against the JAX package's (its Pallas ``bsr_spmm`` in
interpret mode, as ``tests/test_kernels.py`` runs it, and its
``SparseMatmul`` / ``SparseFFN``), on operands made with numpy from a seed.

The contract is the reference's: ``blocks`` and ``x`` each f32 or bf16, the
sums in f32, the result in x's dtype.  The port's wrappers get CPU tensors,
so they run their plain versions (the CUDA kernel is held against those on
the card in test_torch_gpu.py and chip_smoke.py).  Tolerances:

- a bf16 result within one bf16 ulp of the reference's, element for
  element: the two f32 sums differ only by reassociation (the reference
  sums a block's bk products in one dot, the port one product at a time),
  and each is rounded once; an f32 result within BSR_TOL, as in
  test_torch_bsr.py;
- integer values exact: every product and sum is exact in f32, so the
  result is the f64 product rounded once to x's dtype;
- the model side within MODEL_TOL = 1e-2 normwise: on the bsr path the
  matmuls' bf16 results, SiLU and the gating product each round to bf16
  (about 2^-9 relative a step), in other places in the two frameworks.
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.bsr_spmm import bsr_from_dense as ref_bsr_from_dense
from repro.kernels.bsr_spmm import bsr_spmm as ref_bsr_spmm
from repro.models.sparse_ffn import SparseFFN as RefSparseFFN
from repro.models.sparse_ffn import SparseMatmul as RefSparseMatmul
from repro_torch import kernels
from repro_torch.convert import bf16_from_reference, \
    ffn_params_from_reference, sparse_matmul_from_reference
from repro_torch.models import SparseFFN, SparseMatmul, prune_blocks
from test_torch_bsr import SWEEP, sweep_operands
from torch_bsr_walk import model_layout, walk_model
from torch_parity import bf16_to_reference

BSR_TOL = 1e-5
MODEL_TOL = 1e-2
F32, BF16 = "float32", "bfloat16"
#: (blocks, x) dtype pairs of the contract
PAIRS = [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)]
JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
TORCH = {F32: torch.float32, BF16: torch.bfloat16}


def port_tensor(a, dtype):
    """A numpy f32 array as the port's tensor of ``dtype`` on the CPU, the
    bf16 one through the reference's own bf16 array (``convert``)."""
    if dtype == BF16:
        return bf16_from_reference(np.asarray(a).astype(ml_dtypes.bfloat16),
                                   device="cpu")
    return torch.from_numpy(np.array(a, np.float32))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |v| (8 significant bits); the smallest normal's
    below it."""
    mag = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def reference_bsr(w, x, bm, bk, bn, w_dtype, x_dtype):
    bi, bnnz, blocks = ref_bsr_from_dense(w, bm, bk)
    return bi, bnnz, blocks, ref_bsr_spmm(
        jnp.asarray(bi), jnp.asarray(bnnz),
        jnp.asarray(blocks, JNP[w_dtype]), jnp.asarray(x, JNP[x_dtype]),
        bn=bn)


# -- K5 and K5-b against the reference's Pallas kernel -----------------------


@pytest.mark.parametrize("values", ["real", "int"])
@pytest.mark.parametrize("w_dtype,x_dtype", PAIRS)
@pytest.mark.parametrize("bm,bk,bn", SWEEP)
def test_bsr_plain_matches_the_reference_kernel_in_each_dtype(
        bm, bk, bn, w_dtype, x_dtype, values):
    w, x = sweep_operands(bm, bk, bn, values)
    bi, bnnz, blocks, want = reference_bsr(w, x, bm, bk, bn, w_dtype,
                                           x_dtype)
    got = kernels.bsr_spmm(torch.from_numpy(bi), torch.from_numpy(bnnz),
                           port_tensor(blocks, w_dtype),
                           port_tensor(x, x_dtype), bn=bn)
    want = np.asarray(want)
    assert got.dtype == TORCH[x_dtype] and want.dtype.name == x_dtype
    g = got.float().numpy()
    w_ = want.astype(np.float32)
    if values == "int":   # exact sums: the f64 product rounded once
        np.testing.assert_array_equal(g, w_)
        exact = torch.from_numpy(w).double() @ torch.from_numpy(x).double()
        assert torch.equal(got, exact.to(TORCH[x_dtype]))
    elif x_dtype == BF16:
        diff = np.abs(g.astype(np.float64) - w_)
        assert (diff <= bf16_ulp(np.maximum(np.abs(g), np.abs(w_)))).all()
    else:
        np.testing.assert_allclose(g, w_, rtol=BSR_TOL, atol=BSR_TOL)


@pytest.mark.parametrize("values", ["real", "int"])
@pytest.mark.parametrize("w_dtype,x_dtype", PAIRS[1:])
@pytest.mark.parametrize("bm,bk,bn", SWEEP)
def test_bsr_batched_equals_looped_in_each_dtype(bm, bk, bn, w_dtype,
                                                 x_dtype, values):
    w, x = sweep_operands(bm, bk, bn, values)
    rng = np.random.default_rng(bm + bk + bn)
    xs = np.stack([x, rng.permutation(x), -x]).astype(np.float32)
    ops = tuple(torch.from_numpy(a) for a in kernels.bsr_from_dense(w, bm, bk))
    ops = ops[:2] + (ops[2].to(TORCH[w_dtype]),)
    xs = port_tensor(xs, x_dtype)
    got = kernels.bsr_spmm_batched(*ops, xs, bn=bn)
    assert got.dtype == TORCH[x_dtype]
    for b in range(xs.shape[0]):
        assert torch.equal(got[b], kernels.bsr_spmm(*ops, xs[b], bn=bn))
    # the widened operands give the same f32 sums: rounding them once to
    # x's dtype is the bf16 result
    wide = kernels.bsr_spmm_batched(*ops[:2], ops[2].float(), xs.float(),
                                    bn=bn)
    assert torch.equal(got, wide.to(TORCH[x_dtype]))


@pytest.mark.parametrize("w_dtype", [F32, BF16])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("n", [132, 136])
def test_walk_model_equals_the_plain_version_on_bf16_x(n, integer, w_dtype):
    """K5's walk on bf16 x at N = 132 (aligned for f32, not for bf16: the
    generic instance, 32 columns a tile, bit for bit) and N = 136 (128
    columns a tile: the tensor-core body on bf16 x, within its bound of
    the plain version, exact on integers), its stages holding twice the
    rows of f32's."""
    rng = np.random.default_rng([n, integer])
    n_rb, n_cb = 21, 70
    kept = rng.uniform(size=(n_rb, n_cb)) < 0.3
    kept[[1, 2]] = False
    draw = ((lambda s: rng.integers(-2, 3, s)) if integer
            else rng.standard_normal)
    w = (draw((n_rb, 8, n_cb, 8)).astype(np.float32)
         * kept[:, None, :, None]).reshape(n_rb * 8, n_cb * 8)
    xs = port_tensor(draw((2, n_cb * 8, n)).astype(np.float32), BF16)
    ops = tuple(torch.from_numpy(a) for a in kernels.bsr_from_dense(w, 8, 8))
    ops = ops[:2] + (ops[2].to(TORCH[w_dtype]),)
    lay = model_layout(n_rb, 8, 8, n, 2, True, torch.bfloat16)
    assert lay["instance"] == ("generic" if n == 132 else "mma")
    want = kernels.bsr_spmm_batched_plain(*ops, xs)
    assert want.dtype == torch.bfloat16
    for kw in ({}, dict(group=5, stage_floats=2048)):
        got = walk_model(*ops, xs, **kw)
        if n == 132 or integer:
            assert torch.equal(got, want), kw
        else:
            assert kernels.bsr_mma_check(*ops, xs, got, want)["ok"], kw
    if integer:
        exact = torch.from_numpy(w).double() @ xs.double()
        assert torch.equal(want, exact.bfloat16())


def test_layout_of_bf16_x():
    """A bf16 row must be a multiple of 16 bytes for the 8x8 instances (N a
    multiple of 8, where f32 needs 4), and a stage holds twice the rows."""
    bf16 = dict(x_dtype=torch.bfloat16)
    for n, f32_vec, bf16_vec in ((2048, 8, 8), (128, 4, 4), (136, 4, 4),
                                 (132, 4, 1), (130, 1, 1)):
        assert model_layout(3072, 8, 8, n)["vec"] == f32_vec
        assert model_layout(3072, 8, 8, n, **bf16)["vec"] == bf16_vec
    assert model_layout(3072, 8, 8, 2048, **bf16)["chunk"] == 16   # f32 8
    assert model_layout(3072, 8, 8, 128, 8, **bf16)["chunk"] == 32  # 16
    assert model_layout(3072, 8, 8, 128, 8, **bf16)["ctas"] == 192 * 8
    assert model_layout(18, 8, 256, 32, **bf16)["chunk"] == 4       # 2


@pytest.mark.parametrize("bad", ["f16_x", "f16_blocks", "f64_blocks",
                                 "bf16_index"])
def test_wrapper_rejects_other_value_dtypes(bad):
    w, x = sweep_operands(8, 8, 8)
    bi, bnnz, blocks = (torch.from_numpy(a)
                        for a in kernels.bsr_from_dense(w, 8, 8))
    x = torch.from_numpy(x)
    args = {"f16_x": (bi, bnnz, blocks, x.half()),
            "f16_blocks": (bi, bnnz, blocks.half(), x),
            "f64_blocks": (bi, bnnz, blocks.double(), x),
            "bf16_index": (bi.bfloat16(), bnnz, blocks, x)}[bad]
    with pytest.raises(TypeError, match="must be"):
        kernels.bsr_spmm(*args, bn=8)
    with pytest.raises(TypeError, match="must be"):
        kernels.bsr_spmm_batched(*args[:3], args[3][None].contiguous(), bn=8)


def test_cpu_wrappers_count_no_bf16_launches():
    w, x = sweep_operands(8, 8, 8)
    ops = tuple(torch.from_numpy(a) for a in kernels.bsr_from_dense(w, 8, 8))
    xb = torch.from_numpy(x).bfloat16()
    kernels.reset_launch_counts()
    kernels.bsr_spmm(*ops, xb, bn=8)
    kernels.bsr_spmm_batched(*ops, xb[None].contiguous(), bn=8)
    counts = kernels.launch_counts()
    assert counts["bsr_spmm_bf16"] == counts["bsr_spmm_batched_bf16"] == 0
    assert set(counts.values()) == {0}


# -- the bf16 carry and the host conversion -----------------------------------


def test_bf16_from_reference_carries_every_value():
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -30, 30, 500), [0.0, -0.0, np.inf, -np.inf, 3.0e38, 1e-40]])
    ref = jnp.asarray(a, jnp.bfloat16)
    t = bf16_from_reference(np.asarray(ref), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(ref).astype(np.float32))
    back = bf16_to_reference(t)
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16),
                                  np.asarray(ref).view(np.uint16))


@pytest.mark.parametrize("keep", [0.9, 0.25])
def test_from_dense_takes_a_bf16_weight(keep):
    """``_host`` widens a bf16 tensor: ``prune_blocks``, ``from_dense``,
    ``from_shared_pattern`` and ``SparseFFN.from_params`` on bf16 weights
    equal the same calls on their f32 widening, and the reference's on the
    same bf16 array."""
    rng = np.random.default_rng(4)
    wb = torch.from_numpy(rng.normal(size=(64, 96)).astype(
        np.float32)).bfloat16()
    wide = wb.float().numpy()
    for path in (None, "spgemm"):
        got = SparseMatmul.from_dense(wb, keep_density=keep, path=path,
                                      device="cpu")
        want = SparseMatmul.from_dense(wide, keep_density=keep, path=path,
                                       device="cpu")
        assert (got.path, got.density) == (want.path, want.density)
        for f in ("dense_w", "block_idx", "block_nnz", "blocks"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None and w is None) or torch.equal(g, w), f
        if path == "spgemm":
            assert torch.equal(got.w_values, want.w_values)
    ref = RefSparseMatmul.from_dense(bf16_to_reference(wb),
                                     keep_density=keep)
    got = SparseMatmul.from_dense(wb, keep_density=keep, device="cpu")
    assert got.density == ref.density
    field = "dense_w" if got.path == "dense" else "blocks"
    np.testing.assert_array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(ref, field)))
    pruned, density = prune_blocks(wb, 8, 8, keep)
    assert (pruned.dtype, density) == (np.float32, got.density)
    np.testing.assert_array_equal(pruned, prune_blocks(wide, 8, 8, keep)[0])
    stack = torch.stack([wb, -wb])
    got_m, got_v = SparseMatmul.from_shared_pattern(
        stack, keep_density=keep, device="cpu")
    want_m, want_v = SparseMatmul.from_shared_pattern(
        stack.float().numpy(), keep_density=keep, device="cpu")
    assert torch.equal(got_v, want_v) and got_m.density == want_m.density
    p = {name: {"w": w} for name, w in (("gate", wb.T), ("up", -wb.T),
                                        ("down", wb))}
    sp = SparseFFN.from_params(p, keep_density=keep, device="cpu")
    sp32 = SparseFFN.from_params(
        {k: {"w": v["w"].float()} for k, v in p.items()},
        keep_density=keep, device="cpu")
    for name in ("gate", "up", "down"):
        a, b = getattr(sp, name), getattr(sp32, name)
        assert a.path == b.path and a.density == b.density
        assert torch.equal(*((a.dense_w, b.dense_w) if a.path == "dense"
                             else (a.blocks, b.blocks)))


# -- SparseMatmul and SparseFFN on bf16 activations ---------------------------


D, F = 32, 64   # the FFN's widths (blocks of 8: 4 and 8 block-rows)


def port_matmul(ref):
    """The port's SparseMatmul of a reference one, through convert.py."""
    if ref.path == "spgemm":
        c = ref.w_csc
        return sparse_matmul_from_reference(
            "spgemm", None, None, None, None, c.shape, ref.density, "cpu",
            w_csc=(np.asarray(c.values), np.asarray(c.row_indices),
                   np.asarray(c.col_ptr)))
    return sparse_matmul_from_reference(
        ref.path, None if ref.dense_w is None else np.asarray(ref.dense_w),
        *(None if a is None else np.asarray(a)
          for a in (ref.block_idx, ref.block_nnz, ref.blocks)),
        ref.shape, ref.density, device="cpu")


def rel_err(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.asarray(want).astype(np.float64))
    return float((got.double() - want).norm() / want.norm())


def bf16_pair(shape, seed):
    """A bf16 activation as the reference's array and the port's tensor."""
    a = np.random.default_rng(seed).normal(size=shape).astype(
        ml_dtypes.bfloat16)
    return jnp.asarray(a), bf16_from_reference(a, device="cpu")


@pytest.mark.parametrize("case", [(0.9, None), (0.25, None), (0.3, "spgemm")],
                         ids=["dense", "bsr", "spgemm"])
def test_sparse_matmul_on_bf16_x_matches_the_reference(case):
    keep, path = case
    w = np.random.default_rng(5).normal(size=(F, D)).astype(np.float32)
    ref = RefSparseMatmul.from_dense(w, keep_density=keep, path=path)
    m = port_matmul(ref)
    assert m.path == (path or ("dense" if keep > 0.75 else "bsr"))
    x_ref, x = bf16_pair((D, 16), 6)
    xs_ref, xs = bf16_pair((3, D, 16), 7)
    for got, want in ((m(x), ref(x_ref)), (m.batched(xs), ref.batched(xs_ref))):
        assert str(got.dtype).split(".")[-1] == want.dtype.name
        assert rel_err(got, np.asarray(want, np.float32)) <= MODEL_TOL


def ffn_pair(case):
    """(reference SparseFFN, the port's) at smoke widths D x F: one
    keep_density for all three matrices, mixed densities (gate dense, up
    and down bsr; gate and up bsr, down dense), or the spgemm path."""
    rng = np.random.default_rng(8)
    p = {name: {"w": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)}
         for name, s in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}
    if case in ("mixed_gate", "mixed_down"):
        keeps = (dict(gate=0.9, up=0.25, down=0.25) if case == "mixed_gate"
                 else dict(gate=0.25, up=0.25, down=0.9))
        ref = RefSparseFFN(*(RefSparseMatmul.from_dense(
            p[name]["w"].T, keep_density=keeps[name])
            for name in ("gate", "up", "down")))
        port = SparseFFN(*(port_matmul(getattr(ref, name))
                           for name in ("gate", "up", "down")))
        return ref, port
    keep, path = {"dense": (0.9, None), "bsr": (0.25, None),
                  "spgemm": (0.3, "spgemm")}[case]
    ref = RefSparseFFN.from_params(jax.tree_util.tree_map(jnp.asarray, p),
                                   keep_density=keep, path=path)
    port = SparseFFN.from_params(ffn_params_from_reference(p, device="cpu"),
                                 keep_density=keep, path=path, device="cpu")
    return ref, port


@pytest.mark.parametrize("case", ["dense", "bsr", "mixed_gate", "mixed_down",
                                  "spgemm"])
def test_sparse_ffn_on_bf16_activations_matches_the_reference(case):
    """[T, D] and [B, T, D] bf16: the result's dtype is the reference's
    (bf16 on an all-bsr FFN, f32 wherever an f32 matmul result enters) and
    its values within MODEL_TOL normwise."""
    ref, sp = ffn_pair(case)
    paths = {m.path for m in (sp.gate, sp.up, sp.down)}
    assert paths == {"dense": {"dense"}, "bsr": {"bsr"},
                     "spgemm": {"spgemm"}}.get(case, {"dense", "bsr"})
    x_ref, x = bf16_pair((16, D), 9)
    xs_ref, xs = bf16_pair((2, 8, D), 10)
    for got, want in ((sp(x), ref(x_ref)), (sp(xs), ref(xs_ref))):
        assert got.shape == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == want.dtype.name
        assert got.dtype == (torch.bfloat16 if case == "bsr"
                             else torch.float32)
        assert rel_err(got, np.asarray(want, np.float32)) <= MODEL_TOL
    if case == "spgemm":
        got = sp.apply(sp.trainable_params(), x)
        want = ref.apply(ref.trainable_params(), x_ref)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        assert rel_err(got, want) <= MODEL_TOL
