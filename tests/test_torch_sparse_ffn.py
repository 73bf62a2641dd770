"""The sparse FFN serving policy (``repro_torch.models.sparse_ffn``) against
the JAX package's (``repro.models.sparse_ffn``), and the model pieces it
stands on (configs, parameter tables, the dense SwiGLU ``ffn``).

Weights and activations are made with numpy from a seed and handed to both
packages; the port runs on the CPU (the BSR kernel's plain version; its
CUDA kernel is held against that on the card in test_torch_gpu.py and
chip_smoke.py), the reference's BSR kernel in interpret mode, as its own
tests run it.  Pruning, tie handling, the policy switch and the BSR
structure must be bit-identical.  Values agree within FFN_TOL = 1e-5
relative and absolute: the two packages sum a dot product in different
orders (XLA's dot, the port's one product at a time on the BSR path,
torch's matmul on the dense path) and compute SiLU through different
formulas, so they may round differently in the last places.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models.config import smoke as ref_smoke
from repro.models.layers import ffn as ref_ffn
from repro.models.sparse_ffn import SparseFFN as RefSparseFFN
from repro.models.sparse_ffn import SparseMatmul as RefSparseMatmul
from repro_torch import kernels
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import ffn_params_from_reference, \
    sparse_matmul_from_reference
from repro_torch.models import Leaf, SparseFFN, SparseMatmul, ffn, \
    ffn_table, init_params, prune_blocks, smoke

FFN_TOL = 1e-5
KEEPS = (0.9, 0.5, 0.25)
CFG = smoke(ARCHS["granite-20b"])          # d_model 128, d_ff 256


def ffn_params(seed=0, d=CFG.d_model, f=CFG.d_ff):
    """numpy FFN params in ``ffn_table``'s orientation, ``fan_in`` scale."""
    rng = np.random.default_rng(seed)
    return {name: {"w": (rng.normal(size=shape) / np.sqrt(shape[0]))
                   .astype(np.float32)}
            for name, shape in (("gate", (d, f)), ("up", (d, f)),
                                ("down", (f, d)))}


def weight(kind, seed=0, shape=(64, 96)):
    rng = np.random.default_rng(seed)
    if kind == "real":
        return rng.normal(size=shape).astype(np.float32)
    # integer weights: nearly every 8x8 block's max magnitude is 2, so the
    # threshold falls inside a run of ties
    return rng.integers(-2, 3, size=shape).astype(np.float32)


def port_matmul(ref):
    """The port's SparseMatmul of a reference one, through convert.py."""
    return sparse_matmul_from_reference(
        ref.path, None if ref.dense_w is None else np.asarray(ref.dense_w),
        *(None if a is None else np.asarray(a)
          for a in (ref.block_idx, ref.block_nnz, ref.blocks)),
        ref.shape, ref.density, device="cpu")


def assert_same_structure(got: SparseMatmul, want: RefSparseMatmul):
    assert got.path == want.path
    assert got.shape == tuple(want.shape)
    assert got.density == want.density
    if want.path == "dense":
        np.testing.assert_array_equal(got.dense_w.numpy(),
                                      np.asarray(want.dense_w))
        return
    for f in ("block_idx", "block_nnz", "blocks"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


# -- configs, params, layers -------------------------------------------------


def test_granite_config_is_the_references():
    want = REF_ARCHS["granite-20b"]
    assert dataclasses.asdict(get_config("granite-20b")) \
        == dataclasses.asdict(want)
    assert dataclasses.asdict(CFG) == dataclasses.asdict(ref_smoke(want))
    assert (CFG.d_model, CFG.d_ff) == (128, 256)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_init_params_draws_from_the_generator():
    table = ffn_table(CFG)
    table["bias"] = {"z": Leaf((4,), ("mlp",), "zeros"),
                     "o": Leaf((4,), ("mlp",), "ones"),
                     "n": Leaf((256, 32), ("a", "b"), "normal:0.5")}
    p = init_params(table, torch.Generator().manual_seed(3), device="cpu")
    q = init_params(table, torch.Generator().manual_seed(3), device="cpu")
    for name in ("gate", "up", "down"):
        w = p[name]["w"]
        assert w.shape == table[name]["w"].shape and w.dtype == torch.float32
        assert torch.equal(w, q[name]["w"])
        # fan_in: std 1 / sqrt(d_in)
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.05
    assert not torch.equal(p["gate"]["w"], p["up"]["w"])
    assert torch.equal(p["bias"]["z"], torch.zeros(4))
    assert torch.equal(p["bias"]["o"], torch.ones(4))
    assert abs(float(p["bias"]["n"].std()) - 0.5) < 0.05
    with pytest.raises(ValueError):
        Leaf((4, 4), ("a",))


def test_dense_ffn_matches_the_reference():
    p = ffn_params(1)
    x = np.random.default_rng(2).normal(size=(2, 6, CFG.d_model)).astype(
        np.float32)
    want = np.asarray(ref_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x)))
    got = ffn(ffn_params_from_reference(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=FFN_TOL, atol=FFN_TOL)


# -- SparseMatmul: pruning, structure, policy ---------------------------------


@pytest.mark.parametrize("kind", ["real", "ties"])
@pytest.mark.parametrize("keep", [0.9, 0.5, 0.2])
@pytest.mark.parametrize("bm,bk", [(8, 8), (8, 16), (16, 16)])
def test_from_dense_is_the_references(bm, bk, keep, kind):
    w = weight(kind, seed=bm + bk)
    got = SparseMatmul.from_dense(w, bm=bm, bk=bk, keep_density=keep,
                                  t_density=0.75, device="cpu")
    want = RefSparseMatmul.from_dense(w, bm=bm, bk=bk, keep_density=keep,
                                      t_density=0.75)
    assert_same_structure(got, want)
    assert got.flops_per_col == want.flops_per_col


def test_ties_at_the_threshold_are_all_kept():
    w = weight("ties")
    m = SparseMatmul.from_dense(w, keep_density=0.2, t_density=0.99,
                                device="cpu")
    assert m.density == 1.0 and m.path == "dense"
    pruned, density = prune_blocks(w, 8, 8, 0.2)
    assert density == 1.0
    np.testing.assert_array_equal(pruned, w)


def test_zero_blocks_make_zero_block_rows():
    """A weight whose pruned form leaves whole block-rows empty: those rows
    hold no blocks and come out as zeros."""
    w = weight("real")
    w[8:24] *= 1e-3
    m = SparseMatmul.from_dense(w, keep_density=0.25, t_density=0.75,
                                device="cpu")
    want = RefSparseMatmul.from_dense(w, keep_density=0.25, t_density=0.75)
    assert_same_structure(m, want)
    assert m.path == "bsr" and not m.block_nnz[1:3].any()
    x = torch.from_numpy(np.ones((96, 8), np.float32))
    assert not m(x)[8:24].any()


def test_policy_switches_on_density():
    w = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    dense_m = SparseMatmul.from_dense(w, keep_density=0.9, t_density=0.75,
                                      device="cpu")
    sparse_m = SparseMatmul.from_dense(w, keep_density=0.2, t_density=0.75,
                                       device="cpu")
    assert dense_m.path == "dense"       # >= t stays on the SPA-analogue path
    assert sparse_m.path == "bsr"        # < t switches to the sparse kernel
    assert sparse_m.density <= 0.25
    for path in ("dense", "bsr"):
        forced = SparseMatmul.from_dense(w, keep_density=0.5, path=path,
                                         device="cpu")
        assert forced.path == path


@pytest.mark.parametrize("keep", [0.9, 0.2])
def test_sparse_matmul_matches_the_reference(keep):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    x = rng.normal(size=(48, 16)).astype(np.float32)
    ref = RefSparseMatmul.from_dense(w, keep_density=keep, t_density=0.75)
    want = np.asarray(ref(jnp.asarray(x), bn=16))
    pruned, _ = prune_blocks(w, 8, 8, keep)
    for m in (SparseMatmul.from_dense(w, keep_density=keep, t_density=0.75,
                                      device="cpu"), port_matmul(ref)):
        assert_same_structure(m, ref)
        got = m(torch.from_numpy(x), bn=16).numpy()
        np.testing.assert_allclose(got, want, rtol=FFN_TOL, atol=FFN_TOL)
        np.testing.assert_allclose(got, pruned @ x, rtol=FFN_TOL,
                                   atol=FFN_TOL)


def test_from_reference_rejects_bad_bsr_arrays():
    ref = RefSparseMatmul.from_dense(weight("real"), keep_density=0.2)
    bi, bn, blk = (np.asarray(a) for a in (ref.block_idx, ref.block_nnz,
                                           ref.blocks))
    bad_idx = bi.copy()
    bad_idx[np.argmax(bn), 0] = 12             # a kept block; n_cb = 96 / 8
    for args in ((bad_idx, bn, blk, ref.shape),
                 (bi, bn + bi.shape[1], blk, ref.shape),
                 (bi, bn, blk, (72, 96))):
        with pytest.raises(ValueError, match="BSR arrays"):
            sparse_matmul_from_reference("bsr", None, *args, ref.density,
                                         device="cpu")


def test_bsr_path_n_not_a_multiple_of_bn_raises():
    m = SparseMatmul.from_dense(weight("real"), keep_density=0.2,
                                device="cpu")
    x = torch.zeros((96, 200))          # bn = min(128, 200) = 128
    with pytest.raises(ValueError, match="multiple of bn"):
        m(x)
    with pytest.raises(ValueError, match="multiple of bn"):
        m.batched(x[None].contiguous())


def test_sparse_matmul_batched_matches_loop():
    """F-ref-2's twin.  One launch over [B, K, N] against the per-sample
    loop: on the BSR path both are the kernel's one body (the batch a grid
    axis), so they agree bit for bit; on the dense path the batched call is
    one broadcast matmul and the loop B matmuls, which a BLAS may block and
    sum in different orders, so they are held to FFN_TOL only (the JAX
    package's twin differs by 5.7e-6 there)."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    xs = torch.from_numpy(rng.normal(size=(3, 48, 16)).astype(np.float32))
    for keep, path in ((0.9, "dense"), (0.2, "bsr")):
        m = SparseMatmul.from_dense(w, bm=8, bk=8, keep_density=keep,
                                    t_density=0.75, device="cpu")
        assert m.path == path
        got = m.batched(xs, bn=16)
        want = torch.stack([m(xs[b], bn=16) for b in range(3)])
        if path == "bsr":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=FFN_TOL, atol=FFN_TOL)


# -- SparseFFN ---------------------------------------------------------------


@pytest.mark.parametrize("keep", KEEPS)
def test_sparse_ffn_matches_the_reference(keep):
    """smoke(granite-20b) widths; forward on [T, D] and on [B, T, D]
    against the reference SparseFFN and against the dense ffn on the pruned
    weights."""
    p = ffn_params(3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, CFG.d_model)).astype(np.float32)
    xs = rng.normal(size=(2, 8, CFG.d_model)).astype(np.float32)
    ref = RefSparseFFN.from_params(jax.tree_util.tree_map(jnp.asarray, p),
                                   keep_density=keep, t_density=0.75)
    sp = SparseFFN.from_params(ffn_params_from_reference(p, device="cpu"),
                               keep_density=keep, t_density=0.75,
                               device="cpu")
    for name in ("gate", "up", "down"):
        assert_same_structure(getattr(sp, name), getattr(ref, name))
    assert sp.flops_per_token == ref.flops_per_token
    pruned = {name: {"w": torch.from_numpy(prune_blocks(
        p[name]["w"].T, 8, 8, keep)[0].T.copy())}
        for name in ("gate", "up", "down")}
    for inp in (x, xs):
        want = np.asarray(ref(jnp.asarray(inp)))
        got = sp(torch.from_numpy(inp))
        assert got.shape == inp.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=FFN_TOL,
                                   atol=FFN_TOL)
        np.testing.assert_allclose(
            got.numpy(), ffn(pruned, torch.from_numpy(inp)).numpy(),
            rtol=FFN_TOL, atol=FFN_TOL)


def test_sparse_ffn_paths_and_launch_free_cpu_run():
    sp = SparseFFN.from_params(ffn_params(5), keep_density=0.25,
                               t_density=0.75, device="cpu")
    dense = SparseFFN.from_params(ffn_params(5), keep_density=0.9,
                                  t_density=0.75, device="cpu")
    assert {m.path for m in (sp.gate, sp.up, sp.down)} == {"bsr"}
    assert {m.path for m in (dense.gate, dense.up, dense.down)} == {"dense"}
    kernels.reset_launch_counts()
    sp(torch.zeros((2, 8, CFG.d_model)))
    assert set(kernels.launch_counts().values()) == {0}


def test_sparse_ffn_batched_matches_loop():
    sp = SparseFFN.from_params(ffn_params(6), keep_density=0.3,
                               t_density=0.75, device="cpu")
    xs = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 6, CFG.d_model)).astype(np.float32))
    got = sp(xs)
    want = torch.stack([sp(xs[b]) for b in range(2)])
    assert got.shape == (2, 6, CFG.d_model)
    assert torch.equal(got, want)


def test_sparse_ffn_flop_savings_monotone():
    p = ffn_params_from_reference(ffn_params(8), device="cpu")
    prev = None
    for keep in (0.8, 0.4, 0.2):
        sp = SparseFFN.from_params(p, keep_density=keep, t_density=0.9,
                                   device="cpu")
        f = sp.flops_per_token
        if prev is not None:
            assert f < prev
        prev = f
        y = sp(torch.randn(8, CFG.d_model))
        assert y.shape == (8, CFG.d_model) and torch.isfinite(y).all()


def test_entry_points_without_device_need_a_card():
    """device=None means the card: with none present, conversion raises
    before any pruning, as init_params does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseMatmul.from_dense(weight("real"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseFFN.from_params(ffn_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(ffn_table(CFG), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ffn_params_from_reference(ffn_params())
