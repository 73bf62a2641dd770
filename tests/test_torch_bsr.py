"""K5 and K5-b, the padded-BSR × dense kernel and its batched form: the
port's host converter and wrappers against the JAX package's
``repro.kernels.bsr_spmm`` (its Pallas kernel in interpret mode, as the JAX
package's own tests run it), its vmapped form, and its einsum oracle
``bsr_spmm_ref``, on the same operands made with numpy from a seed.

The port's wrappers get CPU tensors, so they run their plain versions (the
CUDA kernel is held against them on the card, in test_torch_gpu.py and
chip_smoke.py).  Structure (``block_idx``, ``block_nnz``, ``blocks``) must be
bit-identical.  Real values agree within BSR_TOL = 1e-5 relative and
absolute: the reference sums each block's ``bk`` products in one f32 dot and
the blocks one after another, the port one product at a time, so the two
may round differently in the last places; integer values leave no rounding
and agree exactly.  The batched plain version's slice b equals the
unbatched one on activation set b bit for bit (one body).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.bsr_spmm import bsr_from_dense as ref_bsr_from_dense
from repro.kernels.bsr_spmm import bsr_spmm as ref_bsr_spmm
from repro.kernels.ref import bsr_spmm_ref as ref_bsr_spmm_ref
from repro_torch import kernels
from repro_torch.kernels.ref import bsr_spmm_ref

BSR_TOL = 1e-5

#: (bm, bk, bn) of the JAX package's kernel sweep (tests/test_kernels.py)
SWEEP = [(8, 8, 8), (8, 16, 32), (16, 16, 16)]


def sweep_operands(bm, bk, bn, values="real"):
    """The JAX package's sweep operands: a [6 bm, 5 bk] weight with about
    half its blocks knocked out and x [5 bk, 3 bn], both from the sweep's
    seed; ``values="int"`` rounds both to integers in [-3, 3]."""
    rng = np.random.default_rng(bm * bk)
    mdim, kdim, ndim = bm * 6, bk * 5, bn * 3
    w = rng.normal(size=(mdim, kdim)).astype(np.float32)
    for i in range(0, mdim, bm):
        for j in range(0, kdim, bk):
            if rng.uniform() < 0.5:
                w[i: i + bm, j: j + bk] = 0
    x = rng.normal(size=(kdim, ndim)).astype(np.float32)
    if values == "int":
        w = np.clip(np.round(w * 2), -3, 3).astype(np.float32)
        x = np.clip(np.round(x * 2), -3, 3).astype(np.float32)
    return w, x


def structure_cases(bm, bk):
    """Dense weights for the converter: about half the blocks empty, an
    all-zero block-row, and integer weights whose blocks tie in magnitude."""
    rng = np.random.default_rng(bm + 7 * bk)
    w, _ = sweep_operands(bm, bk, 8)
    zero_row = w.copy()
    zero_row[bm: 2 * bm] = 0.0
    zero_row[-bm:] = 0.0
    ties = rng.integers(-2, 3, size=(bm * 4, bk * 6)).astype(np.float32)
    ties[:, :bk] = 0.0
    return {"half_blocks": w, "zero_rows": zero_row, "ties": ties}


def port_bsr(w, bm, bk):
    return tuple(torch.from_numpy(a) for a in
                 kernels.bsr_from_dense(w, bm, bk))


@pytest.mark.parametrize("case", ["half_blocks", "zero_rows", "ties"])
@pytest.mark.parametrize("bm,bk", [(8, 8), (8, 16), (16, 16)])
def test_bsr_from_dense_is_the_references(bm, bk, case):
    w = structure_cases(bm, bk)[case]
    got = kernels.bsr_from_dense(w, bm, bk)
    want = ref_bsr_from_dense(w, bm, bk)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    if case == "zero_rows":
        assert got[1][1] == 0 and got[1][-1] == 0


def test_bsr_from_dense_rejects_a_ragged_weight():
    with pytest.raises(ValueError, match="blocks"):
        kernels.bsr_from_dense(np.ones((12, 16), np.float32), 8, 8)


@pytest.mark.parametrize("values", ["real", "int"])
@pytest.mark.parametrize("bm,bk,bn", SWEEP)
def test_bsr_plain_matches_the_reference_kernel(bm, bk, bn, values):
    w, x = sweep_operands(bm, bk, bn, values)
    bi, bnnz, blocks = ref_bsr_from_dense(w, bm, bk)
    want = np.asarray(ref_bsr_spmm(jnp.asarray(bi), jnp.asarray(bnnz),
                                   jnp.asarray(blocks), jnp.asarray(x),
                                   bn=bn))
    oracle = np.asarray(ref_bsr_spmm_ref(jnp.asarray(bi), jnp.asarray(bnnz),
                                         jnp.asarray(blocks), jnp.asarray(x)))
    ops = port_bsr(w, bm, bk)
    got = kernels.bsr_spmm(*ops, torch.from_numpy(x), bn=bn)
    assert got.shape == (w.shape[0], x.shape[1]) and got.dtype == torch.float32
    assert torch.equal(got, kernels.bsr_spmm_plain(*ops, torch.from_numpy(x)))
    if values == "int":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), w @ x)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=BSR_TOL,
                                   atol=BSR_TOL)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=BSR_TOL,
                                   atol=BSR_TOL)


@pytest.mark.parametrize("bm,bk,bn", SWEEP)
def test_port_oracle_matches_the_references(bm, bk, bn):
    w, x = sweep_operands(bm, bk, bn)
    bi, bnnz, blocks = ref_bsr_from_dense(w, bm, bk)
    want = np.asarray(ref_bsr_spmm_ref(jnp.asarray(bi), jnp.asarray(bnnz),
                                       jnp.asarray(blocks), jnp.asarray(x)))
    got = bsr_spmm_ref(*port_bsr(w, bm, bk), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=BSR_TOL, atol=BSR_TOL)


def test_bsr_empty_rows():
    """The JAX package's empty-row case: one kept block, every other
    block-row empty, which must come out as zeros."""
    w = np.zeros((16, 16), np.float32)
    w[:8, :8] = 1.0
    x = np.ones((16, 8), np.float32)
    bi, bnnz, blocks = ref_bsr_from_dense(w, 8, 8)
    want = np.asarray(ref_bsr_spmm(jnp.asarray(bi), jnp.asarray(bnnz),
                                   jnp.asarray(blocks), jnp.asarray(x), bn=8))
    got = kernels.bsr_spmm(*port_bsr(w, 8, 8), torch.from_numpy(x), bn=8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w @ x)
    assert not got[8:].any()


@pytest.mark.parametrize("values", ["real", "int"])
@pytest.mark.parametrize("bm,bk,bn", SWEEP)
def test_bsr_batched_plain_matches_the_vmapped_reference(bm, bk, bn, values):
    w, _ = sweep_operands(bm, bk, bn, values)
    rng = np.random.default_rng(bm * bk + 1)
    xs = rng.normal(size=(3, w.shape[1], bn * 2)).astype(np.float32)
    if values == "int":
        xs = np.clip(np.round(xs * 2), -3, 3).astype(np.float32)
    bi, bnnz, blocks = (jnp.asarray(a) for a in ref_bsr_from_dense(w, bm, bk))
    want = np.asarray(jax.vmap(lambda x: ref_bsr_spmm(
        bi, bnnz, blocks, x, bn=bn))(jnp.asarray(xs)))
    ops = port_bsr(w, bm, bk)
    got = kernels.bsr_spmm_batched(*ops, torch.from_numpy(xs), bn=bn)
    assert got.shape == (3, w.shape[0], xs.shape[2])
    if values == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=BSR_TOL,
                                   atol=BSR_TOL)
    for b in range(3):
        assert torch.equal(got[b], kernels.bsr_spmm(
            *ops, torch.from_numpy(xs[b]), bn=bn))


def test_plain_version_skips_padded_blocks():
    """Padded slots hold garbage here: the plain version never reads them
    (a NaN weight or an out-of-range index past block_nnz changes
    nothing), as the kernel never does."""
    w, x = sweep_operands(8, 8, 8)
    bi, bnnz, blocks = (a.clone() for a in port_bsr(w, 8, 8))
    want = kernels.bsr_spmm_plain(bi, bnnz, blocks, torch.from_numpy(x))
    max_nb = bi.shape[1]
    pad = torch.arange(max_nb)[None, :] >= bnnz[:, None]
    assert pad.any()
    blocks[pad] = float("nan")
    bi[pad] = 10_000
    got = kernels.bsr_spmm_plain(bi, bnnz, blocks, torch.from_numpy(x))
    assert torch.equal(got, want)


def _ops():
    w, x = sweep_operands(8, 8, 8)
    return port_bsr(w, 8, 8), torch.from_numpy(x)


def test_n_not_a_multiple_of_bn_raises():
    ops, x = _ops()
    with pytest.raises(ValueError, match="multiple of bn"):
        kernels.bsr_spmm(*ops, x, bn=16)
    with pytest.raises(ValueError, match="multiple of bn"):
        kernels.bsr_spmm_batched(*ops, x[None].contiguous(), bn=16)


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "shape", "x_rows",
                                 "contiguous", "x_dims", "batch_dims",
                                 "empty_batch", "wide_block"])
def test_wrapper_rejects_bad_operands(bad):
    (bi, bnnz, blocks), x = _ops()
    xs = x[None].contiguous()
    fn, args = kernels.bsr_spmm, [bi, bnnz, blocks, x]
    if bad == "dtype":
        args[3] = x.double()
    elif bad == "index_dtype":
        args[0] = bi.long()
    elif bad == "shape":
        args[1] = bnnz[:-1]
    elif bad == "x_rows":
        args[3] = x[:-1]
    elif bad == "contiguous":
        args[3] = torch.cat([x, x], 1)[:, ::2]
    elif bad == "x_dims":
        args[3] = xs
    elif bad == "batch_dims":
        fn, args[3] = kernels.bsr_spmm_batched, x
    elif bad == "empty_batch":
        fn, args[3] = kernels.bsr_spmm_batched, xs[:0]
    else:
        args[2] = torch.zeros(blocks.shape[:2] + (8, 512))
    with pytest.raises((TypeError, ValueError)):
        fn(*args, bn=8)


def test_cpu_wrappers_count_no_launches():
    ops, x = _ops()
    before = (kernels.bsr_spmm.n_launches, kernels.bsr_spmm_batched.n_launches)
    kernels.bsr_spmm(*ops, x, bn=8)
    kernels.bsr_spmm_batched(*ops, x[None].contiguous(), bn=8)
    assert (kernels.bsr_spmm.n_launches,
            kernels.bsr_spmm_batched.n_launches) == before
    counts = kernels.launch_counts()
    assert "bsr_spmm" in counts and "bsr_spmm_batched" in counts
