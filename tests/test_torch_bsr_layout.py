"""K5's walk on the CPU: a plain PyTorch model of how ``csrc/bsr_spmm.cu``
visits the products (CTAs of ``GROUP_UNITS`` 8-row units x a column tile,
K in ascending chunks of whole block-columns, a cursor per unit into its
block-row's kept blocks, an 8-row register tile a lane, 8 x 8 weight
pieces) must equal the plain version ``bsr_spmm_batched_plain`` bit for
bit, and through it tie to the JAX package's Pallas kernel in interpret
mode.  The kernel's order rests on each block-row's live ``block_idx``
ascending strictly, so ``bsr_from_dense`` (the port's and the reference's)
is held to that too.

The model (``torch_bsr_walk.py``) takes the launch's shape from its model
of the choice that ``csrc/bsr_spmm.cu`` makes (``kernels.bsr_layout``
reports the kernel's own; ``tests/test_torch_gpu.py`` holds the two equal
on the card) and, where a case asks, smaller groups and stages than the
kernel's, so that small operands cross many group and chunk borders: the
walk keeps the plain version's order under any of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.bsr_spmm import bsr_from_dense as ref_bsr_from_dense
from repro.kernels.bsr_spmm import bsr_spmm as ref_bsr_spmm
from repro_torch import kernels
from repro_torch.models import prune_blocks
from test_torch_bsr import sweep_operands
from torch_bsr_walk import model_layout, walk_model

BSR_TOL = 1e-5   # the reference sums a block's bk products in one f32 dot


def operands(n_rb, n_cb, bm, bk, n, batch, *, integer=False, keep=0.3,
             seed=0, empty_rows=()):
    """Numpy BSR operands of a random [n_rb bm, n_cb bk] weight keeping
    about ``keep`` of its blocks (block-rows ``empty_rows`` keep none) and
    xs [batch, K, N], integer-valued in {-2 ... 2} or normal."""
    rng = np.random.default_rng([seed, n_rb, n_cb, bm, bk, n])
    kept = rng.uniform(size=(n_rb, n_cb)) < keep
    kept[list(empty_rows)] = False
    draw = ((lambda s: rng.integers(-2, 3, s)) if integer
            else rng.standard_normal)
    w = draw((n_rb, bm, n_cb, bk)).astype(np.float32)
    w[w == 0] = 1.0   # no kept block is all zero
    w = (w * kept[:, None, :, None]).reshape(n_rb * bm, n_cb * bk)
    xs = draw((batch, n_cb * bk, n)).astype(np.float32)
    return w, xs


def port_ops(w, bm, bk):
    return tuple(torch.from_numpy(a)
                 for a in kernels.bsr_from_dense(w, bm, bk))


# (n_rb, n_cb, bm, bk, N, B, model overrides): the 8x8 instances (256
# columns a tile, or 128) and the
# generic one, with groups and stages small enough that the walk crosses
# several group and chunk borders and block-rows' runs are cut by chunks
CASES = {
    "8x8_256_cols": (21, 40, 8, 8, 256, 2, dict(group=5, stage_floats=8192)),
    "8x8_n128_batch3": (70, 24, 8, 8, 128, 3,
                        dict(group=4, stage_floats=4096)),
    "8x8_128_cols": (37, 70, 8, 8, 136, 2, {}),
    "8x8_n200": (20, 33, 8, 8, 200, 1, dict(group=3)),
    "8x8_n_odd": (19, 33, 8, 8, 130, 2, dict(group=6, stage_floats=2048)),
    "8x16": (19, 40, 8, 16, 72, 2, dict(group=7, stage_floats=2048)),
    "16x16": (11, 40, 16, 16, 40, 2, dict(group=3, stage_floats=2048)),
    "3x5": (30, 60, 3, 5, 33, 2, dict(group=5, stage_floats=640)),
    "12x20": (13, 30, 12, 20, 48, 1, dict(group=4, stage_floats=1280)),
}


@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_model_equals_the_plain_version(case, integer):
    n_rb, n_cb, bm, bk, n, batch, over = CASES[case]
    w, xs = operands(n_rb, n_cb, bm, bk, n, batch, integer=integer,
                     empty_rows=(1, 2, n_rb - 1))
    ops = port_ops(w, bm, bk)
    xs = torch.from_numpy(xs)
    want = kernels.bsr_spmm_batched_plain(*ops, xs)
    for kw in ({}, over):
        got = walk_model(*ops, xs, **kw)
        assert torch.equal(got, want), kw
    if integer:   # every sum exact in f32: the f64 product
        assert torch.equal(want.double(), torch.from_numpy(w).double() @
                           xs.double())


def test_walk_model_cuts_runs_at_chunk_borders():
    """The walk of "8x8_256_cols" under its overrides really crosses group
    and chunk borders inside block-rows' runs of kept blocks, with groups
    holding empty block-rows and n_rb not a multiple of the group."""
    n_rb, n_cb, bm, bk, n, batch, over = CASES["8x8_256_cols"]
    w, _ = operands(n_rb, n_cb, bm, bk, n, batch, empty_rows=(1, 2, 20))
    bi, bnnz, _ = kernels.bsr_from_dense(w, bm, bk)
    chunk = over["stage_floats"] // 256 // bk
    assert chunk == 4 and n_rb % over["group"] and not bnnz[[1, 2, 20]].any()
    runs = [bi[i, : bnnz[i]] // chunk for i in range(n_rb)]
    assert sum(len(set(r.tolist())) > 1 for r in runs) >= n_rb - 3


def test_layout_mirrors_the_kernels_choices():
    lay = model_layout
    assert lay(3072, 8, 8, 2048)["vec"] == 8 and \
        lay(3072, 8, 8, 2048)["chunk"] == 8
    assert lay(3072, 8, 8, 128, 8)["vec"] == 4 and \
        lay(3072, 8, 8, 128, 8)["ctas"] == 192 * 8    # a tile an element
    assert lay(20, 8, 8, 130)["instance"] == "generic"
    assert lay(20, 8, 8, 128, aligned=False)["instance"] == "generic"
    assert lay(11, 16, 16, 40)["slabs"] == 2
    assert lay(3072, 8, 8, 2048)["ctas"] == 192 * 8
    assert lay(18, 8, 256, 32)["chunk"] >= 1


@pytest.mark.parametrize("values", ["real", "int"])
@pytest.mark.parametrize("bm,bk,bn", [(8, 8, 8), (8, 16, 32), (16, 16, 16)])
def test_walk_model_ties_to_the_reference_kernel(bm, bk, bn, values):
    """The JAX package's sweep operands (``test_torch_bsr.py``): the walk
    against the Pallas kernel in interpret mode, exact on integers."""
    w, x = sweep_operands(bm, bk, bn, values)
    bi, bnnz, blocks = ref_bsr_from_dense(w, bm, bk)
    want = np.asarray(ref_bsr_spmm(jnp.asarray(bi), jnp.asarray(bnnz),
                                   jnp.asarray(blocks), jnp.asarray(x),
                                   bn=bn))
    got = walk_model(*port_ops(w, bm, bk), torch.from_numpy(x)[None],
                     group=2, stage_floats=1024)[0].numpy()
    if values == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=BSR_TOL, atol=BSR_TOL)


def edge_weights():
    """The K5 edge cases' weights of ``chip_smoke.py`` (all-empty, empty
    block-rows, one long block-row, 8x16 and 16x16 blocks) and random
    pruned ones, as (label, w, bm, bk)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((192, 320)).astype(np.float32)
    empty_rows = w.copy()
    empty_rows[16:48] *= 1e-3
    long_row = np.zeros_like(w)
    long_row[8:16] = w[8:16]
    long_row[100:108, :16] = w[100:108, :16]
    yield "all_empty", np.zeros_like(w), 8, 8
    yield "empty_block_rows", prune_blocks(empty_rows, 8, 8, 0.3)[0], 8, 8
    yield "max_nb_padding", long_row, 8, 8
    yield "blocks_8x16", prune_blocks(w, 8, 16, 0.4)[0], 8, 16
    yield "blocks_16x16", prune_blocks(w, 16, 16, 0.4)[0], 16, 16
    for seed, keep in ((1, 0.1), (2, 0.25), (3, 0.6)):
        r = np.random.default_rng(seed).standard_normal((256, 512))
        yield f"pruned_{keep}", prune_blocks(r, 8, 8, keep)[0], 8, 8


@pytest.mark.parametrize("case", [c[0] for c in edge_weights()])
def test_bsr_from_dense_gives_strictly_ascending_block_columns(case):
    _, w, bm, bk = next(c for c in edge_weights() if c[0] == case)
    for convert in (kernels.bsr_from_dense, ref_bsr_from_dense):
        bi, bnnz, _ = convert(w, bm, bk)
        for i in range(bi.shape[0]):
            live = bi[i, : bnnz[i]]
            assert (np.diff(live) > 0).all(), (convert.__module__, i)
            assert (live < w.shape[1] // bk).all()
