"""A plain PyTorch model of K5's walk (``csrc/bsr_spmm.cu``) and of its
choice of launch shape, for the CPU tests (``test_torch_bsr_layout.py``,
``test_torch_bsr_mma.py``) and the card's (``test_torch_gpu.py``, which
holds :func:`model_layout` to ``kernels.bsr_layout``, the kernel's own
report).  Both bodies: the SIMT one, product by product in the plain
version's order, and the tensor-core one (8x8 blocks on bf16 x), which
pairs a block-row's blocks of a chunk into k16 products and takes a block
left over alone as a k8 one, each MMA modelled as the exact sum of its
products and the accumulator rounded once to f32.  Imports no JAX.
"""

import torch

# the kernel's constants: units (8-row slabs, one a warp) a group, stages
# of x in flight, floats a stage, rows of a slab and kk of a piece
GROUP_UNITS, STAGES, STAGE_FLOATS, SLAB_ROWS = 16, 3, 16384, 8


def model_layout(n_rb, bm, bk, n, batch=1, aligned=True,
                 x_dtype=torch.float32) -> dict:
    """The launch's shape that ``csrc/bsr_spmm.cu`` chooses, with the keys
    of ``kernels.bsr_layout``: a tile of 256 columns (``vec`` 8) on 8x8
    blocks where N is a multiple of 256, 128 (``vec`` 4) on other 8x8
    operands whose row of x is a multiple of 16 bytes (N a multiple of 4
    in f32, of 8 in bf16), x, the blocks and the output 16-byte aligned
    and x with rows; on bf16 x those take the tensor-core body (``mma``
    1, instance ``"mma"``), on f32 x the SIMT one (``"8x8"``); 32 columns
    (``vec`` 1, the generic instance) on any other.  A stage holds
    STAGE_FLOATS floats' bytes of x: twice the rows in bf16."""
    size = torch.empty((), dtype=x_dtype).element_size()
    slabs = -(-bm // SLAB_ROWS)
    groups = -(-(n_rb * slabs) // GROUP_UNITS)
    fixed = bm == 8 and bk == 8 and n * size % 16 == 0 and aligned
    vec = 1 if not fixed else 8 if n % 256 == 0 else 4
    mma = int(fixed and size == 2)
    cols = 32 * vec
    return dict(instance="generic" if vec == 1 else "mma" if mma else "8x8",
                vec=vec, cols=cols,
                chunk=STAGE_FLOATS * 4 // size // cols // bk,
                slabs=slabs, groups=groups,
                ctas=groups * -(-n // cols) * batch,
                group_units=GROUP_UNITS, stages=STAGES, mma=mma)


def mma_parts(blocks: torch.Tensor) -> list:
    """The tensor-core body's bf16 parts of the blocks, in its order of
    passes, widened to f64: (lo, mid, hi) of an f32 weight's split
    (``kernels.split_bf16x3``), the bf16 weight itself otherwise."""
    from repro_torch.kernels import split_bf16x3

    if blocks.dtype == torch.bfloat16:
        return [blocks.double()]
    hi, mid, lo = split_bf16x3(blocks)
    return [lo.double(), mid.double(), hi.double()]


def mma_step(acc, parts, i, nbs, stage_rows):
    """One step of a warp of the tensor-core body: the blocks ``nbs`` (two
    for a k16 product, one for a k8) of block-row ``i`` against their x
    rows ``stage_rows [8 len(nbs), cols]`` (f64), a pass a part, the
    smallest first, a part that is all zeros in these blocks skipped;
    each pass's products summed exactly and added to ``acc`` [8, cols]
    (f32), rounded once."""
    for part in parts:
        w = torch.cat([part[i, nb] for nb in nbs], dim=1)      # [8, 8 k]
        if not w.any() and part is not parts[-1]:
            continue
        acc = (acc.double() + w @ stage_rows).float()
    return acc


def walk_model(block_idx, block_nnz, blocks, xs, *, group=None,
               stage_floats=None, steps=None):
    """out [B, n_rb * bm, N] as the kernel computes it, step by step: on
    the SIMT body bf16 operands widened where they are read and every
    product and sum in f32; on the tensor-core body each step an MMA per
    part (:func:`mma_step`); the f32 sums rounded once to x's dtype where
    they are stored.  ``steps``, a list, receives the tensor-core body's
    steps of the first tile as (block-row, chunk, blocks nb)."""
    n_rb, _, bm, bk = blocks.shape
    batch, k_dim, n = xs.shape
    lay = model_layout(n_rb, bm, bk, n, batch, k_dim > 0, xs.dtype)
    group = group or GROUP_UNITS
    cols = lay["cols"]
    chunk = ((stage_floats or STAGE_FLOATS) * 4 // xs.element_size()
             // cols // bk)
    dtype = xs.dtype
    parts = mma_parts(blocks) if lay["mma"] else None
    blocks, xs = blocks.float(), xs.float()
    slab = SLAB_ROWS
    slabs = lay["slabs"]
    n_units = n_rb * slabs
    idx, nnz = block_idx.tolist(), block_nnz.tolist()
    out = torch.full((batch, n_rb * bm, n), float("nan"))
    for elem in range(batch):
        for col0 in range(0, n, cols):
            # the tile's x: K x its columns, zeros past N
            tile = torch.zeros((k_dim, cols))
            part = xs[elem, :, col0: col0 + cols]
            tile[:, : part.shape[1]] = part
            for u0 in range(0, n_units, group):
                units = range(u0, min(u0 + group, n_units))
                rows = [u // slabs for u in units]
                firsts = [idx[i][0] for i in rows if nnz[i]]
                lasts = [idx[i][nnz[i] - 1] for i in rows if nnz[i]]
                chunks = (range(min(firsts) // chunk, max(lasts) // chunk + 1)
                          if firsts else range(0))
                acc = {u: torch.zeros((slab, cols)) for u in units}
                cursor = {u: 0 for u in units}
                for c in chunks:
                    # the stage: the chunk's rows of the tile, zeros past K
                    stage = torch.zeros((chunk * bk, cols))
                    rows_c = tile[c * chunk * bk: (c + 1) * chunk * bk]
                    stage[: rows_c.shape[0]] = rows_c
                    for u in units:
                        i, s = divmod(u, slabs)
                        if parts is not None:
                            while cursor[u] < nnz[i] and \
                                    idx[i][cursor[u]] < (c + 1) * chunk:
                                nb = cursor[u]
                                pair = nb + 1 < nnz[i] and \
                                    idx[i][nb + 1] < (c + 1) * chunk
                                nbs = (nb, nb + 1) if pair else (nb,)
                                rows_x = torch.cat([stage[
                                    (idx[i][b] - c * chunk) * bk:
                                    (idx[i][b] - c * chunk + 1) * bk]
                                    for b in nbs]).double()
                                acc[u] = mma_step(acc[u], parts, i, nbs,
                                                  rows_x)
                                if steps is not None and elem == 0 \
                                        and col0 == 0:
                                    steps.append((i, c, nbs))
                                cursor[u] += len(nbs)
                            continue
                        while cursor[u] < nnz[i] and \
                                idx[i][cursor[u]] < (c + 1) * chunk:
                            nb = cursor[u]
                            for p in range(-(-bk // slab)):
                                w = torch.zeros((slab, slab))
                                piece = blocks[i, nb, s * slab: (s + 1) * slab,
                                               p * slab: (p + 1) * slab]
                                w[: piece.shape[0], : piece.shape[1]] = piece
                                row0 = (idx[i][nb] - c * chunk) * bk + p * slab
                                for kk in range(min(slab, bk - p * slab)):
                                    acc[u] = acc[u] + w[:, kk, None] \
                                        * stage[None, row0 + kk]
                            cursor[u] += 1
                for u in units:
                    i, s = divmod(u, slabs)
                    r1 = min(slab, bm - s * slab)
                    out[elem, i * bm + s * slab: i * bm + s * slab + r1,
                        col0: col0 + cols] = acc[u][:r1, : n - col0]
    return out.to(dtype)
