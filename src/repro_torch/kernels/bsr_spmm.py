"""K5: padded-BSR × dense (``csrc/bsr_spmm.cu``), and the host converter.

The counterpart of the JAX package's Pallas BSR kernel
(``repro/kernels/bsr_spmm.py::bsr_spmm``) and of its vmapped form in
``repro/models/sparse_ffn.py`` (``SparseMatmul.batched``, K5-b): a weight in
padded BSR (``block_idx [n_rb, max_nb]`` int32, ``block_nnz [n_rb]`` int32,
``blocks [n_rb, max_nb, bm, bk]``) times dense activations ``x [K, N]``
(``[B, K, N]`` batched) gives ``[n_rb * bm, N]`` (``[B, n_rb * bm, N]``).
The reference's dtype contract: ``blocks`` and ``x`` each f32 or bf16, the
sums in f32 and the result in x's dtype, rounded once.  On a CUDA tensor
the wrappers launch the hand-written kernel (a CTA a group of 16
block-rows x a column tile x a batch element, x staged in shared memory
chunk by chunk; :func:`bsr_layout` reports the launch's shape) or raise; on
a CPU tensor they run :func:`bsr_spmm_batched_plain`.  The kernel has two
bodies.  8x8 blocks on bf16 x (the sparse FFN's bf16 path) run on the
tensor cores (``instance "mma"``): the exact products of two bf16 values
(an f32 weight as the exact sum of three bf16 parts,
:func:`split_bf16x3`), summed in the MMA's order, so they agree with the
plain version within :func:`bsr_mma_tolerance` (:func:`bsr_mma_check`) and
not bit for bit.  Every other operand (f32 x, any other block shape)
runs the SIMT body, whose products and sums are the plain version's, bit
for bit.  :func:`bsr_from_dense` is the reference's host converter, copied
(less its ``threshold``, which no caller sets).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_batch, check_tensors, \
    stream_handle

#: the largest bk: a stage of the generic instance holds at least 256 rows
#: of x, one block-column of 256
MAX_BK = 256
#: columns are int32 on the card, a column tile of 256 past N included
MAX_COLS = 2**31 - 1 - 256
#: the keys of :func:`bsr_layout`, in ``repro_bsr_layout``'s order
LAYOUT_KEYS = ("vec", "chunk", "slabs", "groups", "ctas", "group_units",
               "stages", "mma")
#: the value dtypes the kernel takes, and their codes in its C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bsr_layout(n_rb: int, bm: int, bk: int, n: int, batch: int = 1,
               aligned: bool = True, x_dtype=torch.float32) -> dict:
    """The launch's shape as ``csrc/bsr_spmm.cu`` chooses it (its
    ``repro_bsr_layout``; this builds the kernel library): the instance
    (``"mma"``, the tensor-core body on 8x8 blocks and bf16 x; ``"8x8"``,
    the SIMT body on 8x8 blocks and f32 x; ``"generic"``, the SIMT body on
    any other operands), a tile's columns / 32 (``vec``) and its columns
    (``cols``), block-columns a chunk, units (8-row slabs) a block-row,
    groups, CTAs (groups x column tiles x batch elements), units a group,
    stages of x in flight and ``mma`` (1 for the tensor-core body).
    ``aligned``: x has rows, and x, the blocks and the output start on 16
    bytes.  ``x_dtype``: x's (and the output's) dtype; a bf16 row must be a
    multiple of 16 bytes for the 8x8 instances too (N a multiple of 8), and
    a stage holds twice the rows."""
    out = (ctypes.c_longlong * len(LAYOUT_KEYS))()
    _build.library().repro_bsr_layout(n_rb, bm, bk, n, batch, int(aligned),
                                      ctypes.addressof(out),
                                      DTYPE_CODES[x_dtype])
    lay = dict(zip(LAYOUT_KEYS, out))
    instance = ("generic" if lay["vec"] == 1 else "mma" if lay["mma"]
                else "8x8")
    return dict(instance=instance, cols=32 * lay["vec"], **lay)


def _check(block_idx, block_nnz, blocks, x, bn, device,
           batched: bool = False) -> torch.device:
    named = dict(block_idx=block_idx, block_nnz=block_nnz, blocks=blocks, x=x)
    dev = check_tensors(named, lambda name: name in ("blocks", "x"), device,
                        value_dtypes=tuple(DTYPE_CODES))
    if block_idx.dim() != 2 or blocks.dim() != 4 \
            or tuple(blocks.shape[:2]) != tuple(block_idx.shape) \
            or tuple(block_nnz.shape) != tuple(block_idx.shape[:1]):
        raise ValueError(
            f"BSR operand shapes {tuple(block_idx.shape)}, "
            f"{tuple(block_nnz.shape)}, {tuple(blocks.shape)} are not "
            "[n_rb, max_nb], [n_rb], [n_rb, max_nb, bm, bk]")
    bm, bk = blocks.shape[2:]
    if not 1 <= bk <= MAX_BK or bm < 1:
        raise ValueError(f"blocks of {bm}x{bk}: the kernel takes bm >= 1 and "
                         f"1 <= bk <= {MAX_BK}")
    want = 3 if batched else 2
    if x.dim() != want:
        raise ValueError(f"x must be {'[B, K, N]' if batched else '[K, N]'}"
                         f", got shape {tuple(x.shape)}")
    if batched:
        check_batch(x.shape[0])
    k_dim, n = x.shape[-2:]
    if k_dim % bk:
        raise ValueError(f"x has K = {k_dim} rows, not a multiple of bk = "
                         f"{bk}")
    if bn < 1 or n % bn:
        raise ValueError(f"N = {n} columns is not a multiple of bn = {bn}")
    if n > MAX_COLS:
        raise ValueError(f"N = {n} columns: one launch takes at most "
                         f"{MAX_COLS}")
    return dev


def _launch(block_idx, block_nnz, blocks, xs, dev) -> torch.Tensor:
    """``out [B, n_rb * bm, N]`` in xs's dtype for the ``B = xs.shape[0]``
    activation sets ``xs``, one K5 launch if there is any output."""
    n_rb, max_nb, bm, bk = blocks.shape
    batch, k_dim, n = xs.shape
    out = torch.empty((batch, n_rb * bm, n), dtype=xs.dtype, device=dev)
    if out.numel():
        _build.launch(
            "repro_bsr_launch", block_idx.data_ptr(), block_nnz.data_ptr(),
            blocks.data_ptr(), n_rb, max_nb, bm, bk, xs.data_ptr(), k_dim, n,
            batch, out.data_ptr(), stream_handle(dev),
            DTYPE_CODES[blocks.dtype], DTYPE_CODES[xs.dtype])
    return out


def _count(wrapper, blocks, x, out) -> None:
    """One launch more on ``wrapper`` if ``out`` had any element, and on
    its bf16 count too if either value operand is bf16."""
    launched = out.numel() > 0
    wrapper.n_launches += launched
    wrapper.n_launches_bf16 += launched and torch.bfloat16 in (blocks.dtype,
                                                               x.dtype)


def bsr_spmm(block_idx, block_nnz, blocks, x, *, bn: int = 128,
             device=None) -> torch.Tensor:
    """``[n_rb * bm, N]`` = BSR(A) @ x for ``x [K, N]``, in x's dtype.

    ``blocks`` and ``x`` are each f32 or bf16 (the reference's contract:
    the sums are f32, a bf16 result is rounded once).

    ``N`` must be a multiple of ``bn`` (the reference's contract; the
    kernel's own tile is 256, 128 or 32 columns, masked at the edge:
    :func:`bsr_layout`).  The BSR indices come from :func:`bsr_from_dense`
    and are trusted (the card does not check them): every
    ``block_idx[i, nb] * bk + bk <= K`` for ``nb < block_nnz[i] <=
    max_nb``, and each block-row's live ``block_idx[i, :block_nnz[i]]`` is
    strictly ascending.  The kernel walks K in ascending chunks, each
    block-row's blocks in the chunk they fall in, so that order is what
    keeps the SIMT body's products in the plain version's order (and the
    tensor-core body's pairs of blocks within a chunk).  Operands that
    break either rule give undefined results on the card (wrong values,
    not an error; the plain version, on the CPU, still sums every live
    block).  On 8x8 blocks and bf16 x the card's result is within
    :func:`bsr_mma_tolerance` of the plain version's, not bit for bit.
    ``device``, when given, is where the operands must lie.
    """
    dev = _check(block_idx, block_nnz, blocks, x, bn, device)
    if dev.type == "cpu":
        return bsr_spmm_plain(block_idx, block_nnz, blocks, x)
    out = _launch(block_idx, block_nnz, blocks, x[None], dev)
    _count(bsr_spmm, blocks, x, out)
    return out[0]


bsr_spmm.n_launches = 0
#: the launches with a bf16 operand, counted in ``n_launches`` too
bsr_spmm.n_launches_bf16 = 0


def bsr_spmm_batched(block_idx, block_nnz, blocks, xs, *, bn: int = 128,
                     device=None) -> torch.Tensor:
    """``[B, n_rb * bm, N]`` for B activation sets ``xs [B, K, N]`` against
    one BSR weight, in one launch: slice b is :func:`bsr_spmm` of
    ``xs[b]``, bit for bit."""
    dev = _check(block_idx, block_nnz, blocks, xs, bn, device, batched=True)
    if dev.type == "cpu":
        return bsr_spmm_batched_plain(block_idx, block_nnz, blocks, xs)
    out = _launch(block_idx, block_nnz, blocks, xs, dev)
    _count(bsr_spmm_batched, blocks, xs, out)
    return out


bsr_spmm_batched.n_launches = 0
bsr_spmm_batched.n_launches_bf16 = 0


def bsr_spmm_plain(block_idx, block_nnz, blocks, x) -> torch.Tensor:
    """The kernel's plain PyTorch version for one activation set."""
    return bsr_spmm_batched_plain(block_idx, block_nnz, blocks, x[None])[0]


def bsr_spmm_batched_plain(block_idx, block_nnz, blocks, xs) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the SIMT body's per-element
    order.

    Step (nb, kk) adds ``blocks[i, nb, :, kk] * x[block_idx[i, nb] * bk +
    kk]`` into every block-row i with ``nb < block_nnz[i]``, vectorized over
    those block-rows, the rows of the block, the columns and the batch; the
    steps run nb outer, kk inner, so each output element sums its products
    from 0 in the kernel's order.  Padded blocks are never touched.
    Block-rows are visited most-blocks first, so the live ones at step nb
    are a prefix.  bf16 operands are widened to f32 first (exact), and the
    f32 result is rounded once to x's dtype, as the kernel does.
    """
    batch, _, n = xs.shape
    n_rb, _, bm, bk = blocks.shape
    dtype = xs.dtype
    blocks, xs = blocks.float(), xs.float()
    out = torch.zeros((batch, n_rb, bm, n), dtype=torch.float32,
                      device=xs.device)
    if n_rb:
        nnz_sorted, order = torch.sort(block_nnz.long(), descending=True,
                                       stable=True)
        counts = nnz_sorted.cpu()
        n_steps = int(counts[0])
        # live[nb] = number of block-rows with more than nb blocks
        live = torch.searchsorted(-counts, -torch.arange(n_steps),
                                  right=False).tolist()
        for nb in range(n_steps):
            rows = order[: live[nb]]
            x_row = block_idx[rows, nb].long() * bk          # [n_live]
            w = blocks[rows, nb]                              # [n_live, bm, bk]
            acc = out[:, rows]                                # [B, n_live, bm, N]
            for kk in range(bk):
                acc = acc + w[None, :, :, kk, None] * xs[:, x_row + kk, None]
            out[:, rows] = acc
    return out.reshape(batch, n_rb * bm, n).to(dtype)


def bsr_from_dense(w, bm: int, bk: int):
    """Host-side converter: dense [M, K] -> padded BSR, dropping all-zero
    blocks. Returns (block_idx, block_nnz, blocks) as numpy arrays."""
    w = np.asarray(w)
    m, k = w.shape
    if m % bm or k % bk:
        raise ValueError(f"a {w.shape} weight does not split into {bm}x{bk} "
                         "blocks")
    n_rb, n_cb = m // bm, k // bk
    tiles = w.reshape(n_rb, bm, n_cb, bk).transpose(0, 2, 1, 3)
    keep = np.abs(tiles).max(axis=(2, 3)) > 0.0             # [n_rb, n_cb]
    max_nb = max(int(keep.sum(1).max()), 1)
    block_idx = np.zeros((n_rb, max_nb), np.int32)
    block_nnz = keep.sum(1).astype(np.int32)
    blocks = np.zeros((n_rb, max_nb, bm, bk), w.dtype)
    for i in range(n_rb):
        cols = np.nonzero(keep[i])[0]
        block_idx[i, : len(cols)] = cols
        blocks[i, : len(cols)] = tiles[i, cols]
    return block_idx, block_nnz, blocks


# -- the tensor-core body's numbers ------------------------------------------

#: f32's unit roundoff, and its least subnormal
U32, F32_TINY = 2.0 ** -24, 2.0 ** -149
#: the least |w| whose three bf16 parts sum to it exactly: below it, lo
#: drops the bits under bf16's least subnormal, 2^-133
SPLIT_EXACT_FROM = 2.0 ** -110


def split_bf16x3(w: torch.Tensor):
    """The tensor-core body's split of f32 weights (``split3`` in
    ``csrc/bsr_spmm.cu``), as three bf16 tensors (hi, mid, lo): hi the top
    16 bits of w's word (a truncation: no part overflows), mid the top 16
    of r = w - hi (exact in f32) and lo = r - mid (exact in f32, at most 8
    significant bits), so hi + mid + lo == w exactly where |w| >=
    SPLIT_EXACT_FROM or w == 0, and within 2^-133 below.  An infinite or
    NaN weight keeps its value in hi and zeros in mid and lo."""
    w = w.float().contiguous()
    top = -65536   # 0xffff0000 as an int32

    def trunc(v):
        return (v.view(torch.int32) & top).view(torch.float32)

    hi = trunc(w)
    r = w - hi
    mid = trunc(r)
    lo = trunc(r - mid)
    special = ~torch.isfinite(w)
    zero = torch.zeros_like(w)
    hi = torch.where(special, w, hi)
    mid, lo = torch.where(special, zero, mid), torch.where(special, zero, lo)
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def bsr_abs_sums(block_idx, block_nnz, blocks, xs) -> torch.Tensor:
    """S = |W| |x| in f64, ``[B, n_rb * bm, N]`` on xs's device: each
    element's sum of |w| |x| over its products (the kept blocks'), with an
    f32 block's |w| raised to SPLIT_EXACT_FROM (what its split may drop is
    then within 2u of each term) and an infinite or NaN x counted as 0
    (where one reaches a product the plain result is not finite and
    :func:`bsr_mma_check` asks for the same value)."""
    batch, k_dim, n = xs.shape
    n_rb, max_nb, bm, bk = blocks.shape
    dev = xs.device
    live = (torch.arange(max_nb, device=block_nnz.device)[None]
            < block_nnz[:, None])
    rows, nbs = live.nonzero(as_tuple=True)
    w = blocks[rows, nbs].to(dev, torch.float64).abs()
    if blocks.dtype == torch.float32:
        w = w.clamp_min(SPLIT_EXACT_FROM)
    dense = torch.zeros((n_rb, k_dim // bk, bm, bk), dtype=torch.float64,
                        device=dev)
    dense[rows.to(dev), block_idx[rows, nbs].long().to(dev)] = w
    dense = dense.permute(0, 2, 1, 3).reshape(n_rb * bm, k_dim)
    ax = xs.double().abs()
    ax = torch.where(torch.isfinite(ax), ax, torch.zeros_like(ax))
    return dense @ ax


def bsr_mma_tolerance(block_idx, block_nnz, blocks, xs, sums=None):
    """The most that the tensor-core body's f32 sum of an element may
    differ from the plain version's, ``[B, n_rb * bm, N]`` f64: with n the
    element's products (bk a kept block), P its parts a weight (3 for f32
    blocks, 1 for bf16), m = P n the products the MMAs sum and S̃ =
    :func:`bsr_abs_sums`,

        (5m/2 + n + 2) * 1.01 * 2^-24 * S̃ + (2m + n) * 2^-149.

    Derived, not fitted: an MMA's products are exact; it aligns its terms
    (the accumulator and its k products) to the largest and keeps at least
    24 bits of each, then truncates the sum to f32 (published measurements
    of Volta to Hopper), so each of its k + 1 terms and its result is off
    by less than 2^-23 (2u, twice f32's rounding, for truncation) of the
    running sum of |terms| <= S̃.  With one hardware step for every 4
    products at least (k16 may run as several), the kernel's sum is within
    2u (m + m/4) S̃ of the exact sum of its parts' products, which is
    within 2u S̃ of the exact sum (the split's floor); the plain
    version's sequential f32 sum is within n u S / (1 - n u) of it.  The
    1.01 covers the higher-order terms while 3 n u <= 0.01 (n <= 55,924);
    the last term covers underflow, 2^-149 a step of either sum."""
    if sums is None:
        sums = bsr_abs_sums(block_idx, block_nnz, blocks, xs)
    bm, bk = blocks.shape[2:]
    n_prod = (block_nnz.to(sums.device, torch.float64) * bk).repeat_interleave(
        bm)[:, None]
    m = (3 if blocks.dtype == torch.float32 else 1) * n_prod
    return ((2.5 * m + n_prod + 2) * 1.01 * U32 * sums
            + (2 * m + n_prod) * F32_TINY)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (8 significant bits), f64; bf16's least
    subnormal, 2^-133, below its least normal."""
    mag = v.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bsr_mma_check(block_idx, block_nnz, blocks, xs, got, want) -> dict:
    """``got`` (the tensor-core body's output) against ``want`` (the plain
    version's) on the same operands: where ``want`` is not finite, ``got``
    must hold the same value (NaN, or the same infinity); elsewhere |got -
    want| <= :func:`bsr_mma_tolerance` and, on a bf16 output (each side
    rounded once from its f32 sum), one bf16 ulp of the larger of |got|
    and |want| more.  Returns ``ok``, the largest |got - want| / S̃
    (``max_err_over_sum``), the largest |got - want| over what is allowed
    (``max_err_over_allowed``, at most 1 when ``ok``) and the largest
    |got - want| (``max_abs_err``), over the finite elements."""
    sums = bsr_abs_sums(block_idx, block_nnz, blocks, xs)
    allowed = bsr_mma_tolerance(block_idx, block_nnz, blocks, xs, sums)
    g, w = got.double(), want.double()
    if got.dtype == torch.bfloat16:
        allowed = allowed + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    finite = torch.isfinite(w)
    same = torch.isnan(g) & torch.isnan(w) | (g == w)
    diff = torch.where(finite, (g - w).abs(), torch.zeros_like(g))

    def ratio(num, den):   # 0 where num is, inf where only den is
        return torch.where(num == 0, torch.zeros_like(num), num / den)

    over_sum, over_allowed = ratio(diff, sums), ratio(diff, allowed)
    ok = bool((same | finite).all() and (over_allowed <= 1).all())

    def top(v):
        return float(v.nan_to_num(nan=torch.inf).max()) if v.numel() else 0.0

    return dict(ok=ok, max_err_over_sum=top(over_sum),
                max_err_over_allowed=top(over_allowed),
                max_abs_err=top(diff))
