"""A plain PyTorch model of K1's walk (``csrc/fused_stream.cu``), for the
CPU tests (``test_torch_fused_layout.py``).  Imports no JAX.

The model follows the kernel's grid: the warp CTAs first (a warp for each
long slot of the view's ``long_slots`` and each value set of the tile),
then the short CTAs (a thread a slot and all the tile's value sets, which
skips a slot longer than the threshold), each CTA once per tile of value
sets.  A warp sums its slot in rounds of 32 products, ``depth`` rounds
gathered together, each round's products added in lane order and lanes
past the slot's end adding +0.0; a thread sums its slot product by
product.  Every product and sum is one f32 multiply or add, as the
kernel's ``__fmul_rn`` / ``__fadd_rn``.  The output starts as NaN (the
wrapper's ``torch.empty``), so a slot no tier writes shows.
"""

import torch

from repro_torch.kernels.fused_stream import LONG_SLOT

# the kernel's other constants: rounds a warp gathers together, value sets
# a short-tier thread carries, threads a CTA (the long-slot threshold is
# the wrapper's copy, LONG_SLOT)
DEPTH, BATCH_TILE, THREADS = 3, 8, 256
WARP = 32


def _short_slot(seg, idx_x, idx_y, xs, ys, s, long_slot):
    """[nb] sums of slot s by one thread, or None if the slot is long."""
    lo, hi = seg[s], seg[s + 1]
    if hi - lo > long_slot:
        return None
    acc = torch.zeros(xs.shape[0])
    for q in range(lo, hi):
        acc = acc + xs[:, idx_x[q]] * ys[:, idx_y[q]]
    return acc


def _long_slot(seg, idx_x, idx_y, xs, ys, s, depth):
    """[nb] sums of slot s by one warp: rounds of 32 lanes, ``depth`` of
    them gathered together."""
    lo, hi = seg[s], seg[s + 1]
    lanes = torch.arange(WARP)
    acc = torch.zeros(xs.shape[0])
    for q0 in range(lo, hi, WARP * depth):
        # lane k's product of each round; +0.0 past the slot's end
        p = torch.zeros((depth, xs.shape[0], WARP))
        for d in range(depth):
            q = q0 + WARP * d + lanes
            live = q < hi
            ql = q[live]
            p[d][:, live] = xs[:, idx_x[ql]] * ys[:, idx_y[ql]]
        for d in range(depth):
            if q0 + WARP * d >= hi:
                break
            for k in range(WARP):
                acc = acc + p[d, :, k]
    return acc


def walk_model(idx_x, idx_y, seg_ptr, long_slots, x, y, *,
               long_slot=LONG_SLOT, depth=DEPTH, batch_tile=BATCH_TILE,
               threads=THREADS):
    """out [B, n_out] as the kernel computes it for ``x [B, n_x]``, ``y
    [B, n_y]``, step by step."""
    batch = x.shape[0]
    n_out = seg_ptr.shape[0] - 1
    out = torch.full((batch, n_out), float("nan"))
    seg = seg_ptr.long()
    ix, iy = idx_x.long(), idx_y.long()
    slots = long_slots.tolist()
    seg_l = seg.tolist()
    warps = threads // WARP
    short_ctas = -(-n_out // threads)
    tile = 1 if batch == 1 else batch_tile
    warp_ctas = -(-len(slots) * tile // warps)
    for b0 in range(0, batch, tile):
        xs, ys = x[b0: b0 + tile], y[b0: b0 + tile]
        rows = slice(b0, b0 + xs.shape[0])
        for cta in range(warp_ctas + short_ctas):
            if cta < warp_ctas:
                for w in range(cta * warps, (cta + 1) * warps):
                    i, b = divmod(w, tile)
                    if i < len(slots) and b < xs.shape[0]:
                        s = slots[i]
                        out[b0 + b, s] = _long_slot(seg_l, ix, iy,
                                                    xs[b: b + 1],
                                                    ys[b: b + 1], s,
                                                    depth)[0]
                continue
            first = (cta - warp_ctas) * threads
            for s in range(first, min(first + threads, n_out)):
                acc = _short_slot(seg_l, ix, iy, xs, ys, s, long_slot)
                if acc is not None:
                    out[rows, s] = acc
    return out
