#!/usr/bin/env python3
"""K5's compile-time constants against each other and against another
source of the kernel, on one NVIDIA card, at granite-20b's sparse FFN.

    python3 benchmarks/torch_bsr_shapes.py [--set NAME=K=V,K=V ...]
        [--ablate fma|no_copy|no_split|no_ldmatrix|no_stage_out|no_swizzle
        ...] [--baseline PATH] [--pair f32|f32_bf16|bf16_bf16 ...]
        [--rounds N] [--reps N] [--seed N]

Builds ``src/repro_torch/csrc/bsr_spmm.cu`` as it stands ("current"), once
per ``--set`` with its ``constexpr int`` constants replaced (for example
``--set s6=kStages=6,kStageFloats=8192``), once per ``--ablate`` with one
part of the work changed or left out (timing only, the results are wrong
by construction except for "no_swizzle"): on the SIMT body (f32 x),
"fma" adds each product with one FMA instead of a multiply and an add;
on both bodies "no_copy" stages no x, the electing lane only arriving; on
the tensor-core body (8x8 blocks on bf16 x) "no_split" runs the hi part's
MMAs only (f32 blocks: one pass where there are three), "no_ldmatrix"
takes the A fragments from registers instead of shared memory,
"no_stage_out" stores each sum straight from its lane (2-byte stores)
instead of through shared memory in 16-byte rows, and "no_swizzle"
stages x without the 128-byte swizzle and reads it unswizzled (the bank
conflicts that the swizzle removes); and ``--baseline``, another source
of K5 with the same C entry point (for example the parent commit's,
unpacked with ``git archive``).  Every build is driven through the
wrappers (``kernels.bsr_spmm`` and ``bsr_spmm_batched``), its library
swapped in for the port's.  granite-20b's gate, up and down weights (from
``--seed``) are pruned to keep 0.25 of their 8x8 blocks, as the sparse
FFN's bsr path serves them, and a fourth weight of gate's shape keeps the
same 192 random block-columns in every block-row ("balanced": every warp
of a CTA has the same blocks in every chunk, so no warp waits for
another).  Each ``--pair`` (blocks' and x's dtypes: "f32" both f32, the
default; "f32_bf16" the FFN's f32 blocks on bf16 x; "bf16_bf16") runs K5
on the prefill's operands (x [K, 2048]) and K5-b on the batch's ([8, K,
128]), every output on ``torch.empty``; on a 128-column slice of x (one
activation set of K5-b's) each non-ablated build's output must equal the
plain version bit for bit where the build reports a SIMT instance, and be
within ``kernels.bsr_mma_check``'s bound where it reports the
tensor-core one (``instance "mma"``), and on integer-valued blocks and x
equal the plain version bit for bit in every build.  Then ``--rounds``
rounds time every build in turn (A, B, ..., then the next round), each
time CUDA events around ``--reps`` launches queued behind a device-side
wait (``chip_smoke.event_ms``).  One JSON line a build gives its
registers and spills (``-Xptxas -v``), one a (weight, operand, pair) its
multiply-adds, bytes (each input read once, the output written once),
its bound (f32 SIMT operations on f32 x; on bf16 x the tensor cores' bf16
rate, three passes for f32 blocks), the bound of the exact order on f32
x (twice the operation bound: a multiply and an add a product) and each
build's times, one a weight the balance model of each build's walk at
the launch shape that the build itself reports (``repro_bsr_layout``, so
a ``--set`` of its constants moves it too; the baseline has none): how
much longer its CTAs take when each warp must wait at each chunk's ring
stage for the slowest one, against the slowest warp alone and against
perfect balance (host numpy); and a last one the card.  The builds go to
``build/bsr_shapes/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from kernel_builds import CSRC, ROOT, ablated, build_all, read_sources, \
    using, with_constants

ARCH, KEEP, BLOCK = "granite-20b", 0.25, 8
PREFILL, BATCH, BATCH_TOKENS = 2048, 8, 128
CHECK_COLS = 128
# the H100 SXM's published peaks
F32_FLOPS, BF16_FLOPS, MEM_BYTES = 67e12, 989e12, 3.35e12
#: --pair: (blocks' dtype, x's dtype)
PAIRS = {"f32": ("float32", "float32"), "f32_bf16": ("float32", "bfloat16"),
         "bf16_bf16": ("bfloat16", "bfloat16")}

_TILE_LOAD = "ldsm_x4_t(a[q], base + (m0 >> 2) * kRegionBytes + off[q]);"
_TILE_LOAD8 = "ldsm_x2_t(a[q], base + (m0 >> 2) * kRegionBytes + off[q]);"
_STAGE_OUT = """        o[2 * t][tok] = __float2bfloat16_rn(acc[mt][0]);
        o[2 * t + 1][tok] = __float2bfloat16_rn(acc[mt][1]);
        o[2 * t][tok + 8] = __float2bfloat16_rn(acc[mt][2]);
        o[2 * t + 1][tok + 8] = __float2bfloat16_rn(acc[mt][3]);"""
_DIRECT_OUT = """        const int cg = col0 + 64 * r + tok;
        if (cg < n) {
          orow[(2 * t) * n + cg] = __float2bfloat16_rn(acc[mt][0]);
          orow[(2 * t + 1) * n + cg] = __float2bfloat16_rn(acc[mt][1]);
        }
        if (cg + 8 < n) {
          orow[(2 * t) * n + cg + 8] = __float2bfloat16_rn(acc[mt][2]);
          orow[(2 * t + 1) * n + cg + 8] = __float2bfloat16_rn(acc[mt][3]);
        }"""

# what each ablation replaces in the kernel's source
ABLATIONS = {
    "fma": (("acc[r][v] = __fadd_rn(acc[r][v], __fmul_rn(wr[r], xv[v]));",
             "acc[r][v] = fmaf(wr[r], xv[v], acc[r][v]);"),),
    "no_copy": (("bar_arrive_expect(&sm.full[s], kStageFloats * 4);",
                 "bar_arrive_expect(&sm.full[s], 0);"),
                ("tma_load_3d(sm.x[s], &x_map,",
                 "if (false) tma_load_3d(sm.x[s], &x_map,"),
                ("bar_arrive_expect(&sm.full[s], live_regions * kRegionBytes);",
                 "bar_arrive_expect(&sm.full[s], 0);"),
                ("tma_load_3d(sm.x[s] + r * kRegionBytes, &x_map,",
                 "if (false) tma_load_3d(sm.x[s] + r * kRegionBytes, &x_map,")),
    "no_split": (("const bool mid = kSplit && any_part(pa[1], pb[1]);",
                  "const bool mid = false;"),
                 ("const bool low = kSplit && any_part(pa[2], pb[2]);",
                  "const bool low = false;")),
    "no_ldmatrix": ((_TILE_LOAD, "a[q][0] = a[q][1] = a[q][2] = a[q][3] = "
                     "base + off[q];"),
                    (_TILE_LOAD8, "a[q][0] = a[q][1] = base + off[q];")),
    "no_stage_out": ((_STAGE_OUT, _DIRECT_OUT),
                     ("        if (col < n) {\n          *reinterpret_cast",
                      "        if (false) {\n          *reinterpret_cast")),
    "no_swizzle": (("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE"),
                   ("static_cast<unsigned>(((lane >> 3) & 1) ^ r8);",
                    "static_cast<unsigned>((lane >> 3) & 1);")),
}


def run(ops, xs):
    """K5 (``xs`` of one activation set) or K5-b through the wrappers,
    every output on ``torch.empty``."""
    from repro_torch import kernels

    if xs.shape[0] == 1:
        return kernels.bsr_spmm(*ops, xs[0], bn=xs.shape[2])[None]
    return kernels.bsr_spmm_batched(*ops, xs, bn=xs.shape[2])


def pruned_weights(seed: int) -> dict:
    """name -> (host BSR operands, K) of granite-20b's gate, up and down at
    keep 0.25, and of the balanced weight of gate's shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import bsr_from_dense
    from repro_torch.models import ffn_table, init_params, prune_blocks

    cfg = get_config(ARCH)
    params = init_params(ffn_table(cfg), torch.Generator().manual_seed(seed),
                         device="cpu")
    out = {}
    for name in ("gate", "up", "down"):
        w, _ = prune_blocks(params[name]["w"].T.numpy(), BLOCK, BLOCK, KEEP)
        out[name] = (bsr_from_dense(w, BLOCK, BLOCK), w.shape[1])
        del w
    del params
    n_rb, n_cb = cfg.d_ff // BLOCK, cfg.d_model // BLOCK
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(n_cb, int(round(KEEP * n_cb)), replace=False))
    out["balanced"] = ((
        np.broadcast_to(cols.astype(np.int32), (n_rb, len(cols))).copy(),
        np.full(n_rb, len(cols), np.int32),
        rng.standard_normal((n_rb, len(cols), BLOCK, BLOCK)).astype(
            np.float32)), cfg.d_model)
    return out


def balance_model(block_idx, block_nnz, group: int, chunk: int,
                  stages: int) -> dict:
    """The 8x8 instance's walk in units of one block's work: warp w of a
    CTA starts its blocks of chunk c once it has finished chunk c - 1 and
    every warp of the CTA has finished chunk c - stages (the ring stage is
    free).  Summed over the CTAs: the time so modelled, the slowest warp's
    blocks alone (no waits) and the mean warp's (perfect balance)."""
    n_rb = block_nnz.shape[0]
    n_cb = int(block_idx.max()) + 1 if block_nnz.any() else 1
    n_ch = -(-n_cb // chunk)
    groups = -(-n_rb // group)
    counts = np.zeros((groups * group, n_ch), np.int64)
    live = np.arange(block_idx.shape[1])[None, :] < block_nnz[:, None]
    rows = np.broadcast_to(np.arange(n_rb)[:, None], block_idx.shape)
    np.add.at(counts, (rows[live], block_idx[live] // chunk), 1)
    counts = counts.reshape(groups, group, n_ch)
    done = np.zeros((groups, group, n_ch))
    for c in range(n_ch):
        start = done[:, :, c - 1] if c else np.zeros((groups, group))
        if c >= stages:
            start = np.maximum(start, done[:, :, c - stages].max(
                axis=1, keepdims=True))
        done[:, :, c] = start + counts[:, :, c]
    per_warp = counts.sum(axis=2)
    return dict(modelled=float(done[:, :, -1].max(axis=1).sum()),
                slowest_warp=float(per_warp.max(axis=1).sum()),
                mean_warp=float(per_warp.mean(axis=1).sum()))


def work(ops, k_dim: int, batch: int, n: int, pair: str) -> dict:
    """Multiply-adds and bytes of one launch on the ``pair``'s dtypes, its
    bound (f32 SIMT operations on f32 x; on bf16 x the tensor cores' rate,
    one pass a bf16 part of a weight) and, on f32 x, the bound of the exact
    order."""
    block_idx, block_nnz, blocks = ops
    n_rb, _, bm, bk = blocks.shape
    w_size, x_size = (4 if d == "float32" else 2 for d in PAIRS[pair])
    kept = int(block_nnz.sum())
    macs = batch * kept * bm * bk * n
    nbytes = (kept * (bm * bk * w_size + 4) + n_rb * 4
              + batch * (k_dim * n + n_rb * bm * n) * x_size)
    if x_size == 4:
        return dict(multiply_adds=macs, bytes=nbytes, bound_ms=max(
            nbytes / MEM_BYTES, 2 * macs / F32_FLOPS) * 1e3,
            exact_order_bound_ms=max(nbytes / MEM_BYTES,
                                     4 * macs / F32_FLOPS) * 1e3)
    passes = 3 if w_size == 4 else 1
    return dict(multiply_adds=macs, bytes=nbytes, passes=passes,
                bound_ms=max(nbytes / MEM_BYTES,
                             2 * passes * macs / BF16_FLOPS) * 1e3)


def check(ops, xs, lay, build, label):
    """A build's output on a slice against the plain version: bit for bit
    on a SIMT instance, within the bound on the tensor-core one."""
    import torch
    from repro_torch import kernels

    got = run(ops, xs)
    want = kernels.bsr_spmm_batched_plain(*ops, xs)
    if lay.get("instance") == "mma":
        rep = kernels.bsr_mma_check(*ops, xs, got, want)
        ok = rep["ok"]
    else:
        ok = torch.equal(got, want)
    if not ok:
        raise SystemExit(f"FAIL: build {build} differs from the plain "
                         f"version on {label}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=K=V,K=V")
    ap.add_argument("--ablate", action="append", default=[],
                    choices=sorted(ABLATIONS))
    ap.add_argument("--baseline")
    ap.add_argument("--pair", action="append", choices=sorted(PAIRS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    pairs = args.pair or ["f32"]
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import kernels

    current = read_sources(os.path.join(CSRC, "bsr_spmm.cu"))
    sources = {"current": current}
    for spec in args.set:
        name, assignments = spec.split("=", 1)
        sources[name] = with_constants(current, assignments)
    for what in args.ablate:
        sources[f"ablate_{what}"] = ablated(current, ABLATIONS[what], what)
    if args.baseline:
        sources["baseline"] = read_sources(args.baseline)
    libs = build_all(sources, "bsr_shapes")
    weights = pruned_weights(args.seed)
    shapes = {name: ((1, k_dim, PREFILL), (BATCH, k_dim, BATCH_TOKENS))
              for name, (_, k_dim) in weights.items()}
    for name, ((bi, bn, blocks), _) in weights.items():
        model = {}
        for build, lib in libs.items():
            if not hasattr(lib, "repro_bsr_layout"):
                continue
            with using(lib):
                lays = [kernels.bsr_layout(blocks.shape[0], BLOCK, BLOCK,
                                           shape[2], shape[0])
                        for shape in shapes[name]]
            model[build] = {
                kernel: dict(layout=lay, **balance_model(
                    bi, bn, lay["group_units"], lay["chunk"], lay["stages"]))
                for kernel, lay in zip(("K5", "K5-b"), lays)}
        print(json.dumps(dict(weight=name, balance_model=model)), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    f32_ops = {name: tuple(torch.from_numpy(a).to(dev) for a in w)
               for name, (w, _) in weights.items()}
    cases = []   # (weight, shape, pair, ops, xs)
    for pair in pairs:
        w_dtype, x_dtype = (getattr(torch, d) for d in PAIRS[pair])
        for name in weights:
            ops = f32_ops[name][:2] + (f32_ops[name][2].to(w_dtype),)
            for shape in shapes[name]:
                cases.append((name, shape, pair, ops, torch.randn(
                    shape, generator=gen, device=dev).to(x_dtype)))
    for name, shape, pair, ops, xs in cases:
        cut = xs[:1, :, :CHECK_COLS].contiguous()
        ints = ops[:2] + (torch.randint(-2, 3, ops[2].shape, generator=gen,
                                        device=dev).to(ops[2].dtype),)
        cut_int = torch.randint(-2, 3, cut.shape, generator=gen,
                                device=dev).to(cut.dtype)
        want_int = kernels.bsr_spmm_batched_plain(*ints, cut_int)
        for build, lib in libs.items():
            if build.startswith("ablate_"):
                continue
            with using(lib):
                lay = (kernels.bsr_layout(ops[2].shape[0], BLOCK, BLOCK,
                                          CHECK_COLS, 1, True, xs.dtype)
                       if hasattr(lib, "repro_bsr_layout") else {})
                label = f"{name} {list(shape)} {pair}"
                check(ops, cut, lay, build, label)
                if not torch.equal(run(ints, cut_int), want_int):
                    raise SystemExit(f"FAIL: build {build} differs from the "
                                     f"plain version on integers, {label}")
    times = {(name, shape, pair): {build: [] for build in libs}
             for name, shape, pair, _, _ in cases}
    for _ in range(args.rounds):
        for name, shape, pair, ops, xs in cases:
            for build, lib in libs.items():
                with using(lib):
                    times[name, shape, pair][build].append(cs.event_ms(
                        lambda: run(ops, xs), args.reps))
    for name, shape, pair, ops, xs in cases:
        print(json.dumps(dict(
            weight=name, x=list(shape) if shape[0] > 1 else list(shape[1:]),
            kernel="K5-b" if shape[0] > 1 else "K5", pair=pair,
            kept_blocks=int(ops[1].sum()),
            **work(ops, weights[name][1], shape[0], shape[2], pair),
            event_ms=times[name, shape, pair])), flush=True)
    print(json.dumps({"card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
