#!/usr/bin/env python3
"""The slice kernel's compile-time shape constants against each other, on
one NVIDIA card, through K2 SPA or K3 SPARS.

    python3 benchmarks/torch_spa_shapes.py [--kernel spa|spars]
        [--set NAME=K=V,K=V ...] [--baseline PATH] [--reps N] [--seed N]

K2 (``src/repro_torch/csrc/spa.cu``) and K3 (``csrc/spars.cu``) share one
body, ``csrc/slice_kernel.cuh``, which holds the constants.  Builds the
``--kernel``'s source as it stands ("current") and once per ``--set`` with
its ``constexpr int`` constants replaced wherever they live (for example
``--set t256=kThreads=256``), and ``--baseline``, another source of that
kernel with the same C entry point, built with the headers beside it (for
example the parent commit's, unpacked with ``git archive``; a baseline
that leaves cells it does not touch gets zeroed outputs where it is
checked, and every build is timed on outputs from ``torch.empty``, so a
fill that only the baseline's wrapper needs is not timed).  Per Table-1
matrix (synthesized from ``--seed``, normal values), the groups of the
kernel's kind are launched through each build, SPA's of the default method
and SPARS's of ``spars-16/64``, at the plan's trip counts: every output
must equal the plain version bit for bit, and one JSON line gives each
build's summed device time over the groups (CUDA events, ``--reps``
launches of every group queued behind a device-side wait long enough for
the host to queue them all, output allocation included).  For ``iprob`` a last line times its largest group
alone, and that group's densest column alone and without it, beside
``torch.sparse.mm`` of the same operands.  The builds go to
``build/spa_shapes/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from kernel_builds import CSRC, build_all, read_sources, with_constants

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MATRICES = ("S40PI_n1", "bcspwr09", "tols1090", "fpga_dcop_05", "watt_1",
            "pores_2", "cage9", "ex22", "adder_dcop_01", "Goodwin_013",
            "iprob")
QUEUE_CYCLES = 5_000_000   # about 2.5 ms: time to queue a timed loop
LAUNCH_CYCLES = 100_000    # about 50 us: more than the host takes a launch
# per kernel: its source, the plan method whose groups of its kind are
# timed
KERNELS = {"spa": ("spa.cu", None), "spars": ("spars.cu", "spars-16/64")}


def launcher(lib, kernel: str, zeroed: bool):
    """launch(op) -> the outputs of one launch on ``op`` (``ab``, ``m`` and,
    for SPARS, ``steps`` and ``block``)."""
    import torch

    def launch(op):
        a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = op["ab"]
        n_b, zb = b_rows.shape
        m = op["m"]
        alloc = torch.zeros if zeroed else torch.empty
        outs = [alloc((1, m, n_b), dtype=torch.float32, device=a_vals.device)
                for _ in range(1 if kernel == "spa" else 2)]
        args = (a_rows.data_ptr(), a_vals.data_ptr(), a_nnz.data_ptr(),
                *a_rows.shape, b_rows.data_ptr(), b_vals.data_ptr(),
                b_nnz.data_ptr(), n_b, zb)
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "spa":
            rc = lib.repro_spa_launch(*args, m, 1, outs[0].data_ptr(), stream)
        else:
            rc = lib.repro_spars_launch(
                *args, op["steps"].data_ptr(), op["block"], m, 1,
                outs[0].data_ptr(), outs[1].data_ptr(), stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return tuple(o[0] for o in outs)

    return launch


def plain(kernel: str, op):
    from repro_torch.kernels import spa_spgemm_plain, spars_spgemm_plain

    if kernel == "spa":
        return (spa_spgemm_plain(*op["ab"], m=op["m"]),)
    return spars_spgemm_plain(*op["ab"], op["steps"], m=op["m"],
                              block_cols=op["block"])


def device_ms(fn, reps: int, launches: int = 1) -> float:
    """Device time of one ``fn`` call (``launches`` kernel launches), from
    ``reps`` calls queued behind a device-side wait long enough for the
    host to queue them all."""
    import chip_smoke as cs

    return cs.event_ms(fn, reps, queue_cycles=max(
        QUEUE_CYCLES, LAUNCH_CYCLES * reps * launches))


def library_operands(op):
    """(sparse CSR A, dense B columns) of one group's operands."""
    import torch

    a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = op["ab"]
    m = op["m"]
    n_a, za = a_rows.shape
    dev = a_vals.device
    live = torch.arange(za, device=dev)[None, :] < a_nnz[:, None]
    cols = torch.arange(n_a, device=dev)[:, None].expand(n_a, za)
    a_csr = torch.sparse_coo_tensor(
        torch.stack([a_rows[live].long(), cols[live]]), a_vals[live],
        (m, n_a)).coalesce().to_sparse_csr()
    b_live = torch.arange(b_rows.shape[1], device=dev)[None, :] \
        < b_nnz[:, None]
    lanes = torch.arange(b_rows.shape[0], device=dev)[:, None].expand_as(
        b_rows)
    b_dense = torch.zeros((n_a, b_rows.shape[0]), device=dev)
    b_dense.index_put_((b_rows[b_live].long(), lanes[b_live]),
                       b_vals[b_live], accumulate=True)
    return a_csr, b_dense


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="spa")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=K=V,K=V")
    ap.add_argument("--baseline")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.core import plan_spgemm
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.sparse import CSC, synthesize_suitesparse
    from repro_torch.sparse.format import padded_values

    kind = args.kernel
    main_src, method = KERNELS[kind]
    current = read_sources(os.path.join(CSRC, main_src))
    sources = {"current": current}
    for item in args.set:
        name, assignments = item.split("=", 1)
        sources[name] = with_constants(current, assignments)
    if args.baseline:
        sources["baseline"] = read_sources(args.baseline)
    libs = build_all(sources, os.path.join("spa_shapes", kind))
    checked = {name: launcher(lib, kind, name == "baseline")
               for name, lib in libs.items()}
    launch = {name: launcher(lib, kind, False) for name, lib in libs.items()}
    dev = torch.device("cuda")
    for name in MATRICES:
        a, _ = synthesize_suitesparse(name, seed=args.seed)
        rng = np.random.default_rng(args.seed)
        a = CSC(torch.from_numpy(rng.standard_normal(a.nnz).astype(
            np.float32)), a.row_indices, a.col_ptr, a.shape)
        plan = plan_spgemm(a, a, *(() if method is None else (method,)),
                           device=dev)
        lay = plan.layout
        m = plan.shape[0]
        vals = a.values.to(dev)
        a_vals = padded_values(vals, lay.a_gather, lay.a_mask)
        ops = [dict(ab=(lay.a_rows, a_vals, lay.a_nnz, g.b_rows,
                        padded_values(vals, g.b_vgather, g.b_vmask),
                        g.b_nnz),
                    m=m, steps=g.steps, block=BLOCK_COLS)
               for g in lay.groups if g.kind == kind]
        if not ops:
            continue
        for op in ops:
            want = plain(kind, op)
            for build, fn in checked.items():
                if not all(torch.equal(g, w) for g, w in zip(fn(op), want)):
                    raise SystemExit(f"{build} differs from the plain "
                                     f"version at {name}")
        line = {"matrix": name, "method": method or "default",
                f"{kind}_groups": len(ops), "sum_ms": {
                    build: device_ms(lambda: [fn(op) for op in ops],
                                     args.reps, len(ops))
                    for build, fn in launch.items()}}
        print(json.dumps(line), flush=True)
        if name != "iprob":
            continue
        products = []
        for op in ops:
            _, _, a_nnz, b_rows, _, b_nnz = op["ab"]
            live = (torch.arange(b_rows.shape[1], device=dev)[None, :]
                    < b_nnz[:, None])
            products.append(int(a_nnz[b_rows[live].long()].sum()))
        op = ops[int(np.argmax(products))]
        dense = int(torch.argmax(op["ab"][5]))
        parts = {"group": op}
        for label, cols in (("densest_column", [dense]),
                            ("other_columns",
                             [c for c in range(op["ab"][3].shape[0])
                              if c != dense])):
            idx = torch.tensor(cols, device=dev)
            # one lane block a column, at its trip count in the group
            parts[label] = dict(
                op, ab=op["ab"][:3] + tuple(x[idx].contiguous()
                                            for x in op["ab"][3:]),
                steps=None if op["steps"] is None else
                op["steps"][idx // op["block"]].contiguous(), block=1)
        a_csr, b_dense = library_operands(op)
        print(json.dumps({
            "matrix": name, "kernel": kind,
            "largest_group_products": max(products),
            "ms": {label: {build: device_ms(lambda: fn(part), args.reps)
                           for build, fn in launch.items()}
                   for label, part in parts.items()},
            "library_ms": device_ms(lambda: torch.sparse.mm(a_csr, b_dense),
                                    args.reps),
            "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
