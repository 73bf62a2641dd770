#!/usr/bin/env python3
"""K2's compile-time shape constants against each other, on one NVIDIA card.

    python3 benchmarks/torch_spa_shapes.py [--set NAME=K=V,K=V ...]
        [--baseline PATH] [--reps N] [--seed N]

Builds ``src/repro_torch/csrc/spa.cu`` as it stands ("current") and once per
``--set`` with its ``constexpr int`` constants replaced (for example
``--set t256=kThreads=256``), and ``--baseline``, another K2 source with
the same C entry point (for example the parent commit's, unpacked with
``git archive``; a baseline that leaves cells it does not touch gets a
zeroed output).  Per Table-1 matrix (synthesized from ``--seed``, normal
values), the default method's SPA groups are launched through each build:
every output must equal the plain version bit for bit, and one JSON line
gives each build's summed device time over the groups (CUDA events,
``--reps`` launches of every group queued behind a device-side wait, output
allocation included).  For ``iprob`` a last line times its largest group
alone, and that group's densest column alone and without it, beside
``torch.sparse.mm`` of the same operands.  The builds go to
``build/spa_shapes/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MATRICES = ("S40PI_n1", "bcspwr09", "tols1090", "fpga_dcop_05", "watt_1",
            "pores_2", "cage9", "ex22", "adder_dcop_01", "Goodwin_013",
            "iprob")
QUEUE_CYCLES = 5_000_000   # about 2.5 ms: time to queue a timed loop


def with_constants(src: str, assignments: str) -> str:
    for item in assignments.split(","):
        name, value = item.split("=")
        src, n = re.subn(r"constexpr int %s = -?\d+;" % name,
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"no constant {name} in spa.cu")
    return src


def build_all(sources: dict) -> dict:
    """Compile each source into its own shared library, all at once."""
    from repro_torch.kernels import _build

    procs = {}
    for name, text in sources.items():
        out = os.path.join(ROOT, "build", "spa_shapes", name)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "spa.cu"), "w") as f:
            f.write(text)
        procs[name] = (os.path.join(out, "lib.so"), subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             os.path.join(out, "spa.cu"), "-o", os.path.join(out, "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(json.dumps({"build": name, "ptxas": re.findall(
            r"Used \d+ registers.*|\d+ bytes stack frame.*", log)}),
            flush=True)
        lib = ctypes.CDLL(path)
        lib.repro_spa_launch.argtypes = _build.SIGNATURES["repro_spa_launch"]
        lib.repro_spa_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, zeroed: bool):
    import torch

    def launch(ab, m):
        a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = ab
        n_b, zb = b_rows.shape
        alloc = torch.zeros if zeroed else torch.empty
        out = alloc((1, m, n_b), dtype=torch.float32, device=a_vals.device)
        rc = lib.repro_spa_launch(
            a_rows.data_ptr(), a_vals.data_ptr(), a_nnz.data_ptr(),
            *a_rows.shape, b_rows.data_ptr(), b_vals.data_ptr(),
            b_nnz.data_ptr(), n_b, zb, m, 1, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return out[0]

    return launch


def device_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def library_operands(ab, m):
    """(sparse CSR A, dense B columns) of one group's operands."""
    import torch

    a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = ab
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
    from repro_torch.core import plan_spgemm
    from repro_torch.kernels import spa_spgemm_plain
    from repro_torch.sparse import CSC, synthesize_suitesparse
    from repro_torch.sparse.format import padded_values

    with open(os.path.join(ROOT, "src/repro_torch/csrc/spa.cu")) as f:
        current = f.read()
    sources = {"current": current}
    for item in args.set:
        name, assignments = item.split("=", 1)
        sources[name] = with_constants(current, assignments)
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
    libs = build_all(sources)
    launch = {name: launcher(lib, name == "baseline")
              for name, lib in libs.items()}
    dev = torch.device("cuda")
    for name in MATRICES:
        a, _ = synthesize_suitesparse(name, seed=args.seed)
        rng = np.random.default_rng(args.seed)
        a = CSC(torch.from_numpy(rng.standard_normal(a.nnz).astype(
            np.float32)), a.row_indices, a.col_ptr, a.shape)
        plan = plan_spgemm(a, a, device=dev)
        lay = plan.layout
        m = plan.shape[0]
        vals = a.values.to(dev)
        a_vals = padded_values(vals, lay.a_gather, lay.a_mask)
        ops = [(lay.a_rows, a_vals, lay.a_nnz, g.b_rows,
                padded_values(vals, g.b_vgather, g.b_vmask), g.b_nnz)
               for g in lay.groups if g.kind == "spa"]
        if not ops:
            continue
        for ab in ops:
            want = spa_spgemm_plain(*ab, m=m)
            for build, fn in launch.items():
                if not torch.equal(fn(ab, m), want):
                    raise SystemExit(f"{build} differs from the plain "
                                     f"version at {name}")
        line = {"matrix": name, "spa_groups": len(ops), "sum_ms": {
            build: device_ms(lambda: [fn(ab, m) for ab in ops], args.reps)
            for build, fn in launch.items()}}
        print(json.dumps(line), flush=True)
        if name != "iprob":
            continue
        live = [torch.arange(ab[3].shape[1], device=dev)[None, :]
                < ab[5][:, None] for ab in ops]
        products = [int(ab[2][ab[3][lv].long()].sum())
                    for ab, lv in zip(ops, live)]
        ab = ops[int(np.argmax(products))]
        dense = int(torch.argmax(ab[5]))
        parts = {"group": ab}
        for label, cols in (("densest_column", [dense]),
                            ("other_columns",
                             [c for c in range(ab[3].shape[0])
                              if c != dense])):
            idx = torch.tensor(cols, device=dev)
            parts[label] = ab[:3] + tuple(x[idx].contiguous()
                                          for x in ab[3:])
        a_csr, b_dense = library_operands(ab, m)
        print(json.dumps({
            "matrix": name, "largest_group_products": max(products),
            "ms": {label: {build: device_ms(lambda: fn(part, m), args.reps)
                           for build, fn in launch.items()}
                   for label, part in parts.items()},
            "library_ms": device_ms(lambda: torch.sparse.mm(a_csr, b_dense),
                                    args.reps),
            "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
