#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each of which fails the run (non-zero exit, no result line):

1. Header: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the ``nvcc`` build of ``src/repro_torch/csrc/*.cu``.
2. Kernel phase: K2 SPA, K3 SPARS and K4 HASH each against its plain
   PyTorch version on the same CUDA tensors — the first and last group of
   each kind in the main path's plans, on the integer values and on
   real-valued (normal) values of the same patterns, plus edge cases —
   exactly equal.
3. Main path: C = A·A through ``repro_torch.core.spgemm`` for eleven of the
   paper's Table-1 matrices (synthesized from their published statistics,
   integer values in {1, 2, 3} from ``--seed``) under the default method and
   four others; every C must equal ``scipy.sparse`` A@A in f64 exactly, and
   every kernel's launch count must rise during this phase.
4. Timing: per matrix and method, the host plan time, the execute time
   (median of ``--reps``), the host syncs of one execute on operands
   already on the card, each kernel's device time (CUDA events) and
   ``torch.sparse.mm(A, A)`` as ``library_ms``, a yardstick the port never
   calls; per kernel, its time, its plain version's, its bound and a library
   call's, at its largest main-path group.

The last two lines are the kernels' JSON and the card line; the very last is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MATRICES = ("S40PI_n1", "bcspwr09", "tols1090", "fpga_dcop_05", "watt_1",
            "pores_2", "cage9", "ex22", "adder_dcop_01", "Goodwin_013",
            "iprob")
DEFAULT = None   # spgemm()'s own default method (h-hash-256/256)
METHODS = (DEFAULT, "spa", "h-spa-16/64", "spars-16/64", "hash-256/256")

# NVIDIA H100 SXM data sheet: HBM3 rate, and f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

KERNELS = {
    "spa": dict(name="spa_spgemm", route="cuda",
                source="src/repro_torch/csrc/spa.cu",
                replaces="src/repro/kernels/spa.py:28"),
    "spars": dict(name="spars_spgemm", route="cuda",
                  source="src/repro_torch/csrc/spars.cu",
                  replaces="src/repro/kernels/spars.py:27"),
    "hash": dict(name="hash_spgemm", route="cuda",
                 source="src/repro_torch/csrc/hash_spgemm.cu",
                 replaces="src/repro/kernels/hash_spgemm.py:30"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def method_name(method) -> str:
    return "default(h-hash-256/256)" if method is None else method


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------


def integer_matrix(name: str, seed: int):
    """Table-1 matrix ``name`` with values in {1, 2, 3}: every product and
    sum of A·A stays an exact integer in f32 (the largest, iprob's, is
    below 2^24)."""
    import torch
    from repro_torch.sparse import CSC, synthesize_suitesparse
    from repro_torch.sparse.suitesparse import name_seed

    m, _ = synthesize_suitesparse(name, seed=seed)
    rng = np.random.default_rng([seed, name_seed(name)])
    vals = rng.integers(1, 4, size=m.nnz).astype(np.float32)
    return CSC(torch.from_numpy(vals), m.row_indices, m.col_ptr, m.shape)


def real_valued(a, seed: int):
    """The same pattern with standard normal f32 values: sums that round,
    so a kernel that summed in another order than its plain version would
    differ from it."""
    import torch
    from repro_torch.sparse import CSC

    rng = np.random.default_rng([seed, 1])
    vals = rng.standard_normal(a.nnz).astype(np.float32)
    return CSC(torch.from_numpy(vals), a.row_indices, a.col_ptr, a.shape)


def scipy_square(a):
    """(indptr, indices, data) of A@A in f64 by scipy, zeros dropped."""
    import scipy.sparse as sps
    from repro_torch.sparse.format import _np

    s = sps.csc_matrix((_np(a.values).astype(np.float64),
                        _np(a.row_indices), _np(a.col_ptr)), shape=a.shape)
    c = (s @ s).tocsc()
    c.eliminate_zeros()
    c.sort_indices()
    return c.indptr, c.indices, c.data


def edge_operands(dev):
    """Padded kernel operands for the edge cases: a B entry on an empty A
    column, empty B columns, an all-empty operand, a table exactly full
    (Op_j + 1 = H), H = 2, and a lane block that is all padding."""
    import torch
    from repro_torch.core.analysis import hash_table_size
    from repro_torch.sparse import (
        csc_from_dense, csc_to_padded_columns, ops_per_column,
        random_uniform_csc, steps_per_column,
    )

    block = 32
    rng = np.random.default_rng(3)
    cases = {}
    ad = np.zeros((12, 12))
    ad[[1, 4], 3] = (2.0, 3.0)
    bd = np.zeros((12, 40))
    bd[[0, 3, 7], 5] = (1.0, 4.0, 1.0)
    bd[0, 9] = 2.0
    cases["empty_a_column"] = (ad, bd, None)
    ad = rng.integers(1, 4, (24, 20)) * (rng.uniform(size=(24, 20)) < 0.3)
    bd = rng.integers(1, 4, (20, 32)) * (rng.uniform(size=(20, 32)) < 0.3)
    bd[:, ::2] = 0
    cases["empty_b_columns"] = (ad, bd, None)
    cases["all_empty"] = (random_uniform_csc(16, 0), random_uniform_csc(16, 0),
                          None)
    ad = np.zeros((8, 8))
    ad[[1, 2, 3], 0] = (1.0, 2.0, 3.0)
    bd = np.zeros((8, 8))
    bd[[0, 1], 4] = (2.0, 5.0)
    cases["table_full"] = (ad, bd, None)
    cases["h2"] = (np.eye(16)[:, rng.permutation(16)], np.eye(16) * 3.0, 2)
    bd = rng.integers(1, 4, (24, 10)) * (rng.uniform(size=(24, 10)) < 0.3)
    cases["padding_block"] = (rng.integers(1, 4, (24, 24))
                              * (rng.uniform(size=(24, 24)) < 0.2), bd, None)
    out = {}
    for name, (a, b, h) in cases.items():
        a = a if not isinstance(a, np.ndarray) else csc_from_dense(a)
        b = b if not isinstance(b, np.ndarray) else csc_from_dense(b)
        ar, av, an = csc_to_padded_columns(a)
        br, bv, bn = csc_to_padded_columns(b)
        n_real = b.n_cols
        n_pad = (-(-n_real // block) + (name == "padding_block")) * block
        pad = n_pad - n_real
        steps = np.zeros(n_pad, np.int64)
        steps[:n_real] = steps_per_column(a, b)
        ops = int(ops_per_column(a, b).max(initial=0))
        out[name] = dict(
            ab=tuple(x.to(dev) for x in (
                ar, av.float(), an,
                torch.nn.functional.pad(br, (0, 0, 0, pad)),
                torch.nn.functional.pad(bv.float(), (0, 0, 0, pad)),
                torch.nn.functional.pad(bn, (0, pad)))),
            steps=torch.from_numpy(steps.reshape(-1, block).max(axis=1)
                                   .astype(np.int32)).to(dev),
            m=a.n_rows, block=block,
            h=h if h is not None else hash_table_size(ops))
    return out


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def group_operands(plan, a, groups=None):
    """(ab, steps, m, block, h) of each of ``groups`` (default: all groups
    of ``plan``) on A's values, as the executor feeds them to the kernels."""
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.sparse.format import padded_values

    lay = plan.layout
    vals = a.values.to(plan.device, torch.float32)
    av = padded_values(vals, lay.a_gather, lay.a_mask)
    for g in lay.groups if groups is None else groups:
        yield g, dict(ab=(lay.a_rows, av, lay.a_nnz, g.b_rows,
                          padded_values(vals, g.b_vgather, g.b_vmask),
                          g.b_nnz),
                      steps=g.steps, m=plan.shape[0], block=BLOCK_COLS,
                      h=g.h)


def run_kernel(kind, op):
    from repro_torch import kernels

    if kind == "spa":
        return (kernels.spa_spgemm(*op["ab"], m=op["m"],
                                   block_cols=op["block"]),)
    if kind == "spars":
        return kernels.spars_spgemm(*op["ab"], op["steps"], m=op["m"],
                                    block_cols=op["block"])
    return kernels.hash_spgemm(*op["ab"], op["steps"], m=op["m"], h=op["h"],
                               block_cols=op["block"])


def run_plain(kind, op):
    from repro_torch import kernels

    if kind == "spa":
        return (kernels.spa_spgemm_plain(*op["ab"], m=op["m"]),)
    if kind == "spars":
        return kernels.spars_spgemm_plain(*op["ab"], op["steps"], m=op["m"],
                                          block_cols=op["block"])
    return kernels.hash_spgemm_plain(*op["ab"], op["steps"], h=op["h"],
                                     block_cols=op["block"])


def compare(kind, op, label):
    """Kernel vs plain on the same tensors; returns max |difference|."""
    import torch

    got = run_kernel(kind, op)
    torch.cuda.synchronize()
    want = run_plain(kind, op)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{kind} {label}: shape/dtype {g.shape}/{g.dtype} vs "
              f"{w.shape}/{w.dtype}")
        check(torch.equal(g, w), f"{kind} {label}: kernel != plain version")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def kernel_phase(plans, mats, dev, seed):
    """Every kernel against its plain version: the first and last group of
    each kind of every matrix's plans, on the integer values and on real
    values of the same pattern, and the edge cases."""
    errs = {k: 0.0 for k in KERNELS}
    checked = {k: 0 for k in KERNELS}
    for name in MATRICES:
        seen = {}
        for method in METHODS:
            for g in plans[name, method].layout.groups:
                seen.setdefault(g.kind, []).append((method, g))
        real = real_valued(mats[name], seed)
        for kind, groups in seen.items():
            picks = [groups[0]] + ([groups[-1]] if len(groups) > 1 else [])
            for method, g in picks:
                for values, a in (("int", mats[name]), ("real", real)):
                    (_, op), = group_operands(plans[name, method], a, [g])
                    errs[kind] = max(errs[kind], compare(
                        kind, op, f"{name} {method_name(method)} "
                        f"{len(g.cols)} cols, {values} values"))
                    checked[kind] += 1
    for name, op in edge_operands(dev).items():
        for kind in KERNELS:
            errs[kind] = max(errs[kind], compare(kind, op, name))
            checked[kind] += 1
    for kind in KERNELS:
        check(checked[kind] > 0, f"{kind}: no group compared")
        print(f"kernel {KERNELS[kind]['name']}: {checked[kind]} comparisons "
              f"with the plain version, max |diff| {errs[kind]}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def main_path(mats, expected):
    """C = A·A through spgemm() for every matrix and method; exact check."""
    from repro_torch import kernels
    from repro_torch.core import plan_cache_clear, spgemm
    from repro_torch.sparse.format import _np

    plan_cache_clear()
    kernels.reset_launch_counts()
    for name in MATRICES:
        a = mats[name]
        for method in METHODS:
            c = spgemm(a, a) if method is None else spgemm(a, a, method)
            indptr, indices, data = expected[name]
            label = f"{name} {method_name(method)}"
            check(c.values.device.type == "cuda", f"{label}: result on "
                  f"{c.values.device}")
            check(np.array_equal(_np(c.col_ptr), indptr),
                  f"{label}: col_ptr differs from scipy")
            check(np.array_equal(_np(c.row_indices), indices),
                  f"{label}: row indices differ from scipy")
            vals = _np(c.values)
            check(np.isfinite(vals).all(), f"{label}: non-finite values")
            check(np.array_equal(vals.astype(np.float64), data),
                  f"{label}: values differ from scipy")
    counts = kernels.launch_counts()
    print(f"main path: {len(MATRICES)} matrices x {len(METHODS)} methods "
          f"equal scipy A@A exactly; launches {json.dumps(counts)}",
          flush=True)
    for kind, info in KERNELS.items():
        check(counts[info["name"]] > 0,
              f"{info['name']} was not launched on the main path")
    return counts


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` per call, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_syncs(fn) -> int:
    """How many times ``fn`` made the host wait for the card, as PyTorch's
    sync debug mode reports them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def torch_csr(a, dev):
    import scipy.sparse as sps
    import torch
    from repro_torch.sparse.format import _np

    s = sps.csc_matrix((_np(a.values), _np(a.row_indices), _np(a.col_ptr)),
                       shape=a.shape).tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(s.indptr.astype(np.int64)),
        torch.from_numpy(s.indices.astype(np.int64)),
        torch.from_numpy(s.data.astype(np.float32)), size=s.shape,
        device=dev)


def group_work(kind, op):
    """(products, bytes) one launch needs: each B entry and each referenced
    A column read once, the output tiles written once."""
    import torch

    a_rows, _, a_nnz, b_rows, _, b_nnz = op["ab"]
    n_b, zb = b_rows.shape
    live = torch.arange(zb, device=b_rows.device)[None, :] < b_nnz[:, None]
    ks = b_rows[live].long()
    products = int(a_nnz[ks].sum())
    ref_cols = torch.unique(ks)
    a_bytes = int(a_nnz[ref_cols].sum()) * 8 + len(ref_cols) * 4
    b_bytes = int(live.sum()) * 8 + n_b * 4
    if kind == "spa":
        out_bytes = op["m"] * n_b * 4
    elif kind == "spars":
        out_bytes = 2 * op["m"] * n_b * 4 + 4 * (n_b // op["block"])
    else:
        out_bytes = 2 * op["h"] * n_b * 4 + 4 * (n_b // op["block"])
    return products, a_bytes + b_bytes + out_bytes


def bound_ms(products, nbytes):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * products / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_ms(kind, op, reps):
    """One PyTorch call computing the kernel's function: for SPA, the sparse
    A times the group's dense B columns; none computes SPARS's flags or
    HASH's tables."""
    import torch

    if kind != "spa":
        return None
    a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = op["ab"]
    n_a, za = a_rows.shape
    n_b, zb = b_rows.shape
    dev = a_vals.device
    a_live = torch.arange(za, device=dev)[None, :] < a_nnz[:, None]
    a_cols = torch.arange(n_a, device=dev)[:, None].expand(n_a, za)
    a_coo = torch.sparse_coo_tensor(
        torch.stack([a_rows[a_live].long(), a_cols[a_live]]), a_vals[a_live],
        (op["m"], n_a)).coalesce().to_sparse_csr()
    b_live = torch.arange(zb, device=dev)[None, :] < b_nnz[:, None]
    b_dense = torch.zeros((n_a, n_b), dtype=torch.float32, device=dev)
    lanes = torch.arange(n_b, device=dev)[:, None].expand(n_b, zb)
    b_dense.index_put_((b_rows[b_live].long(), lanes[b_live]), b_vals[b_live],
                       accumulate=True)
    want = run_plain("spa", op)[0]
    got = torch.sparse.mm(a_coo, b_dense)
    check(torch.allclose(got, want), "library SPA call disagrees")
    return event_ms(lambda: torch.sparse.mm(a_coo, b_dense), reps)


def timing_phase(plans, mats, plan_ms, dev, reps):
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.kernels import ops as kops

    runs = {"spa": kops.run_spa, "spars": kops.run_spars,
            "hash": kops.run_hash}
    biggest = {}
    for name in MATRICES:
        a = mats[name]
        a_dev = a.to(dev)
        a_csr = torch_csr(a, dev)
        lib = event_ms(lambda: torch.sparse.mm(a_csr, a_csr), reps)
        for method in METHODS:
            plan = plans[name, method]
            for _ in range(2):
                plan.execute(a, a)
            torch.cuda.synchronize()
            samples = []
            for _ in range(reps):
                t0 = time.perf_counter()
                plan.execute(a, a)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            syncs = host_syncs(lambda: plan.execute(a_dev, a_dev))
            per_kind = {}
            launches = {}
            for g, op in group_operands(plan, a):
                a_arrs, g_vals = op["ab"][:3], op["ab"][4]
                ms = event_ms(lambda: runs[g.kind](
                    g, a_arrs, g_vals, m=op["m"], block_cols=BLOCK_COLS),
                    reps=3)
                per_kind[g.kind] = per_kind.get(g.kind, 0.0) + ms
                launches[g.kind] = launches.get(g.kind, 0) + 1
                products, nbytes = group_work(g.kind, op)
                if products > biggest.get(g.kind, (0,))[0]:
                    biggest[g.kind] = (products, nbytes, name, method, g, op)
            print(json.dumps({
                "matrix": name, "method": method_name(method),
                "plan_ms": plan_ms[name, method],
                "execute_ms_median": statistics.median(samples),
                "execute_ms_min": min(samples), "host_syncs": syncs,
                "kernel_device_ms": per_kind, "launches": launches,
                "library_ms": lib}), flush=True)
    return biggest


def kernel_report(biggest, counts, errs, reps):
    import torch

    rows = []
    for kind, info in KERNELS.items():
        check(kind in biggest, f"{kind}: no main-path group to time")
        products, nbytes, name, method, g, op = biggest[kind]
        ms = event_ms(lambda: run_kernel(kind, op), reps)
        plain = event_ms(lambda: run_plain(kind, op), reps=2)
        b_ms, by = bound_ms(products, nbytes)
        rows.append(dict(
            info, launches=counts[info["name"]], max_abs_err=errs[kind],
            ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=library_ms(kind, op, reps),
            at=dict(matrix=name, method=method_name(method),
                    cols=len(g.cols), products=products, bytes=nbytes,
                    h=g.h)))
        torch.cuda.synchronize()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"FAIL: {src}/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.core import plan_spgemm
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"nvcc build and load of {len(_build.sources())} sources: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    mats = {name: integer_matrix(name, args.seed) for name in MATRICES}
    expected = {name: scipy_square(mats[name]) for name in MATRICES}
    print(f"synthesized {len(MATRICES)} Table-1 matrices and scipy A@A in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.zeros(1, device=dev)   # CUDA context up before plan times
    torch.cuda.synchronize()
    plans, plan_ms = {}, {}
    for name in MATRICES:
        for method in METHODS:
            t0 = time.perf_counter()
            plans[name, method] = plan_spgemm(
                mats[name], mats[name],
                *(() if method is None else (method,)), device=dev)
            torch.cuda.synchronize()
            plan_ms[name, method] = (time.perf_counter() - t0) * 1e3

    errs = kernel_phase(plans, mats, dev, args.seed)
    counts = main_path(mats, expected)
    biggest = timing_phase(plans, mats, plan_ms, dev, args.reps)
    rows = kernel_report(biggest, counts, errs, args.reps)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
