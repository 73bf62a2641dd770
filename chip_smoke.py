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
   exactly equal; K1 (the fused stream replay) likewise on the forward and
   both gradient views of every matrix's product stream, plus edge cases.
3. Main path: C = A·A through ``repro_torch.core.spgemm`` for eleven of the
   paper's Table-1 matrices (synthesized from their published statistics,
   integer values in {1, 2, 3} from ``--seed``) under the default method and
   four others; every C must equal ``scipy.sparse`` A@A in f64 exactly, and
   every per-group kernel's launch count must rise during this phase.
4. Fused path: ``spgemm(A, A, engine="fused")`` for the eleven matrices,
   each equal to scipy exactly and in structure to the per-group result;
   K1 must launch during this phase.  ``iprob`` (9.0M products, past the
   default stream guard) takes the transient path.
5. Backward: ``torch.autograd.grad`` of ``sum(w * plan.stream_apply(x, x,
   engine="fused"))`` on ``cage9`` must equal the dense-matmul gradient in
   f64 on the CPU exactly, with three K1 launches (forward and two grads).
6. Timing: per matrix and method, the host plan time, the execute time
   (median of ``--reps``), the host syncs of one execute on operands
   already on the card, each kernel's device time (CUDA events) and
   ``torch.sparse.mm(A, A)`` as ``library_ms``, a yardstick the port never
   calls; per matrix, the fused execute beside them (0 host syncs required)
   with its device time and idle share (``torch.profiler``) and K1's time
   on each view; per kernel, its time, its plain version's, its bound and a
   library call's, at its largest main-path group or view.

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
    "fused": dict(name="fused_stream", route="cuda",
                  source="src/repro_torch/csrc/fused_stream.cu",
                  replaces="src/repro/core/pallas_stream.py:244"),
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
GROUP_KERNELS = ("spa", "spars", "hash")   # the per-group path's
BACKWARD_MATRIX = "cage9"   # the backward phase's mid-size matrix
GUARDED_MATRIX = "iprob"    # 9.0M products, past the default stream guard


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
    errs = {k: 0.0 for k in GROUP_KERNELS}
    checked = {k: 0 for k in GROUP_KERNELS}
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
        for kind in GROUP_KERNELS:
            errs[kind] = max(errs[kind], compare(kind, op, name))
            checked[kind] += 1
    for kind in GROUP_KERNELS:
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
    for kind in GROUP_KERNELS:
        name = KERNELS[kind]["name"]
        check(counts[name] > 0, f"{name} was not launched on the main path")
    return counts


# ---------------------------------------------------------------------------
# the fused engine (K1)
# ---------------------------------------------------------------------------


def fused_plans(mats, dev):
    """Per matrix, a plan whose stream guard admits all its products, with
    its K1 views built: the plan, its plan and view-build times, its product
    count, and whether the guard had to be raised above the default."""
    import torch
    from repro_torch.core import fast, fused_stream, plan_spgemm
    from repro_torch.core.expand import product_count
    from repro_torch.sparse.format import _np

    out = {}
    for name in MATRICES:
        a = mats[name]
        products = product_count(_np(a.col_ptr), _np(a.col_ptr),
                                 _np(a.row_indices))
        t0 = time.perf_counter()
        plan = plan_spgemm(a, a, device=dev, stream_limit=max(
            products, fast.STREAM_MAX_PRODUCTS))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused_stream(plan)
        torch.cuda.synchronize()
        out[name] = dict(plan=plan, plan_ms=(t1 - t0) * 1e3,
                         view_build_ms=(time.perf_counter() - t1) * 1e3,
                         products=products,
                         guard_raised=products > fast.STREAM_MAX_PRODUCTS)
    return out


def view_operands(plan, a, seed):
    """(values, view name, view, x, y) of the three K1 views of ``plan``
    (C = A·A) as the engine feeds them, on A's integer values and on normal
    values of the same pattern: forward x = y = A's values; the gradient
    views x = an output cotangent (integer or normal, from ``seed``), y =
    A's values."""
    import torch
    from repro_torch.core import fused_stream

    fs = fused_stream(plan)
    dev = plan.device
    rng = np.random.default_rng([seed, 2])
    n_c = fs.forward.n_out
    for kind, m, g in (
            ("int", a, rng.integers(1, 4, n_c)),
            ("real", real_valued(a, seed), rng.standard_normal(n_c))):
        v = m.values.to(dev, torch.float32)
        g = torch.from_numpy(g.astype(np.float32)).to(dev)
        yield kind, "forward", fs.forward, v, v
        yield kind, "grad_a", fs.grad_a, g, v
        yield kind, "grad_b", fs.grad_b, g, v


def run_k1(view, x, y):
    from repro_torch import kernels

    return kernels.fused_stream(view.idx_x, view.idx_y, view.seg_ptr, x, y)


def run_k1_plain(view, x, y):
    from repro_torch import kernels

    return kernels.fused_stream_plain(view.idx_x, view.idx_y, view.seg_ptr,
                                      x, y)


def compare_k1(view, x, y, label):
    """K1 vs its plain version on the same tensors; max |difference|."""
    import torch

    got = run_k1(view, x, y)
    torch.cuda.synchronize()
    want = run_k1_plain(view, x, y)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (view.n_out,)
          and got.dtype == want.dtype == torch.float32,
          f"fused_stream {label}: shape/dtype {got.shape}/{got.dtype} vs "
          f"{want.shape}/{want.dtype}")
    check(torch.equal(got, want),
          f"fused_stream {label}: kernel != plain version")
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def k1_edge_views(dev):
    """K1 views of the edge cases, and normal values for them: zero
    products, one segment spanning the whole stream, many one-product
    segments, and empty segments between full ones."""
    import torch
    from repro_torch.core.fused_stream import FusedView

    rng = np.random.default_rng(4)
    n_val = 1000

    def view(seg_ptr):
        p = int(seg_ptr[-1])

        def lift(v):
            return torch.as_tensor(np.asarray(v, np.int32), device=dev)

        return FusedView(lift(rng.integers(0, n_val, p)),
                         lift(rng.integers(0, n_val, p)), lift(seg_ptr),
                         None, len(seg_ptr) - 1, p)

    lens = rng.integers(0, 4, 5000)
    cases = {
        "zero_products": view(np.zeros(4)),
        "one_segment": view(np.array([0, 20_000])),
        "one_product_segments": view(np.arange(200_001)),
        "empty_segments": view(np.concatenate(([0], np.cumsum(lens)))),
    }
    x, y = (torch.from_numpy(rng.standard_normal(n_val).astype(np.float32))
            .to(dev) for _ in range(2))
    return cases, x, y


def fused_kernel_phase(fplans, mats, dev, seed):
    """K1 against its plain version on the forward and both gradient views
    of every matrix, on integer and normal values, and the edge cases."""
    err, checked = 0.0, 0
    for name in MATRICES:
        for kind, vname, view, x, y in view_operands(
                fplans[name]["plan"], mats[name], seed):
            err = max(err, compare_k1(view, x, y,
                                      f"{name} {vname}, {kind} values"))
            checked += 1
    cases, x, y = k1_edge_views(dev)
    for label, view in cases.items():
        err = max(err, compare_k1(view, x, y, label))
        checked += 1
    print(f"kernel fused_stream: {checked} comparisons with the plain "
          f"version, max |diff| {err}", flush=True)
    return err


def fused_path(mats, expected):
    """C = A·A through spgemm(engine="fused") for every matrix; exact
    check against scipy and against the per-group result's structure."""
    from repro_torch import kernels
    from repro_torch.core import cached_plan, spgemm
    from repro_torch.sparse.format import _np

    kernels.reset_launch_counts()
    results = {name: spgemm(mats[name], mats[name], engine="fused")
               for name in MATRICES}
    counts = kernels.launch_counts()
    for name, c in results.items():
        indptr, indices, data = expected[name]
        label = f"{name} engine=fused"
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
        naive = spgemm(mats[name], mats[name])
        for f in ("col_ptr", "row_indices"):
            check(np.array_equal(_np(getattr(c, f)), _np(getattr(naive, f))),
                  f"{label}: {f} differs from the per-group result")
    a = mats[GUARDED_MATRIX]
    plan = cached_plan(a, a)
    stats: dict = {}
    plan.execute(a, a, engine="fused", stats=stats)
    check(plan.stream is None and not stats["stream_cached"]
          and plan.fused_stream_nbytes == 0,
          f"{GUARDED_MATRIX} did not take the transient path past the "
          "stream guard")
    print(f"fused path: {len(MATRICES)} matrices equal scipy A@A and the "
          f"per-group structure exactly; {GUARDED_MATRIX} "
          f"({stats['stream_products']} "
          f"products > stream_limit {plan.stream_limit}) ran transiently; "
          f"launches {json.dumps(counts)}", flush=True)
    check(counts["fused_stream"] == len(MATRICES),
          f"fused_stream launched {counts['fused_stream']} times for "
          f"{len(MATRICES)} fused executes")
    for kind in GROUP_KERNELS:
        check(counts[KERNELS[kind]["name"]] == 0,
              f"the fused path launched {KERNELS[kind]['name']}")
    return counts


def stored_coords(row_indices, col_ptr):
    import torch
    from repro_torch.sparse.format import _np

    cp = _np(col_ptr).astype(np.int64)
    rows = torch.from_numpy(_np(row_indices)[: cp[-1]].astype(np.int64))
    cols = torch.from_numpy(np.repeat(np.arange(len(cp) - 1), np.diff(cp)))
    return rows, cols


def backward_phase(mats, dev, seed):
    """One backward through plan.stream_apply(engine="fused") on the card,
    against the dense-matmul gradient in f64 on the CPU, exactly."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import cached_plan, fused_stream

    a = mats[BACKWARD_MATRIX]
    plan = cached_plan(a, a)
    fs = fused_stream(plan)
    check(fs is not None, f"{BACKWARD_MATRIX}: no stream under the guard")
    rng = np.random.default_rng([seed, 3])
    x_np = rng.integers(1, 4, a.nnz).astype(np.float32)
    w_np = rng.integers(1, 4, fs.forward.n_out).astype(np.float32)
    kernels.reset_launch_counts()
    x = torch.from_numpy(x_np).to(dev).requires_grad_()
    w = torch.from_numpy(w_np).to(dev)
    c = plan.stream_apply(x, x, engine="fused")
    g, = torch.autograd.grad((w * c).sum(), x)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["fused_stream"]

    xd = torch.from_numpy(x_np).double().requires_grad_()
    ad = torch.zeros(a.shape, dtype=torch.float64).index_put(
        stored_coords(a.row_indices, a.col_ptr), xd)
    c_at = stored_coords(fs.c_rows, fs.c_col_ptr)
    wd = torch.zeros(a.shape, dtype=torch.float64).index_put(
        c_at, torch.from_numpy(w_np).double())
    prod = ad @ ad
    gd, = torch.autograd.grad((wd * prod).sum(), xd)
    check(torch.equal(c.detach().cpu().double(), prod.detach()[c_at]),
          f"{BACKWARD_MATRIX}: fused forward differs from the dense product")
    check(torch.equal(g.cpu().double(), gd),
          f"{BACKWARD_MATRIX}: fused gradient differs from the dense-matmul "
          f"gradient (max |diff| "
          f"{float((g.cpu().double() - gd).abs().max())})")
    check(launches == 3, f"backward launched fused_stream {launches} times, "
          "not 3 (forward, grad_a, grad_b)")
    print(f"backward: d sum(w * C) / dx through stream_apply(engine='fused') "
          f"on {BACKWARD_MATRIX} ({fs.n_products} products) equals the "
          f"dense-matmul gradient in f64 exactly; fused_stream launches "
          f"{launches}", flush=True)
    return launches


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


def execute_ms(fn, reps):
    """Host-clock samples of ``fn`` ending in a synchronize, after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return samples


def timing_phase(plans, mats, plan_ms, dev, reps):
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.kernels import ops as kops

    runs = {"spa": kops.run_spa, "spars": kops.run_spars,
            "hash": kops.run_hash}
    biggest, medians, libs = {}, {}, {}
    for name in MATRICES:
        a = mats[name]
        a_dev = a.to(dev)
        a_csr = torch_csr(a, dev)
        lib = libs[name] = event_ms(lambda: torch.sparse.mm(a_csr, a_csr),
                                    reps)
        for method in METHODS:
            plan = plans[name, method]
            samples = execute_ms(lambda: plan.execute(a, a), reps)
            medians[name, method] = statistics.median(samples)
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
    return biggest, medians, libs


def k1_work(view, x, y):
    """(products, bytes) one K1 replay needs: both index vectors (8 B a
    product), each element of x and y that the view gathers read once (in
    the forward view of A·A, x and y are one vector), the offsets and the
    output, each once."""
    import torch

    if x.data_ptr() == y.data_ptr():
        gathered = torch.unique(torch.cat([view.idx_x, view.idx_y])).numel()
    else:
        gathered = (torch.unique(view.idx_x).numel()
                    + torch.unique(view.idx_y).numel())
    nbytes = (8 * view.n_products + 4 * gathered + 4 * (view.n_out + 1)
              + 4 * view.n_out)
    return view.n_products, nbytes


def profiled_device_ms(fn, n=3) -> float:
    """Device time (kernels and copies) per call of ``fn``, from
    torch.profiler, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels and copies only: an op's own row repeats its kernels' time
    return sum(device_us(e) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3 / n


def fused_timing_phase(fplans, mats, dev, reps, naive_ms, libs):
    """Per matrix, the fused execute (views built, operands on the card)
    beside the default method's per-group execute and torch.sparse.mm, its
    host syncs (must be 0) and K1's device time on each view; then iprob's
    fused execute under the default guard, which rebuilds the stream each
    time.  Returns, per view, the largest (products) view timed."""
    import torch
    from repro_torch.core import cached_plan, fused_stream

    biggest = {}
    for name in MATRICES:
        f = fplans[name]
        plan = f["plan"]
        a = mats[name]
        a_dev = a.to(dev)
        # operands on the host, as the per-group timing above, and on the
        # card, as a caller that keeps its values there
        samples = execute_ms(lambda: plan.execute(a, a, engine="fused"),
                             reps)
        on_card = execute_ms(
            lambda: plan.execute(a_dev, a_dev, engine="fused"), reps)
        syncs = host_syncs(lambda: plan.execute(a_dev, a_dev,
                                                engine="fused"))
        check(syncs == 0, f"{name}: a fused execute on the card made "
              f"{syncs} host syncs")
        device_ms = profiled_device_ms(
            lambda: plan.execute(a_dev, a_dev, engine="fused"))
        fs = fused_stream(plan)
        v = a_dev.values
        g = torch.ones(fs.forward.n_out, dtype=torch.float32, device=dev)
        k1_ms = {}
        for vname, view, x in (("forward", fs.forward, v),
                               ("grad_a", fs.grad_a, g),
                               ("grad_b", fs.grad_b, g)):
            k1_ms[vname] = event_ms(lambda: run_k1(view, x, v), reps)
            if view.n_products > biggest.get(vname, (0,))[0]:
                biggest[vname] = (view.n_products, name, view, x, v)
        print(json.dumps({
            "matrix": name, "engine": "fused",
            "stream_limit": plan.stream_limit,
            "guard_raised_above_default": f["guard_raised"],
            "products": f["products"], "plan_ms": f["plan_ms"],
            "view_build_ms": f["view_build_ms"],
            "execute_ms_median": statistics.median(samples),
            "execute_ms_min": min(samples),
            "execute_on_card_ms_median": statistics.median(on_card),
            # of one execute on the card, from the profiler's device time
            "device_ms": device_ms,
            "device_idle_share": max(
                0.0, 1 - device_ms / statistics.median(on_card)),
            "host_syncs": syncs, "k1_device_ms": k1_ms,
            "naive_execute_ms_median": naive_ms[name, DEFAULT],
            "library_ms": libs[name]}), flush=True)
    a = mats[GUARDED_MATRIX]
    plan = cached_plan(a, a)
    samples = execute_ms(lambda: plan.execute(a, a, engine="fused"), reps=3)
    print(json.dumps({
        "matrix": GUARDED_MATRIX, "engine": "fused", "path": "transient",
        "stream_limit": plan.stream_limit,
        "execute_ms_median": statistics.median(samples),
        "execute_ms_min": min(samples)}), flush=True)
    return biggest


def kernel_report(biggest, counts, errs, reps):
    import torch

    rows = []
    for kind in GROUP_KERNELS:
        info = KERNELS[kind]
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


def k1_report(biggest, launches, err, libs, reps):
    """K1's row of the kernels line: timed at its largest forward view,
    with the largest gradient views beside it.  One PyTorch call computes
    the forward view's function (torch.sparse.mm(A, A)); none computes a
    gradient view's."""
    import torch

    timed = {}
    for vname in ("forward", "grad_a", "grad_b"):
        check(vname in biggest, f"fused_stream: no {vname} view to time")
        products, name, view, x, y = biggest[vname]
        ms = event_ms(lambda: run_k1(view, x, y), reps)
        plain = event_ms(lambda: run_k1_plain(view, x, y), reps=2)
        work = k1_work(view, x, y)
        b_ms, by = bound_ms(*work)
        timed[vname] = dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
            library_ms=libs[name] if vname == "forward" else None,
            at=dict(matrix=name, view=vname, products=products,
                    segments=view.n_out, bytes=work[1]))
        torch.cuda.synchronize()
    fwd = timed.pop("forward")
    return dict(KERNELS["fused"], launches=launches, max_abs_err=err,
                **fwd, grad_views=timed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
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

    fplans = fused_plans(mats, dev)

    errs = kernel_phase(plans, mats, dev, args.seed)
    k1_err = fused_kernel_phase(fplans, mats, dev, args.seed)
    counts = main_path(mats, expected)
    fused_counts = fused_path(mats, expected)
    backward_phase(mats, dev, args.seed)
    biggest, naive_ms, libs = timing_phase(plans, mats, plan_ms, dev,
                                           args.reps)
    k1_biggest = fused_timing_phase(fplans, mats, dev, args.reps, naive_ms,
                                    libs)
    rows = [k1_report(k1_biggest, fused_counts["fused_stream"], k1_err, libs,
                      args.reps)]
    rows += kernel_report(biggest, counts, errs, args.reps)
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, build "
          "included", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
