"""Quickstart on the port: the paper's SpGEMM algorithms through the public
API of ``repro_torch``.

    python examples/torch_quickstart.py                 # on the card
    python examples/torch_quickstart.py --device cpu    # plain versions

The port's copy of ``examples/quickstart.py``: a very sparse and a denser
synthetic matrix through every algorithm (the numpy host backend, and the
per-group kernels K2-K4 of the ``cuda`` backend), checked against the dense
oracle, beside the vector-machine model's time; then the plan/execute
split, ``method="auto"``, the torch stream (``backend="torch"``,
differentiable) and the mesh (``backend="mesh"``).  ``--device`` defaults
to the card and is refused without one; ``cpu`` runs each kernel's plain
PyTorch version on the host.

Plan/execute idiom: when the sparsity pattern repeats (iterative A·A
chains, static-weight serving), split the call::

    from repro_torch.core import plan_spgemm
    plan = plan_spgemm(a, b, "h-hash-256/256")   # symbolic phase, once
    c1 = plan.execute(a_vals_1, b_vals_1)        # numeric phase per value set

``spgemm()`` does this through a bounded LRU keyed on pattern fingerprints.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import plan_spgemm, preprocess, spgemm, \
    spgemm_dense  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.sparse import random_uniform_csc  # noqa: E402
from repro_torch.sparse.format import csc_equal  # noqa: E402
from repro_torch.vm import (  # noqa: E402
    DEFAULT_MACHINE, c_column_nnz, trace_esc, trace_hash, trace_hybrid,
    trace_spa, trace_spars,
)

METHODS = ("spa", "spars-40/40", "hash-256/256", "h-spa-40/40",
           "h-hash-256/256", "esc")


def synced(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def modeled_seconds(a, method):
    cn = c_column_nnz(a, a)
    if method == "spa":
        return DEFAULT_MACHINE.seconds(trace_spa(a, a, c_nnz=cn))
    if method == "esc":
        return DEFAULT_MACHINE.seconds(trace_esc(a, a))
    fam, bounds = method.rsplit("-", 1)
    b_min, b_max = (int(x) for x in bounds.split("/"))
    t = 40.0 if fam.startswith("h-") else np.inf
    pre = preprocess(a, a, t=t, b_min=b_min, b_max=b_max)
    if fam == "spars":
        return DEFAULT_MACHINE.seconds(trace_spars(a, a, pre, c_nnz=cn))
    if fam == "hash":
        return DEFAULT_MACHINE.seconds(trace_hash(a, a, pre, c_nnz=cn))
    acc = "hash" if "hash" in fam else "spa"
    return DEFAULT_MACHINE.seconds(
        trace_hybrid(a, a, pre, accumulator=acc, c_nnz=cn))


def methods_table(dev, n):
    """Every algorithm on the host backend and (but for the host-only esc)
    the cuda backend's kernels, against the dense oracle."""
    for z, label in ((2, "very sparse (Z=2 nnz/col)"),
                     (10, "denser (Z=10 nnz/col)")):
        a = random_uniform_csc(n, z, seed=z)
        ref = spgemm_dense(a, a)
        t_spa = modeled_seconds(a, "spa")
        print(f"\n=== {label}: C = A @ A, A is {n}x{n} ===")
        print(f"{'method':16s} {'host':>5s} {'cuda':>5s} "
              f"{'model-time':>11s} {'vs SPA':>7s}")
        for m in METHODS:
            c = spgemm(a, a, method=m, backend="host")
            ok = csc_equal(c, ref, rtol=1e-9)
            ok_k = "-"
            if m != "esc":  # the kernels cover the accumulator families
                ck = spgemm(a, a, method=m, device=dev)
                ok_k = "OK" if csc_equal(ck, ref, rtol=1e-4, atol=1e-5) \
                    else "FAIL"
            t = modeled_seconds(a, m)
            print(f"{m:16s} {'OK' if ok else 'FAIL':>5s} {ok_k:>5s} "
                  f"{t*1e3:9.2f}ms {t_spa/t:6.2f}x")
    print("\n(model-time = calibrated 8-lane VL-256 vector machine)")


def plan_reuse_demo(dev, n):
    """The plan/execute split on a repeated-pattern workload."""
    a = random_uniform_csc(n, 4, seed=1)
    t0 = time.perf_counter()
    plan = plan_spgemm(a, a, "h-hash-256/256", device=dev)
    synced(dev)
    t_plan = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    t_exec = 0.0
    reps = 3
    for _ in range(reps):  # same pattern, fresh values each round
        vals = torch.from_numpy(rng.normal(size=a.nnz).astype(np.float32))
        t0 = time.perf_counter()
        plan.execute(vals, vals)
        synced(dev)
        t_exec += time.perf_counter() - t0
    print(f"\n=== plan reuse (A {n}x{n}, h-hash-256/256 on {dev}) ===")
    print(f"symbolic plan (once):     {t_plan*1e3:7.2f}ms")
    print(f"numeric execute (/call):  {t_exec/reps*1e3:7.2f}ms "
          f"- pre-processing amortized over every same-pattern call")


def auto_method_demo(dev):
    """method="auto": per-tile method choice on a mixed-density matrix on
    the host backend (its "torch"/"fused" tiles on ``dev``).  The guard is
    scaled to this demo's size so both regimes show: tiles whose stream
    fits it can take the stream engines, guard-tripped flop-heavy blocks
    fall back to SPA."""
    from repro_torch.core import fast, plan_spgemm_tiled
    from repro_torch.sparse.format import csc_from_dense

    rng = np.random.default_rng(0)
    m, heavy, dense_b, n = 192, 24, 48, 768
    old_guard = fast.STREAM_MAX_PRODUCTS
    fast.STREAM_MAX_PRODUCTS = (dense_b * 16 * m) // 8
    ad = np.zeros((m, m))
    ad[:, :heavy] = rng.uniform(0.5, 1.5, size=(m, heavy))  # heavy cols
    for j in range(heavy, m):
        ad[rng.integers(m, size=2), j] = 1.0
    bd = np.zeros((m, n))
    for j in range(dense_b):    # a dense B block hits the heavy A columns
        bd[rng.integers(heavy, size=16), j] = 1.0
    for j in range(dense_b, n):  # a long sparse tail hits the light ones
        bd[heavy + rng.integers(m - heavy, size=2), j] = 1.0
    a, b = csc_from_dense(ad), csc_from_dense(bd)
    print(f"\n=== method='auto' (mixed density: {dense_b} flop-heavy + "
          f"{n - dense_b} sparse columns) ===")
    rows = []
    for method in ("spa", "expand"):
        plan = plan_spgemm(a, b, method, backend="host")
        plan.execute(a, b)   # warmup: the plan's lazy state
        t0 = time.perf_counter()
        plan.execute(a, b)
        rows.append((method, time.perf_counter() - t0, ""))
    tiled = plan_spgemm_tiled(a, b, backend="host", tile=(None, 96),
                              device=dev)
    stats = {}
    tiled.execute(a, b)      # warmup
    t0 = time.perf_counter()
    tiled.execute(a, b, stats=stats)
    rows.append(("auto", time.perf_counter() - t0,
                 f"per-tile: {stats['methods']}"))
    fast.STREAM_MAX_PRODUCTS = old_guard
    for name, t, note in rows:
        print(f"{name:8s} {t*1e3:8.2f}ms  {note}")


def torch_stream_demo(dev):
    """backend="torch": the plan's product stream in PyTorch ops, its
    gradients two more replays through torch.autograd."""
    a = random_uniform_csc(256, 6, seed=3)
    vals = torch.from_numpy(np.asarray(a.values, np.float32)).to(dev)
    plan = plan_spgemm(a, a, "expand", backend="torch", device=dev)
    t0 = time.perf_counter()
    plan.execute(vals, vals)
    synced(dev)
    t_warm = time.perf_counter() - t0          # the stream's build and lift
    t0 = time.perf_counter()
    plan.execute(vals, vals)
    synced(dev)
    t_steady = time.perf_counter() - t0
    x = vals.clone().requires_grad_()
    y = vals.clone().requires_grad_()
    ga, gb = torch.autograd.grad(plan.stream_apply(x, y).sum(), (x, y))
    print(f"\n=== backend='torch' (A 256x256, the stream on {dev}) ===")
    print(f"warmup (build + lift):    {t_warm*1e3:7.2f}ms  (once)")
    print(f"steady state (/call):     {t_steady*1e3:7.2f}ms")
    print(f"grad(sum C) shapes:       dA {tuple(ga.shape)}, "
          f"dB {tuple(gb.shape)} - SpGEMM is differentiable")


def mesh_demo(dev):
    """backend="mesh": the multiply sharded, each shard replaying its slice
    of the stream, the partials reduced in shard order.  ``device=None``
    puts one shard on each visible card; naming a device puts every shard
    there, which is how four shards run here."""
    from repro_torch.core import plan_cache_clear

    shards = 4
    a = random_uniform_csc(384, 5, seed=7)
    c = spgemm(a, a, "expand", backend="mesh", shards=shards, device=dev)
    ref = spgemm(a, a, "expand", backend="host", engine="stream")
    ok = csc_equal(c, ref, rtol=1e-6)
    again = spgemm(a, a, "expand", backend="mesh", shards=shards, device=dev,
                   cache=False)
    stable = torch.equal(c.values, again.values)
    print(f"\n=== backend='mesh' (A 384x384 over {shards} shards on {dev}) "
          "===")
    print(f"sharded == host stream:   {'OK' if ok else 'FAIL'}; "
          f"bit-stable: {'OK' if stable else 'FAIL'} (the shard-ordered "
          "reduction is fixed by the plan)")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"{cards} card(s) visible: backend='mesh' with device=None runs "
          "one shard a card")
    plan_cache_clear()
    return ok and stable


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--n", type=int, default=640,
                    help="order of the methods table's matrices")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    methods_table(dev, args.n)
    plan_reuse_demo(dev, args.n)
    auto_method_demo(dev)
    torch_stream_demo(dev)
    if not mesh_demo(dev):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
