#!/usr/bin/env python3
"""Execute time and a profiler breakdown of the PyTorch port's spgemm() on one
NVIDIA card, for comparing two checkouts within one session.

    python3 benchmarks/torch_execute_profile.py [--src DIR] [--label TEXT]
        [--matrices NAME ...] [--method M] [--reps N] [--seed N]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (default:
this checkout's).  Operands are Table-1 matrices synthesized from ``--seed``
with integer values, already on the card.  Per matrix one JSON line gives the
quartiles of ``plan.execute`` (host clock, ending in a synchronize), the
device time per execute from ``torch.profiler``, the device's idle share
(1 - device time / median execute time; the profiled executes themselves
run slower), the ops with the most self device time and self host time,
and per kernel kind (spa, spars, hash) the device time of the plan's groups'
kernels summed over one execute, by CUDA events (mean of ``--reps``
launches of each group, output allocation included, queued behind a
device-side wait so that the host's launch overhead does not count), which
holds where the profiler drops kernel records.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def group_kernel_ms(plan, a, reps: int) -> dict:
    """Per kernel kind, the summed device time of one launch of each of the
    plan's groups on A's values, as the executor feeds them."""
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.kernels import ops
    from repro_torch.sparse.format import padded_values

    lay = plan.layout
    vals = a.values.to(plan.device, torch.float32)
    a_arrs = (lay.a_rows, padded_values(vals, lay.a_gather, lay.a_mask),
              lay.a_nnz)
    out: dict = {}
    for g in lay.groups:
        b_vals = padded_values(vals, g.b_vgather, g.b_vmask)
        run = getattr(ops, f"run_{g.kind}")

        def launch():
            run(g, a_arrs, b_vals, m=plan.shape[0], block_cols=BLOCK_COLS)

        launch()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)   # ~2.5 ms: the loop queues behind it
        start.record()
        for _ in range(reps):
            launch()
        stop.record()
        torch.cuda.synchronize()
        out[g.kind] = out.get(g.kind, 0.0) + start.elapsed_time(stop) / reps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, os.pardir, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--matrices", nargs="+",
                    default=["S40PI_n1", "cage9", "iprob"])
    ap.add_argument("--method", default="h-hash-256/256")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import plan_spgemm
    from repro_torch.sparse import CSC, synthesize_suitesparse

    dev = torch.device("cuda")
    for name in args.matrices:
        m, _ = synthesize_suitesparse(name, seed=args.seed)
        rng = np.random.default_rng(args.seed)
        vals = rng.integers(1, 4, size=m.nnz).astype(np.float32)
        a = CSC(torch.from_numpy(vals), m.row_indices, m.col_ptr,
                m.shape).to(dev)
        plan = plan_spgemm(a, a, args.method, device=dev)
        for _ in range(3):
            plan.execute(a, a)
        torch.cuda.synchronize()
        samples = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            plan.execute(a, a)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        n_prof = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                plan.execute(a, a)
            torch.cuda.synchronize()
        events = prof.key_averages()

        def device_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        # kernels and copies only: an op's own row repeats its kernels' time
        device_ms = sum(device_us(e) for e in events
                        if e.device_type != DeviceType.CPU) / 1e3 / n_prof
        top_dev = sorted(events, key=device_us, reverse=True)[:10]
        top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:10]
        kernel_ms = group_kernel_ms(plan, a, args.reps)
        q = statistics.quantiles(samples, n=4)
        print(json.dumps({
            "label": args.label, "matrix": name, "method": args.method,
            "groups": len(plan.layout.groups),
            "execute_ms": {"q1": q[0], "median": q[1], "q3": q[2]},
            "device_ms": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / q[1]),
            "kernel_ms": kernel_ms,
            "top_device_ms": [(e.key[:60], device_us(e) / 1e3 / n_prof)
                              for e in top_dev],
            "top_host_ms": [(e.key[:60], e.self_cpu_time_total / 1e3 / n_prof)
                            for e in top_cpu],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
