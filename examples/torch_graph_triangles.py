"""Graph analytics with SpGEMM on the port: triangle counting through A@A
restricted to edges (triangles = sum of (A@A) * A / 6 for an undirected
simple graph), and the plan-reuse idiom for a graph whose pattern is fixed
while its edge weights change: the A·A pre-processing (sort, block, size
hash tables, kernel layouts) is paid once and every weight update runs only
the numeric phase, all updates in one batched execution.

    python examples/torch_graph_triangles.py                 # on the card
    python examples/torch_graph_triangles.py --device cpu    # plain versions

The port's copy of ``examples/graph_triangles.py``, with its graph, methods
and weights.  ``--device`` defaults to the card and is refused without one;
``cpu`` runs each kernel's plain PyTorch version on the host.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import plan_spgemm, spgemm  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.sparse.format import CSC, _np, csc_from_dense, \
    csc_to_dense  # noqa: E402


def random_graph(n=300, p=0.02, seed=0):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.uniform(size=(n, n)) < p, k=1)
    return (upper | upper.T).astype(np.float32)


def count_triangles(adj, dev):
    a = csc_from_dense(adj)
    print(f"graph: {a.n_rows} nodes, {a.nnz // 2} edges")
    ref = int(np.round(np.trace(adj.astype(np.float64) @ adj @ adj) / 6))
    ok = True
    for method in ("spa", "h-spa-40/40", "h-hash-256/256"):
        c = spgemm(a, a, method=method, device=dev)   # paths of length 2
        paths2 = csc_to_dense(c).cpu().double().numpy()
        tri = int(np.round((paths2 * adj).sum() / 6))
        ok &= tri == ref
        status = "OK" if tri == ref else "MISMATCH"
        print(f"  {method:16s} triangles={tri} ({status})")
    print(f"reference (dense): {ref}")
    return a, ok


def weighted_walk_reuse(a, dev, trials=5, method="spa"):
    """Re-execute A@A as edge weights change (the same pattern each tick):
    one symbolic plan serves every tick, and the ticks run as one batched
    execution (``execute_batched``, one launch a kernel group for all of
    them) that must equal a loop of executes, and fresh calls, bit for
    bit."""
    print(f"\nplan reuse: weighted 2-walks, {trials} weight updates, "
          f"method={method} on {dev}")
    t0 = time.perf_counter()
    plan = plan_spgemm(a, a, method, device=dev)   # symbolic, once
    t_plan = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    weights = torch.from_numpy(
        rng.uniform(0.5, 1.5, size=(trials, a.nnz)).astype(np.float32)
    ).to(dev)
    t0 = time.perf_counter()
    cs = plan.execute_batched(weights, weights)    # numeric only, one pass
    t_batch = time.perf_counter() - t0
    t_loop = 0.0
    for trial, w in enumerate(weights):
        aw = CSC(w, a.row_indices, a.col_ptr, a.shape)
        t0 = time.perf_counter()
        c = plan.execute(w, w)              # the per-tick loop
        t_loop += time.perf_counter() - t0
        c_fresh = spgemm(aw, aw, method=method, cache=False, device=dev)
        for other, label in ((c_fresh, "fresh call"),
                             (cs[trial], "batched execution")):
            same = (np.array_equal(_np(c.col_ptr), _np(other.col_ptr))
                    and np.array_equal(_np(c.values)[: c.nnz],
                                       _np(other.values)[: other.nnz]))
            if not same:
                print(f"  trial {trial}: {label} diverged from execute()")
                return False
    print(f"  symbolic plan, paid once:     {t_plan*1e3:7.2f}ms")
    print(f"  looped execute, per tick:     {t_loop/trials*1e3:7.2f}ms")
    print(f"  batched execute, per tick:    {t_batch/trials*1e3:7.2f}ms "
          f"({t_loop/max(t_batch, 1e-9):.1f}x; matches the loop bit for "
          "bit)")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    a, ok = count_triangles(random_graph(), dev)
    ok &= weighted_walk_reuse(a, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
