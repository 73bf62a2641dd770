"""Table 1 on the port's vector-machine model: 40 SuiteSparse-stat matrices x
10 algorithms.

    python3 benchmarks/torch_table1.py [--seed N] [--verbose]

Prints per-matrix modeled SPA seconds and speedups vs SPA for the paper's nine
algorithm columns, next to the paper's published numbers, plus the average-
speedup rows and the prior-work HASH comparison (Section 5.3's 52% claim),
as the CSV ``table,name,algo,predicted,paper``.  Everything runs on the host:
the matrices are synthesized from their published statistics
(``repro_torch.sparse.suitesparse``), traced by ``repro_torch.vm.schedule``
and priced by ``repro_torch.vm.machine``.  Traces depend only on structure,
so they are cached (with the matrices) under ``.cache/torch_table1/`` of the
repository (``$REPRO_CACHE`` moves the ``.cache`` root).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.analysis import hash_table_size, preprocess  # noqa: E402
from repro_torch.sparse.format import CSC  # noqa: E402
from repro_torch.sparse.suitesparse import (  # noqa: E402
    SUITESPARSE_TABLE1,
    TABLE1_AVERAGE_SPEEDUPS,
    load_or_synthesize,
)
from repro_torch.vm.machine import DEFAULT_MACHINE  # noqa: E402
from repro_torch.vm.schedule import (  # noqa: E402
    c_column_nnz,
    trace_esc,
    trace_hash,
    trace_hybrid,
    trace_spa,
    trace_spars,
)
from repro_torch.vm.trace import Trace  # noqa: E402

CACHE = os.path.join(os.environ.get("REPRO_CACHE", os.path.join(ROOT,
                                                                 ".cache")),
                      "torch_table1")

# paper Table 1 column order
PAPER_ALGOS = (
    "spars-16/64", "spars-40/40", "h-spa-16/64", "h-spa-40/40",
    "hash-32/256", "hash-256/256", "h-hash-32/256", "h-hash-256/256", "esc",
)

# the paper's average speedups over the 22 sparsest matrices (Section 5.3)
PAPER_AVG22 = {"h-spa-40/40": 1.42, "h-hash-256/256": 1.99,
               "spars-40/40": 1.38, "spars-16/64": 1.34,
               "hash-256/256": 1.85, "hash-32/256": 1.88}


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    family: str          # spa | spars | hash | h-spa | h-hash | esc | hash-sota
    t: float = np.inf
    b_min: int = 256
    b_max: int = 256
    sort: bool = True


def algo_spec(name: str) -> AlgoSpec:
    if name == "spa":
        return AlgoSpec("spa")
    if name == "esc":
        return AlgoSpec("esc")
    if name == "hash-sota":
        return AlgoSpec("hash-sota", b_min=256, b_max=256, sort=False)
    fam, bounds = name.rsplit("-", 1)
    b_min, b_max = (int(x) for x in bounds.split("/"))
    t = 40.0 if fam.startswith("h-") else np.inf
    return AlgoSpec(fam, t=t, b_min=b_min, b_max=b_max)


def build_trace(a: CSC, b: CSC, name: str) -> Trace:
    """The trace of a named algorithm on C = A @ B."""
    s = algo_spec(name)
    cn = c_column_nnz(a, b)
    if s.family == "spa":
        return trace_spa(a, b, c_nnz=cn)
    if s.family == "esc":
        return trace_esc(a, b)
    if s.family == "hash-sota":
        # prior work [31]: no sorting, fixed power-of-two table sized once
        # from the global max column load
        pre = preprocess(a, b, t=np.inf, b_min=s.b_min, b_max=s.b_max,
                         sort=False)
        H = hash_table_size(int(pre.ops.max()))
        pre = dataclasses.replace(
            pre, hash_sizes=np.full(pre.blocks.n_blocks, H, np.int64))
        return trace_hash(a, b, pre, c_nnz=cn)
    pre = preprocess(a, b, t=s.t, b_min=s.b_min, b_max=s.b_max, sort=s.sort)
    if s.family == "spars":
        return trace_spars(a, b, pre, c_nnz=cn)
    if s.family == "hash":
        return trace_hash(a, b, pre, c_nnz=cn)
    if s.family == "h-spa":
        return trace_hybrid(a, b, pre, accumulator="spa", c_nnz=cn)
    if s.family == "h-hash":
        return trace_hybrid(a, b, pre, accumulator="hash", c_nnz=cn)
    raise ValueError(name)


_KIND_IDS = {k: i for i, k in enumerate(
    ("valu", "vfma", "vload", "vstore", "vload_idx", "vstore_idx", "scalar"))}


def trace_arrays(t: Trace):
    """(kind ids, vector lengths, working sets, counts) of a trace."""
    kinds, vls, wss, counts = [], [], [], []
    for (kind, vl, ws), c in t.counts.items():
        kinds.append(_KIND_IDS[kind])
        vls.append(vl)
        wss.append(ws)
        counts.append(c)
    return (np.asarray(kinds), np.asarray(vls, np.float64),
            np.asarray(wss, np.float64), np.asarray(counts, np.float64))


def price(arrays, mach) -> float:
    """Machine.seconds over trace arrays, vectorized."""
    kinds, vls, wss, counts = arrays
    beats = np.array([mach.beat_alu, mach.beat_fma, mach.beat_mem,
                      mach.beat_mem, mach.beat_idx, mach.beat_idx, 0.0])
    groups = np.ceil(vls / mach.lanes)
    is_idx = (kinds >= 4) & (kinds <= 5) & (wss > 0)
    sub = np.zeros_like(wss)
    np.log2(np.clip(np.minimum(wss, mach.l2_bytes) / mach.range_log_base,
                    1.0, None), out=sub, where=is_idx)
    resident = np.where(wss > 0, np.minimum(1.0, mach.l2_bytes /
                                            np.maximum(wss, 1.0)), 1.0)
    factor = np.where(
        is_idx,
        1.0 + mach.range_log_coef * sub + mach.miss_penalty * (1 - resident),
        1.0)
    per = mach.issue + groups * beats[kinds] * factor
    per = np.where(kinds == 6, mach.scalar_cpi, per)
    return float((per * counts).sum()) / mach.clock_hz


def _load_entry(path: str) -> dict:
    """A cached trace entry, or ``{}`` when there is none or it does not
    read (it is then traced again)."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        return {}


def table1_traces(algos=("spa",) + PAPER_ALGOS, seed: int = 0,
                  verbose=False):
    """{matrix_name: {algo: trace_arrays}} for the Table-1 matrices."""
    os.makedirs(os.path.join(CACHE, "traces"), exist_ok=True)
    out = {}
    for spec in SUITESPARSE_TABLE1:
        path = os.path.join(CACHE, "traces", f"{spec.name}_s{seed}.pkl")
        entry = _load_entry(path)
        missing = [x for x in algos if x not in entry]
        if missing:
            mat, _ = load_or_synthesize(
                spec, seed=seed, cache_dir=os.path.join(CACHE, "matrices"))
            for name in missing:
                if verbose:
                    print(f"  tracing {spec.name} / {name}", flush=True)
                entry[name] = trace_arrays(build_trace(mat, mat, name))
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(entry, f)
            os.replace(tmp, path)
        out[spec.name] = entry
    return out


def run(csv=True, seed: int = 0, verbose=False):
    mach = DEFAULT_MACHINE
    traces = table1_traces(algos=("spa", "hash-sota") + PAPER_ALGOS,
                           seed=seed, verbose=verbose)
    rows = []
    avg = np.zeros(len(PAPER_ALGOS))
    avg22 = np.zeros(len(PAPER_ALGOS))
    sota_ratio = []
    for spec in SUITESPARSE_TABLE1:
        e = traces[spec.name]
        t_spa = price(e["spa"], mach)
        rows.append(("table1_spa_seconds", spec.name, "spa", t_spa,
                     spec.spa_seconds))
        for ai, (algo, paper_s) in enumerate(
                zip(PAPER_ALGOS, spec.paper_speedups)):
            pred = t_spa / price(e[algo], mach)
            avg[ai] += pred
            rows.append(("table1_speedup", spec.name, algo, pred, paper_s))
        sota_ratio.append(price(e["hash-sota"], mach) /
                          price(e["hash-256/256"], mach))
    n = len(SUITESPARSE_TABLE1)
    avg /= n
    # the 22 most sparse = the first 22 rows (table sorted by mult/col avg)
    for spec in SUITESPARSE_TABLE1[:22]:
        e = traces[spec.name]
        t_spa = price(e["spa"], mach)
        for ai, algo in enumerate(PAPER_ALGOS):
            avg22[ai] += t_spa / price(e[algo], mach) / 22

    if csv:
        print("table,name,algo,predicted,paper")
        for r in rows:
            print(f"{r[0]},{r[1]},{r[2]},{r[3]:.6g},{r[4]:.6g}")
        for ai, algo in enumerate(PAPER_ALGOS):
            print(f"table1_avg_speedup,ALL,{algo},{avg[ai]:.4g},"
                  f"{TABLE1_AVERAGE_SPEEDUPS[ai]:.4g}")
        for ai, algo in enumerate(PAPER_ALGOS):
            print(f"table1_avg22_speedup,SPARSEST22,{algo},{avg22[ai]:.4g},"
                  f"{PAPER_AVG22.get(algo, float('nan')):.4g}")
        print(f"table1_sota_hash_ratio,ALL,hash-sota/hash-256,"
              f"{np.mean(sota_ratio):.4g},1.52")
    return dict(avg=avg, avg22=avg22, sota=np.mean(sota_ratio))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true",
                    help="name each (matrix, algorithm) as it is traced")
    args = ap.parse_args(argv)
    run(seed=args.seed, verbose=args.verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
