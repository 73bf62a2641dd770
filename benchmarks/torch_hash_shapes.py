#!/usr/bin/env python3
"""K4's compile-time constants against each other, and where its time goes,
on one NVIDIA card.

    python3 benchmarks/torch_hash_shapes.py [--set NAME=K=V,K=V ...]
        [--ablate fold|insert|both ...] [--reps N] [--seed N]

Builds ``src/repro_torch/csrc/hash_spgemm.cu`` as it stands ("current"),
once per ``--set`` with its ``constexpr int`` constants replaced (for
example ``--set st8=kStages=8``), and once per ``--ablate`` with a phase of
the round left out: "fold" skips adding the products (each round returns
after its slots are found), "insert" never inserts a new row, "both" does
neither.  Ablated builds give wrong tables by construction and are timed
only; every other build must equal the current one bit for bit, and the
current one the plain version, on the timed group (normal values) and on
every default-method HASH group.  Per Table-1 matrix (synthesized from
``--seed``, integer values) one JSON line gives each build's summed device
time over the default method's HASH groups; a last line times ``iprob``'s
largest ``hash-256/256`` group (K4, and K4-b at B = 8 value sets), and that
group with no steps (the tables' initialisation and store alone).  Device
times are CUDA events around ``--reps`` launches queued behind a
device-side wait, output allocation included.  The builds go to
``build/hash_shapes/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from kernel_builds import ablated, build_all, read_sources, using, \
    with_constants

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MATRICES = ("S40PI_n1", "bcspwr09", "tols1090", "fpga_dcop_05", "watt_1",
            "pores_2", "cage9", "ex22", "adder_dcop_01", "Goodwin_013",
            "iprob")
# what each ablation replaces in round_commit
FOLD = "  // add the products, each slot's in step order by its lowest thread\n"
INSERT = "  unsigned pending = news;\n"
ABLATIONS = {
    "fold": ((FOLD, "  __syncwarp();\n  return;\n"),),
    "insert": ((INSERT, "  unsigned pending = 0;\n"),),
    "both": ((FOLD, "  __syncwarp();\n  return;\n"),
             (INSERT, "  unsigned pending = 0;\n")),
}


def run(op):
    from repro_torch import kernels

    fn = (kernels.hash_spgemm_batched if op["ab"][1].dim() == 3
          else kernels.hash_spgemm)
    return fn(*op["ab"], op["steps"], m=op["m"], h=op["h"],
              block_cols=op["block"])


def plain(op):
    from repro_torch import kernels

    fn = (kernels.hash_spgemm_batched_plain if op["ab"][1].dim() == 3
          else kernels.hash_spgemm_plain)
    return fn(*op["ab"], op["steps"], h=op["h"], block_cols=op["block"])


def group_ops(plan, a):
    """K4 operands of each HASH group of ``plan`` on A's values."""
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.sparse.format import padded_values

    lay = plan.layout
    vals = a.values.to(plan.device, torch.float32)
    av = padded_values(vals, lay.a_gather, lay.a_mask)
    return [dict(ab=(lay.a_rows, av, lay.a_nnz, g.b_rows,
                     padded_values(vals, g.b_vgather, g.b_vmask), g.b_nnz),
                 steps=g.steps, m=plan.shape[0], block=BLOCK_COLS, h=g.h)
            for g in lay.groups if g.kind == "hash"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=CONST=VALUE[,CONST=VALUE]: a build with "
                         "constants replaced")
    ap.add_argument("--ablate", action="append", default=[],
                    choices=sorted(ABLATIONS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core import plan_spgemm
    from repro_torch.sparse import BatchedCSC

    current = read_sources(os.path.join(ROOT, "src", "repro_torch", "csrc",
                                        "hash_spgemm.cu"))
    sources = {"current": current}
    for spec in args.set:
        name, assignments = spec.split("=", 1)
        sources[name] = with_constants(current, assignments)
    for what in args.ablate:
        sources[f"no_{what}"] = ablated(current, ABLATIONS[what], what)
    libs = build_all(sources, "hash_shapes")
    exact = [n for n in libs if not n.startswith("no_")]
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)

    def check_builds(op, want, label):
        for name in exact:
            with using(libs[name]):
                got = run(op)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"FAIL: build {name} differs on {label}")

    for name in MATRICES:
        a = cs.integer_matrix(name, args.seed)
        plan = plan_spgemm(a, a, device=dev)
        ops = group_ops(plan, a)
        if not ops:
            continue
        for i, op in enumerate(ops):
            check_builds(op, plain(op), f"{name} group {i}")
        times = {}
        for build, lib in libs.items():
            with using(lib):
                times[build] = sum(cs.event_ms(lambda: run(op), args.reps)
                                   for op in ops)
        print(json.dumps({"matrix": name, "method": "default",
                          "groups": len(ops), "hash_ms": times}), flush=True)

    a = cs.integer_matrix("iprob", args.seed)
    plan = plan_spgemm(a, a, "hash-256/256", device=dev)
    ops = group_ops(plan, a)
    big = max(range(len(ops)), key=lambda i: cs.group_work("hash", ops[i])[0])
    op = ops[big]
    real = group_ops(plan, cs.real_valued(a, args.seed))[big]
    check_builds(real, plain(real), "iprob's largest group, normal values")
    rng = np.random.default_rng([args.seed, 8])
    stacks = [BatchedCSC.from_values(a, torch.from_numpy(rng.integers(
        1, 4, (8, a.nnz)).astype(np.float32))) for _ in range(2)]
    (_, bop), = cs.batched_group_operands(
        plan, stacks[0].values, stacks[1].values,
        [[g for g in plan.layout.groups if g.kind == "hash"][big]])
    with using(libs["current"]):
        want_b = run(bop)
    check_builds(bop, want_b, "iprob's largest group at B = 8")
    idle = dict(op, steps=torch.zeros_like(op["steps"]))
    out = {}
    for build, lib in libs.items():
        with using(lib):
            out[build] = dict(
                k4_ms=cs.event_ms(lambda: run(op), args.reps),
                k4b_ms=cs.event_ms(lambda: run(bop), args.reps),
                no_steps_ms=cs.event_ms(lambda: run(idle), args.reps))
    print(json.dumps({"matrix": "iprob", "method": "hash-256/256",
                      "h": op["h"], "products": cs.group_work("hash", op)[0],
                      "builds": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
