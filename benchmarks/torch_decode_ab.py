#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 18 overlay decode step from several trees
in turn, on one card.

    python benchmarks/torch_decode_ab.py TREE [TREE ...] [--seed N] [--reps N]

Each TREE is the root of a copy of this repository (this checkout, or
another commit of it unpacked with ``git archive``).  One process a TREE,
run one after the other in the order given (parent, change, change,
parent compares two commits on one card): each imports that tree's
``chip_smoke.py`` and ``src/``, builds qwen2-0.5b at full width and depth
with its FFNs on the spgemm path (``warm_setup``: keep 0.1, f32 weights
from ``--seed``) and a 4-slot engine of 256 positions (``warm_engine``),
and times one ``decode_step`` at B = 4 on the engine's cache
(``step_timing``: host clock ending in a synchronize, median of
``--reps``, with its device time and idle share from ``torch.profiler``).
Each run prints one JSON line; the card line (``nvidia-smi``) comes last.
Without a card it exits non-zero before any run.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

RUN = """
import json, sys
root, seed, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs

dev = torch.device("cuda")
data = cs.warm_setup(dev, seed)
eng = cs.warm_engine(data, dev)
out = cs.step_timing(data["sparse"], data["cfg"], eng, dev, reps,
                     sparse_ffn=data["overlay"])
print(json.dumps(dict(tree=root, **out)), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    for tree in args.trees:
        root = os.path.abspath(tree)
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            print(f"FAIL: no chip_smoke.py in {root}", file=sys.stderr)
            return 2
        # each run's machine profiles in a directory of its own, as
        # chip_smoke.py pins them: no cached profile re-ranks a plan
        profiles = tempfile.mkdtemp(prefix="decode-ab-profiles-")
        env = dict(os.environ, REPRO_PROFILE_DIR=profiles)
        env.pop("REPRO_PROFILE_FILE", None)
        env.pop("REPRO_AUTO_CALIBRATE", None)
        out = subprocess.run(
            [sys.executable, "-c", RUN, root, str(args.seed),
             str(args.reps)], cwd=root, env=env, capture_output=True,
            text=True, timeout=1800)
        shutil.rmtree(profiles, ignore_errors=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            print(f"FAIL: the run from {root} exited {out.returncode}",
                  file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
