"""Measure this machine's cost-model profile on the card and persist it.

    python3 benchmarks/torch_calibrate_profile.py [--smoke] [--out DIR]
        [--sections spa,stream,...] [--no-tune] [--reps N] [--seed N]

Runs the ladder of ``repro_torch.core.profile``: host SPA in three regimes,
the host product stream, the guard-tripped transient rebuild, the torch
stream and K1 on the card.  It fits the ``CostConstants`` terms by weighted
least squares, sizes the stream guard and searches the auto tile-grid
targets, and writes one JSON profile per machine fingerprint under
``REPRO_PROFILE_DIR`` (or ``--out``).  It prints the fitted constants beside
the defaults, the tuning and the provenance, then a cross-check: Spearman's
rank correlation of the fitted model's predictions against fresh timings of
spa, expand, the torch stream and K1 on a second ladder.

Afterwards every ``method="auto"`` consult on this machine (same
fingerprint, same ``REPRO_PROFILE_DIR``) ranks on the measured constants;
the tuned guard applies only after ``profile.apply_tuning()``.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import profile  # noqa: E402
from repro_torch.core.cost import DEFAULT_CONSTANTS, estimate_cost  # noqa: E402
from repro_torch.core.naive import spa_numpy  # noqa: E402
from repro_torch.core.planner import plan_spgemm  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.sparse.stats import tile_stats  # noqa: E402


def _validate(prof, dev) -> dict:
    """Predict-vs-measure: Spearman's rank correlation between the fitted
    model's costs (seconds domain) and fresh best-of-3 timings of four
    engines on a second stream ladder."""
    rng = np.random.default_rng(1)
    pred, meas = [], []
    for plan, a, b, flops in profile._stream_ladder(0.25, rng):
        st = tile_stats(a, b)
        dplan = plan_spgemm(a, b, "expand", backend="torch",
                            stream_limit=flops + 1, device=dev)
        runs = {
            "spa": lambda: spa_numpy(a, b),
            "expand": lambda: plan.execute(a, b, engine="stream"),
            "torch": profile._synced(lambda: dplan.execute(a, b), dev),
            "fused": profile._synced(
                lambda: dplan.execute(a, b, engine="fused"), dev),
        }
        for method, run in runs.items():
            run()   # streams and views built before the clock
            pred.append(estimate_cost(st, method, "host",
                                      constants=prof.constants))
            meas.append(profile._best_of(run, 3))
    return {"spearman": profile.rank_correlation(pred, meas),
            "points": len(pred)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small ladder (scale 0.25, 2 reps)")
    ap.add_argument("--out", default=None,
                    help="profile directory (default REPRO_PROFILE_DIR "
                         "or the user cache)")
    ap.add_argument("--sections", default=None,
                    help="comma list of ladder sections to (re-)measure "
                         f"(default all: {','.join(profile.SECTIONS)})")
    ap.add_argument("--no-tune", action="store_true",
                    help="skip the guard and tile-target tuning")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    scale = 0.25 if args.smoke else 1.0
    reps = args.reps if args.reps else (2 if args.smoke else 3)
    sections = (profile.SECTIONS if args.sections is None
                else tuple(s for s in args.sections.split(",") if s))

    fp = profile.machine_fingerprint()
    print(f"fingerprint {profile.fingerprint_key(fp)}: {fp}")
    print(f"sections={','.join(sections)} scale={scale} reps={reps} "
          f"tune={not args.no_tune}")

    t0 = time.perf_counter()
    prof = profile.calibrate_profile(
        scale=scale, reps=reps, sections=sections, tune=not args.no_tune,
        seed=args.seed, save=True, directory=args.out, device=dev)
    elapsed = time.perf_counter() - t0

    print(f"\ncalibrated in {elapsed:.1f}s -> {prof.path}")
    print(f"{'field':14s} {'fitted':>12s} {'default':>12s}")
    for f in sorted(prof.fitted):
        print(f"{f:14s} {getattr(prof.constants, f):12.3e} "
              f"{getattr(DEFAULT_CONSTANTS, f):12.3e}")
    for k, v in sorted(prof.tuning.items()):
        print(f"tuning {k} = {v}")
    print(f"provenance {json.dumps(prof.provenance(), sort_keys=True)}")

    val = _validate(prof, dev)
    print(f"\nvalidation: Spearman(pred, meas) = {val['spearman']:.3f} "
          f"over {val['points']} probe points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
