#!/usr/bin/env python3
"""K1's compile-time constants against each other and against another
source of the kernel, on one NVIDIA card, on the Table-1 matrices' views.

    python3 benchmarks/torch_fused_shapes.py [--set NAME=K=V,K=V ...]
        [--ablate no_gather|no_chain|short_only ...]
        [--baseline [NAME=]PATH ...] [--rounds N] [--reps N] [--seed N]

Builds ``src/repro_torch/csrc/fused_stream.cu`` as it stands ("current"),
once per ``--set`` with its ``constexpr int`` constants replaced (for
example ``--set l32=kLongSlot=32``, ``--set d2=kDepth=2``, ``--set
b4=kBatchTile=4``, ``--set c128=kThreads=128``), once per ``--ablate``
("no_gather": each gather returns its index, so the indices are read and
nothing is gathered; "no_chain": each lane adds its own products, so the
rounds are gathered and multiplied but not summed in order; both give
wrong sums and are timed only; "short_only": a long-slot threshold past
every slot, so every slot gets a thread, as exact as the current build),
and once per ``--baseline``, another source of K1 (for example the parent
commit's, unpacked with ``git archive``; named "baseline" unless given as
NAME=PATH).  Every build is launched through the port's wrappers
(``kernels.fused_stream`` for one value set, ``kernels.fused_stream_batched``
for K1-b) with the build's library swapped in (``kernel_builds.using``)
and the list of long slots that the build's own ``kLongSlot`` gives.  A
source without ``kLongSlot`` is the one-tier kernel that came before the
list; its C entry point takes no list, and the wrapper's list is dropped
on the way to it (``OneTier``).

Per Table-1 matrix (synthesized from ``--seed``, integer values, the
stream guard raised to admit all its products as ``chip_smoke.py`` does),
every exact build must equal the plain version bit for bit on the forward
and both gradient views (integer and normal values) and, at B = 8 normal
value sets for A and another 8 for B, on the forward view through K1-b.
Then ``--rounds`` rounds time every build in turn (the order reversed
every other round), each time CUDA events around ``--reps`` launches
queued behind a device-side wait (``chip_smoke.event_ms``).  One JSON line
a build gives its registers and spills (``-Xptxas -v``); one a matrix
gives, per view, its products, slots, long slots, longest slot, the byte
bound, the chain floor (the longest slot's ordered adds, one after
another: ``ADD_CYCLES`` each at ``SM_CLOCK_HZ``, a derived figure, not a
measurement) and each build's median time; a last one the card.  The
builds go to ``build/fused_shapes/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys

from kernel_builds import CSRC, ROOT, ablated, build_all, read_sources, \
    using, with_constants

MATRICES = ("S40PI_n1", "bcspwr09", "tols1090", "fpga_dcop_05", "watt_1",
            "pores_2", "cage9", "ex22", "adder_dcop_01", "Goodwin_013",
            "iprob")
BATCH = 8
VIEWS = ("forward", "grad_a", "grad_b")
# what each ablation replaces in the kernel's source
ABLATIONS = {
    "no_gather": (("  return __ldg(v + i);\n",
                   "  return static_cast<float>(i);\n"),),
    "no_chain": (("acc = add4(acc, v);",
                  "if (k4 == 0) acc = __fadd_rn(acc, p[d]);"),),
}
SHORT_ONLY = "kLongSlot=1000000000"
# NVIDIA H100 SXM data sheet: the SM clock at boost; the latency of one
# dependent f32 add, in cycles (for the chain floor)
SM_CLOCK_HZ = 1.98e9
ADD_CYCLES = 4


class OneTier:
    """A library built from the one-tier source (no ``kLongSlot``), seen
    through the current C entry point: the list of long slots and its
    length are dropped."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        # idx_x, idx_y, seg_ptr, x, y, n_x, n_y, n_out, batch, out, stream
        lib.repro_fused_stream_launch.argtypes = (p, p, p, p, p, i, i, i, i,
                                                  p, p)
        self._lib = lib

    def repro_fused_stream_launch(self, idx_x, idx_y, seg_ptr, _slots,
                                  _n_long, *rest):
        return self._lib.repro_fused_stream_launch(idx_x, idx_y, seg_ptr,
                                                   *rest)


def threshold(files: dict):
    """The build's kLongSlot, or None for the one-tier source."""
    found = re.findall(r"constexpr int kLongSlot = (\d+);",
                       next(iter(files.values())))
    return int(found[0]) if found else None


def view_line(cs, view, x, y) -> dict:
    products, nbytes = cs.k1_work(view, x, y)
    b_ms, by = cs.bound_ms(products, nbytes)
    chain = cs.k1_chain(view)
    return dict(products=products, slots=view.n_out, bytes=nbytes,
                bound_ms=b_ms, bound_by=by, **chain,
                chain_floor_ms=chain["longest_slot"] * ADD_CYCLES
                / SM_CLOCK_HZ * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=K=V,K=V")
    ap.add_argument("--ablate", action="append", default=[],
                    choices=sorted(ABLATIONS) + ["short_only"])
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="[NAME=]PATH")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.core import fast, fused_stream, plan_spgemm
    from repro_torch.core.expand import product_count
    from repro_torch.sparse.format import _np

    current = read_sources(os.path.join(CSRC, "fused_stream.cu"))
    sources = {"current": current}
    for spec in args.set:
        name, assignments = spec.split("=", 1)
        sources[name] = with_constants(current, assignments)
    for what in args.ablate:
        sources[f"ablate_{what}"] = (
            with_constants(current, SHORT_ONLY) if what == "short_only"
            else ablated(current, ABLATIONS[what], what))
    for spec in args.baseline:
        name, path = spec.split("=", 1) if "=" in spec else ("baseline",
                                                              spec)
        sources[name] = read_sources(path)
    libs = build_all(sources, "fused_shapes")
    thresholds = {name: threshold(files) for name, files in sources.items()}
    libs = {name: lib if thresholds[name] is not None else OneTier(lib)
            for name, lib in libs.items()}
    exact = [n for n in libs if n not in ("ablate_no_gather",
                                          "ablate_no_chain")]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    print(f"card: {cs.card_line()}", flush=True)

    def launch(build, view, x, y, slots):
        """out [B, n_out] of one launch of ``build`` through the wrappers;
        ``slots`` maps a threshold to the view's long slots under it."""
        index = (view.idx_x, view.idx_y, view.seg_ptr)
        with using(libs[build]):
            if x.shape[0] == 1:
                return kernels.fused_stream(
                    *index, x[0], y[0],
                    long_slots=slots[thresholds[build]])[None]
            return kernels.fused_stream_batched(
                *index, x, y, long_slots=slots[thresholds[build]])

    def check(view, x, y, slots, want, label):
        for build in exact:
            got = launch(build, view, x, y, slots)
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise SystemExit(f"FAIL: build {build} differs from the "
                                 f"plain version on {label}")

    for name in MATRICES:
        a = cs.integer_matrix(name, args.seed)
        real = cs.real_valued(a, args.seed)
        products = product_count(_np(a.col_ptr), _np(a.col_ptr),
                                 _np(a.row_indices))
        plan = plan_spgemm(a, a, device=dev, stream_limit=max(
            products, fast.STREAM_MAX_PRODUCTS))
        fs = fused_stream(plan)
        n_c = fs.forward.n_out
        cases = {}
        for kind, m in (("int", a), ("real", real)):
            v = m.values.to(dev, torch.float32)[None]
            g = (torch.randint(1, 4, (1, n_c), generator=gen, device=dev)
                 .float() if kind == "int"
                 else torch.randn((1, n_c), generator=gen, device=dev))
            for vname in VIEWS:
                cases[kind, vname] = (getattr(fs, vname),
                                      v if vname == "forward" else g, v)
        # A's and B's value sets drawn apart, as a batched multiply has them
        cases["batched", "forward"] = (fs.forward, *(
            torch.randn((BATCH, a.nnz), generator=gen, device=dev)
            for _ in range(2)))
        for (kind, vname), (view, x, y) in cases.items():
            seg = view.seg_ptr
            # the one-tier build (threshold None) takes no list
            slots = {t: torch.nonzero(torch.diff(seg) > t).flatten().to(
                torch.int32) if t is not None
                else torch.empty(0, dtype=torch.int32, device=dev)
                for t in set(thresholds.values())}
            cases[kind, vname] += (slots,)
            want = kernels.fused_stream_batched_plain(
                view.idx_x, view.idx_y, seg, x, y)
            check(view, x, y, slots, want, f"{name} {vname} ({kind})")
        timed = {key: cases[key] for key in
                 [("int", v) for v in VIEWS] + [("batched", "forward")]}
        times = {key: {build: [] for build in libs} for key in timed}
        order = list(libs)
        for r in range(args.rounds):
            for build in (order if r % 2 == 0 else order[::-1]):
                for key, (view, x, y, sl) in timed.items():
                    times[key][build].append(cs.event_ms(
                        lambda: launch(build, view, x, y, sl), args.reps))
        print(json.dumps({"matrix": name, "views": {
            ("K1-b " if kind == "batched" else "K1 ") + vname: dict(
                view_line(cs, view, x[0] if x.shape[0] == 1 else x,
                          y[0] if y.shape[0] == 1 else y),
                batch=x.shape[0],
                ms={b: statistics.median(t)
                    for b, t in times[kind, vname].items()})
            for (kind, vname), (view, x, y, _) in timed.items()}}),
            flush=True)
    print(json.dumps({"card": cs.card_line(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
