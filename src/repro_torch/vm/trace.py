"""Aggregated instruction traces.

A trace is a multiset of vector/scalar instructions grouped by
(kind, vector length, working-set bucket). Working set is the address range an
indexed (gather/scatter) instruction may touch — the quantity the paper
identifies as what drives indexed load/store performance (Section 5.2).
"""

from __future__ import annotations

import collections

import numpy as np

KINDS = (
    "valu",        # vector arithmetic / compare / mask ops
    "vfma",        # fused multiply-add
    "vload",       # unit-stride load
    "vstore",      # unit-stride store
    "vload_idx",   # gather
    "vstore_idx",  # scatter
    "scalar",      # scalar-core instruction
)


def _ws_bucket(ws: float) -> int:
    """Power-of-two bucket of the working set (0 for non-memory ops)."""
    if ws <= 0:
        return 0
    return 1 << int(np.ceil(np.log2(max(ws, 1))))


class Trace:
    """count[(kind, vl, ws_bucket)] plus active-element tallies."""

    __slots__ = ("counts", "active_elems", "total_elems")

    def __init__(self):
        self.counts = collections.Counter()
        self.active_elems = 0.0  # useful lanes
        self.total_elems = 0.0   # lanes incl. masked-off

    def add(self, kind: str, vl: int, count: float = 1, ws: float = 0,
            active: float | None = None):
        if count <= 0 or vl <= 0:
            return
        self.counts[(kind, int(vl), _ws_bucket(ws))] += count
        self.total_elems += count * vl
        self.active_elems += count * (vl if active is None else active)

    def add_many(self, kind: str, vls: np.ndarray, ws: float = 0,
                 actives: np.ndarray | None = None, per: float = 1):
        """One instruction (x per) for each entry of ``vls``."""
        vls = np.asarray(vls)
        vls = vls[vls > 0]
        if len(vls) == 0:
            return
        bucket = _ws_bucket(ws)
        uniq, cnt = np.unique(vls, return_counts=True)
        for v, c in zip(uniq.tolist(), cnt.tolist()):
            self.counts[(kind, int(v), bucket)] += c * per
        self.total_elems += per * float(vls.sum())
        if actives is not None:
            self.active_elems += per * float(np.asarray(actives).sum())
        else:
            self.active_elems += per * float(vls.sum())

    def merge(self, other: "Trace") -> "Trace":
        self.counts.update(other.counts)
        self.active_elems += other.active_elems
        self.total_elems += other.total_elems
        return self

    @property
    def n_instructions(self) -> float:
        return float(sum(self.counts.values()))

    @property
    def utilization(self) -> float:
        """Fraction of processed vector lanes that did useful work."""
        return self.active_elems / max(self.total_elems, 1.0)

    def by_kind(self) -> dict:
        out = collections.Counter()
        for (kind, _, _), c in self.counts.items():
            out[kind] += c
        return dict(out)

    def __repr__(self):
        return (
            f"Trace({self.n_instructions:.0f} instrs, "
            f"util={self.utilization:.2%}, kinds={self.by_kind()})"
        )
