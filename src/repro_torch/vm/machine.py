"""Machine model: instruction trace -> cycles -> seconds.

Models the paper's platform (Section 5.1): single-issue RISC-V scalar core
driving an 8-lane VPU, max VL 256 doubles, 50 MHz, 1 MB L2, DDR4 DRAM.

A vector instruction of length VL costs
    issue + ceil(VL / lanes) * beat(kind) * range_factor(kind, ws)
where ``range_factor`` models the indexed-access locality cliff the paper
observes (Section 5.2): gathers/scatters whose target working set fits L2 run
at near unit-stride beat; past L2 every element risks a DRAM-latency miss.
The factor interpolates with the L2-resident fraction of the working set:
    f(ws) = 1 + miss_penalty * max(0, 1 - L2/ws).

Default constants were calibrated against Table 1 (the JAX package's
benchmarks/calibrate.py): SPA absolute seconds and all nine speedup columns.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.vm.trace import Trace


@dataclasses.dataclass(frozen=True)
class Machine:
    lanes: int = 8
    vl_max: int = 256
    clock_hz: float = 50e6
    l2_bytes: float = 1 << 20

    issue: float = 6.0            # cycles to issue/decode a vector instruction
    beat_alu: float = 1.0         # per-group (8-elem) cycles, vector ALU
    beat_fma: float = 1.0
    beat_mem: float = 1.0         # unit-stride load/store
    beat_idx: float = 8.0         # gather/scatter (element-serialized)
    miss_penalty: float = 6.0     # extra beats per element when ws >> L2
    range_log_coef: float = 0.25  # sub-L2 growth of gather cost with range
    range_log_base: float = 16 << 10
    scalar_cpi: float = 1.5       # scalar-core cycles per instruction

    _BEATS = {
        "valu": "beat_alu",
        "vfma": "beat_fma",
        "vload": "beat_mem",
        "vstore": "beat_mem",
        "vload_idx": "beat_idx",
        "vstore_idx": "beat_idx",
    }

    def range_factor(self, kind: str, ws: float) -> float:
        """Indexed-access slowdown as a function of target address range.

        Two regimes, both observed in the paper's Section 5.2 discussion:
        (a) within L2, wider ranges stress banking/TLB — logarithmic growth;
        (b) past L2, elements miss to DRAM — penalty scaled by the
            non-resident fraction.
        """
        if kind not in ("vload_idx", "vstore_idx") or ws <= 0:
            return 1.0
        sub = self.range_log_coef * max(
            0.0, math.log2(min(ws, self.l2_bytes) / self.range_log_base)
        )
        resident = min(1.0, self.l2_bytes / ws)
        return 1.0 + sub + self.miss_penalty * (1.0 - resident)

    def instr_cycles(self, kind: str, vl: int, ws: float) -> float:
        if kind == "scalar":
            return self.scalar_cpi
        beat = getattr(self, self._BEATS[kind])
        groups = -(-vl // self.lanes)
        return self.issue + groups * beat * self.range_factor(kind, ws)

    def cycles(self, trace: Trace) -> float:
        total = 0.0
        for (kind, vl, ws), count in trace.counts.items():
            total += count * self.instr_cycles(kind, vl, ws)
        return total

    def seconds(self, trace: Trace) -> float:
        return self.cycles(trace) / self.clock_hz

    def replace(self, **kw) -> "Machine":
        return dataclasses.replace(self, **kw)


# Constants fitted against Table 1 by the JAX package's benchmarks/calibrate.py
# (geomean per-cell speedup error 11.9% over 40 matrices x 9 algorithm
# columns), copied unchanged.
CALIBRATED = dict(
    issue=23.886430233209833,
    beat_mem=4.0,
    beat_idx=22.547063450115633,
    miss_penalty=0.9976311574844396,
    range_log_coef=0.17698644609603448,
    scalar_cpi=16.0,
)

#: the fitted machine.  The JAX package refreshes it from a
#: ``benchmarks/fitted_machine.json`` that its calibration sweep writes; the
#: port has no such sweep yet, so its machine is the fitted constants above.
DEFAULT_MACHINE = Machine(**CALIBRATED)
