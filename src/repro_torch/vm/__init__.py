"""Cycle-level cost model of the paper's vector machine.

The paper evaluates on an FPGA prototype (RISC-V scalar core + 8-lane VPU,
max VL 256 doubles, 50 MHz, 1 MB L2, 4 GB DRAM) that we cannot run. The
algorithms' performance, however, is fully determined by their *instruction
schedules* (which we derive exactly from the matrix structure, per the paper's
pseudocode) plus a machine model (issue cost, per-beat throughput, and the
indexed-access range penalty that creates the paper's b_max effects).

- trace.py     instruction-group aggregation
- schedule.py  exact per-algorithm schedule -> trace (structure only, no values)
- machine.py   trace -> cycles/seconds; constants calibrated against Table 1

The port's copy of the JAX package's ``repro.vm``: pure host numpy, no device
work, so its traces and prices equal the JAX package's bit for bit.
"""

from repro_torch.vm.trace import Trace
from repro_torch.vm.machine import Machine, DEFAULT_MACHINE
from repro_torch.vm.schedule import (
    trace_spa,
    trace_spars,
    trace_hash,
    trace_esc,
    trace_hybrid,
    c_column_nnz,
)

__all__ = [
    "Trace",
    "Machine",
    "DEFAULT_MACHINE",
    "trace_spa",
    "trace_spars",
    "trace_hash",
    "trace_esc",
    "trace_hybrid",
    "c_column_nnz",
]
