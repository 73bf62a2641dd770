"""K4: HASH lock-step SpGEMM, Section 3.2 (``csrc/hash_spgemm.cu``).

The counterpart of the JAX package's Pallas HASH kernel
(``repro/kernels/hash_spgemm.py::hash_spgemm``): the SPARS skeleton with a
linear-probed table of ``h`` slots per lane, hash ``(r * HASH_C) mod h``,
empty key -1, at most ``h`` probes, slot 0 when none is found.  Outputs
``keys`` int32 and ``vals`` f32, both ``[h, n_b]``, slot for slot as the
reference fills them.  On a CUDA tensor :func:`hash_spgemm` launches the
hand-written kernel (one thread per lane) or raises; on a CPU tensor it
runs :func:`hash_spgemm_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.core.analysis import HASH_C
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, check_steps, \
    stream_handle
from repro_torch.kernels.spars import LockStep

EMPTY = -1
#: the multiplier the reference applies in int32 (its low 31 bits)
HASH_C31 = HASH_C & 0x7FFFFFFF


def hash_spgemm(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, *,
                m: int, h: int, block_cols: int = 128, device=None):
    """Per-lane hash tables (keys [h, n_b] int32, vals [h, n_b] f32).

    ``h`` must be a power of two; ``m`` is accepted for the reference's
    signature and not used.
    """
    del m
    if h < 1 or h & (h - 1):
        raise ValueError(f"h={h} must be a power of two")
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         block_cols=block_cols, device=device)
    n_b, zb = b_rows.shape
    check_steps(steps, n_b, block_cols)
    if dev.type == "cpu":
        return hash_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                 b_nnz, steps, h=h, block_cols=block_cols)
    keys = torch.full((h, n_b), EMPTY, dtype=torch.int32, device=dev)
    vals = torch.zeros((h, n_b), dtype=torch.float32, device=dev)
    _build.launch(
        "repro_hash_launch", a_rows.data_ptr(), a_vals.data_ptr(),
        a_nnz.data_ptr(), a_rows.shape[1], b_rows.data_ptr(),
        b_vals.data_ptr(), b_nnz.data_ptr(), n_b, zb, steps.data_ptr(),
        block_cols, h, keys.data_ptr(), vals.data_ptr(), stream_handle(dev))
    hash_spgemm.n_launches += 1
    return keys, vals


hash_spgemm.n_launches = 0


def hash_slot(rows: torch.Tensor, h: int) -> torch.Tensor:
    """First probe position of each row: ``(r * HASH_C) mod h`` (low bits
    of the product, the same in int64 as in the reference's wrapping
    int32)."""
    return (rows.long() * HASH_C31) & (h - 1)


def hash_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                      *, h: int, block_cols: int = 128):
    """The kernel's plain PyTorch version, probe for probe.

    Loops over steps and vectorizes over lanes.  Each lane probes its own
    table; a probe round stops once every lane found its slot (the
    remaining rounds of the reference leave every lane where it is).
    """
    n_b = b_rows.shape[0]
    dev = a_vals.device
    keys = torch.full((h, n_b), EMPTY, dtype=torch.int32, device=dev)
    vals = torch.zeros((h, n_b), dtype=torch.float32, device=dev)
    ls = LockStep(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                  block_cols)
    for s in range(ls.n_steps):
        lanes = torch.nonzero(ls.active(s), as_tuple=True)[0]
        if len(lanes) == 0:
            break
        rows, prod = ls.fetch(lanes)
        pos = hash_slot(rows, h)
        slot = torch.zeros_like(pos)        # the fallback: slot 0
        todo = torch.ones_like(pos, dtype=torch.bool)
        for _ in range(h):
            key = keys[pos, lanes].long()
            hit = todo & ((key == rows) | (key == EMPTY))
            slot = torch.where(hit, pos, slot)
            todo = todo & ~hit
            if not bool(todo.any()):
                break
            pos = torch.where(todo, (pos + 1) & (h - 1), pos)
        vals[slot, lanes] = vals[slot, lanes] + prod
        keys[slot, lanes] = rows.to(torch.int32)
        ls.advance(lanes)
    return keys, vals
