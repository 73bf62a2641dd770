"""K4: HASH lock-step SpGEMM, Section 3.2 (``csrc/hash_spgemm.cu``).

The counterpart of the JAX package's Pallas HASH kernel
(``repro/kernels/hash_spgemm.py::hash_spgemm``) and of its vmapped form
(``hash_spgemm_batched``): the SPARS skeleton with a linear-probed table of
``h`` slots per lane, hash ``(r * HASH_C) mod h``, empty key -1, at most
``h`` probes, slot 0 when none is found.  Outputs ``keys`` int32 and
``vals`` f32, both ``[h, n_b]`` (``[B, h, n_b]`` batched: probing depends on
rows alone, so every element's keys are equal), slot for slot as the
reference fills them.  On a CUDA tensor the wrappers launch the
hand-written kernel (two warps per lane, one staging its steps and one
committing them into its table on chip; the value sets a second grid axis)
or raise; on a CPU tensor they run :func:`hash_spgemm_batched_plain`.

The kernel keeps each lane's table in one of two tiers, by h alone
(:func:`hash_layout`): "shared" while a lane's keys and one set of values
(8 h bytes, with the lane's staging) fit a CTA's shared memory, h <= 16384
on the H100; "global" past that, a workspace in device memory with each
lane's table contiguous.  Both wrappers count their launches per tier in
``n_launches_by_tier``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.analysis import HASH_C
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, check_steps, \
    stream_handle
from repro_torch.kernels.spars import add_in_order, lockstep_walk, \
    walk_products, walk_rows

EMPTY = -1
#: the multiplier the reference applies in int32 (its low 31 bits)
HASH_C31 = HASH_C & 0x7FFFFFFF

#: the kernel's table tiers, in the order of its ``tier`` argument
TIERS = ("shared", "global")
#: dynamic shared memory one CTA may use on the H100 (227 KB)
SMEM_BYTES = 232448
#: value sets one CTA may hold (the kernel's instantiations), most first
SETS = (8, 4, 2, 1)
#: lanes (two warps each) one CTA holds at most, a power of two (the
#: kernel's kMaxLanes)
MAX_LANES = 4
#: rounds of 32 steps in a lane's ring (the kernel's kStages)
STAGES = 4


def cta_bytes(h: int, lanes: int, sets: int, tier: str = "shared") -> int:
    """Shared memory of one K4 CTA.  Per lane: its warps' staging, two
    8-byte barriers a ring stage, a round's products and rows, and a ring of
    STAGES rounds (rows, A and B values, and a count); and in tier "shared"
    the table, h keys and ``sets`` value arrays."""
    table = (1 + sets) * h if tier == "shared" else 0
    stage = 4 * STAGES + 32 * (sets + 1) + STAGES * (32 * (1 + 2 * sets) + 1)
    return 4 * lanes * (table + stage)


def hash_layout(h: int, batch: int = 1) -> tuple:
    """(tier, lanes per CTA, value sets per CTA) of one K4 launch.

    The tier follows from h alone: "shared" while one lane's table fits a
    CTA's shared memory (h <= 16384), else "global".  In tier "shared" a
    CTA takes as many of the batch's value sets as fit (at most the next
    power of two of ``batch``, so that slots found once serve them all),
    then as many lanes as fit, a power of two up to MAX_LANES; in tier
    "global", MAX_LANES lanes of one value set.
    """
    if cta_bytes(h, 1, 1) > SMEM_BYTES:
        return "global", MAX_LANES, 1
    sets = next(s for s in SETS
                if (s == 1 or s < 2 * batch)
                and cta_bytes(h, 1, s) <= SMEM_BYTES)
    lanes = MAX_LANES
    while cta_bytes(h, lanes, sets) > SMEM_BYTES:
        lanes //= 2
    return "shared", lanes, sets


def _check(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, h,
           block_cols, device, batched):
    if h < 1 or h & (h - 1):
        raise ValueError(f"h={h} must be a power of two")
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         block_cols=block_cols, device=device,
                         batched=batched)
    check_steps(steps, b_rows.shape[0], block_cols)
    return dev


def _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, h,
            block_cols, batch, dev):
    """One K4 launch over ``batch`` value sets; (keys, vals) [batch, h,
    n_b]."""
    n_b, zb = b_rows.shape
    tier, lanes, sets = hash_layout(h, batch)
    # the kernel writes every slot
    keys = torch.empty((batch, h, n_b), dtype=torch.int32, device=dev)
    vals = torch.empty((batch, h, n_b), dtype=torch.float32, device=dev)
    ws = (torch.empty((batch, n_b, h), dtype=torch.int32, device=dev),
          torch.empty((batch, n_b, h), dtype=torch.float32, device=dev)) \
        if tier == "global" else None
    _build.launch(
        "repro_hash_launch", a_rows.data_ptr(), a_vals.data_ptr(),
        a_nnz.data_ptr(), *a_rows.shape, b_rows.data_ptr(),
        b_vals.data_ptr(), b_nnz.data_ptr(), n_b, zb, steps.data_ptr(),
        block_cols, h, batch, TIERS.index(tier), lanes, sets,
        keys.data_ptr(), vals.data_ptr(),
        *((w.data_ptr() for w in ws) if ws else (None, None)),
        stream_handle(dev))
    return keys, vals, tier


def hash_spgemm(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, *,
                m: int, h: int, block_cols: int = 128, device=None):
    """Per-lane hash tables (keys [h, n_b] int32, vals [h, n_b] f32).

    ``h`` must be a power of two; ``m`` is accepted for the reference's
    signature and not used.
    """
    del m
    dev = _check(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, h,
                 block_cols, device, batched=False)
    if dev.type == "cpu":
        return hash_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                 b_nnz, steps, h=h, block_cols=block_cols)
    keys, vals, tier = _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                               steps, h, block_cols, 1, dev)
    hash_spgemm.n_launches += 1
    hash_spgemm.n_launches_by_tier[tier] += 1
    return keys[0], vals[0]


hash_spgemm.n_launches = 0
hash_spgemm.n_launches_by_tier = dict.fromkeys(TIERS, 0)


def hash_spgemm_batched(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                        *, m: int, h: int, block_cols: int = 128,
                        device=None):
    """Per-lane hash tables (keys, vals) [B, h, n_b] for B same-pattern
    value sets in one launch.

    Only the values carry the batch axis (``a_vals [B, n_a, za]``,
    ``b_vals [B, n_b, zb]``); rows, nnz and the trip counts are shared.
    Slice b equals :func:`hash_spgemm` on value set b bit for bit.
    """
    del m
    dev = _check(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, h,
                 block_cols, device, batched=True)
    if dev.type == "cpu":
        return hash_spgemm_batched_plain(a_rows, a_vals, a_nnz, b_rows,
                                         b_vals, b_nnz, steps, h=h,
                                         block_cols=block_cols)
    keys, vals, tier = _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                               steps, h, block_cols, a_vals.shape[0], dev)
    hash_spgemm_batched.n_launches += 1
    hash_spgemm_batched.n_launches_by_tier[tier] += 1
    return keys, vals


hash_spgemm_batched.n_launches = 0
hash_spgemm_batched.n_launches_by_tier = dict.fromkeys(TIERS, 0)


def hash_slot(rows: torch.Tensor, h: int) -> torch.Tensor:
    """First probe position of each row: ``(r * HASH_C) mod h`` (low bits
    of the product, the same in int64 as in the reference's wrapping
    int32)."""
    return (rows.long() * HASH_C31) & (h - 1)


def hash_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                      *, h: int, block_cols: int = 128):
    """The kernel's plain PyTorch version for one value set."""
    keys, vals = hash_spgemm_batched_plain(
        a_rows, a_vals[None], a_nnz, b_rows, b_vals[None], b_nnz, steps, h=h,
        block_cols=block_cols)
    return keys[0], vals[0]


def hash_probe(rows: np.ndarray, lanes: np.ndarray, step: np.ndarray,
               h: int, n_b: int) -> np.ndarray:
    """Each step's slot, probe for probe on the host: a lane's table keeps
    the rows it was given (pattern only), so the slots follow from the walk
    (:func:`~repro_torch.kernels.spars.lockstep_walk`, ``step``-ordered)
    alone.  A probe round stops once every lane of the step found its slot
    (the remaining rounds of the reference leave every lane where it is);
    a lane that finds none in ``h`` probes takes slot 0."""
    table = np.full((h, n_b), EMPTY, np.int64)
    slots = np.zeros(len(rows), np.int64)
    bounds = np.r_[0, np.flatnonzero(np.diff(step)) + 1, len(step)]
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        r, ln = rows[lo:hi], lanes[lo:hi]
        pos = (r * HASH_C31) & (h - 1)
        slot = np.zeros_like(pos)
        todo = np.ones(len(pos), bool)
        for _ in range(h):
            key = table[pos, ln]
            hit = todo & ((key == r) | (key == EMPTY))
            slot = np.where(hit, pos, slot)
            todo &= ~hit
            if not todo.any():
                break
            pos = np.where(todo, (pos + 1) & (h - 1), pos)
        table[slot, ln] = r
        slots[lo:hi] = slot
    return slots


def hash_spgemm_batched_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                              steps, *, h: int, block_cols: int = 128):
    """The kernel's plain PyTorch version, probe for probe.

    The walk and every step's slot come from the pattern on the host
    (:func:`hash_probe`; each lane of each batch element probes its own
    table, as the kernel's thread does, and the tables of all elements
    hold the same keys); every step's product is one gather and multiply,
    and each (slot, lane) cell adds its products in step order
    (:func:`~repro_torch.kernels.spars.add_in_order`).  Each cell keeps the
    row its last step wrote.
    """
    batch = a_vals.shape[0]
    n_b = b_rows.shape[0]
    dev = a_vals.device
    keys = torch.full((batch, h, n_b), EMPTY, dtype=torch.int32, device=dev)
    vals = torch.zeros((batch, h, n_b), dtype=torch.float32, device=dev)
    walk = lockstep_walk(a_nnz, b_rows, b_nnz, steps, block_cols)
    if len(walk[0]) == 0:
        return keys, vals
    step, lanes = walk[0], walk[1]
    rows = walk_rows(a_rows, walk)
    slots = hash_probe(rows, lanes, step, h, n_b)
    add_in_order(vals, slots, lanes, walk_products(a_vals, b_vals, walk))
    cell = slots * n_b + lanes
    last = len(cell) - 1 - np.unique(cell[::-1], return_index=True)[1]
    t = (lambda x: torch.from_numpy(x).to(dev))
    keys[:, t(slots[last]), t(lanes[last])] = t(rows[last].astype(np.int32))
    return keys, vals
