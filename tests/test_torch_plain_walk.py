"""The lock-step kernels' plain versions (K2 SPA, K3 SPARS, K4 HASH and
their batched forms) against the step loops they replaced, on the CPU.

The plain versions take their walk from the pattern on the host and add
each cell's products rank by rank (``kernels/spars.py::lockstep_walk``,
``add_in_order``; ``hash_spgemm.py::hash_probe``).  The loops below are
the per-step versions they replaced, one indexed read-modify-write a
step, kept as the reference: the arithmetic is unchanged, so every output
must be equal bit for bit, on random padded operands with empty A
columns, cut trip counts and hash tables small enough to fill (the slot-0
fallback).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.hash_spgemm import EMPTY, hash_slot, \
    hash_spgemm_batched_plain
from repro_torch.kernels.spa import spa_spgemm_batched_plain
from repro_torch.kernels.spars import spars_spgemm_batched_plain


class _Cursors:
    """The lock-step lane cursors, one ``advance`` a step."""

    def __init__(self, a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                 block_cols):
        self.a_rows, self.a_vals, self.a_nnz = a_rows, a_vals, a_nnz
        self.b_rows, self.b_vals, self.b_nnz = b_rows, b_vals, b_nnz
        n_b = b_rows.shape[0]
        self.lane_steps = steps.repeat_interleave(block_cols)
        self.vidx_b = torch.zeros(n_b, dtype=torch.int64)
        self.vcnt_a = torch.zeros(n_b, dtype=torch.int64)
        self.n_steps = int(steps.max()) if len(steps) else 0

    def active(self, s):
        return (self.vidx_b < self.b_nnz) & (s < self.lane_steps)

    def fetch(self, lanes):
        vb = self.vidx_b[lanes]
        k = self.b_rows[lanes, vb].long()
        ka = self.vcnt_a[lanes]
        prod = self.a_vals[:, k, ka] * self.b_vals[:, lanes, vb]
        return self.a_rows[k, ka].long(), prod

    def advance(self, lanes):
        k = self.b_rows[lanes, self.vidx_b[lanes]].long()
        last = self.vcnt_a[lanes] + 1 >= self.a_nnz[k]
        self.vcnt_a[lanes] = torch.where(last, 0, self.vcnt_a[lanes] + 1)
        self.vidx_b[lanes] = self.vidx_b[lanes] + last.long()


def spa_loop(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m):
    batch, n_b, za = a_vals.shape[0], b_rows.shape[0], a_rows.shape[1]
    out = torch.zeros((batch, m, n_b))
    lanes = torch.arange(n_b)[:, None].expand(n_b, za)
    z = torch.arange(za)[None, :]
    for e in range(int(b_nnz.max()) if n_b else 0):
        k = b_rows[:, e].long()
        live = (e < b_nnz)[:, None] & (z < a_nnz[k][:, None])
        rows, cols = a_rows[k].long()[live], lanes[live]
        prod = (a_vals[:, k][:, live]
                * b_vals[:, :, e, None].expand(batch, n_b, za)[:, live])
        out[:, rows, cols] = out[:, rows, cols] + prod
    return out


def spars_loop(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, m, bc):
    batch, n_b = a_vals.shape[0], b_rows.shape[0]
    acc = torch.zeros((batch, m, n_b))
    flags = torch.zeros((batch, m, n_b))
    cur = _Cursors(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, bc)
    for s in range(cur.n_steps):
        lanes = torch.nonzero(cur.active(s), as_tuple=True)[0]
        if len(lanes) == 0:
            break
        rows, prod = cur.fetch(lanes)
        acc[:, rows, lanes] = acc[:, rows, lanes] + prod
        flags[:, rows, lanes] = 1.0
        cur.advance(lanes)
    return acc, flags


def hash_loop(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, h, bc):
    batch, n_b = a_vals.shape[0], b_rows.shape[0]
    keys = torch.full((batch, h, n_b), EMPTY, dtype=torch.int32)
    vals = torch.zeros((batch, h, n_b))
    elem = torch.arange(batch)[:, None]
    cur = _Cursors(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, bc)
    for s in range(cur.n_steps):
        lanes = torch.nonzero(cur.active(s), as_tuple=True)[0]
        if len(lanes) == 0:
            break
        rows, prod = cur.fetch(lanes)
        pos = hash_slot(rows, h).expand(batch, -1)
        slot = torch.zeros_like(pos)
        todo = torch.ones_like(pos, dtype=torch.bool)
        for _ in range(h):
            key = keys[elem, pos, lanes].long()
            hit = todo & ((key == rows) | (key == EMPTY))
            slot = torch.where(hit, pos, slot)
            todo = todo & ~hit
            if not bool(todo.any()):
                break
            pos = torch.where(todo, (pos + 1) & (h - 1), pos)
        vals[elem, slot, lanes] = vals[elem, slot, lanes] + prod
        keys[elem, slot, lanes] = rows.to(torch.int32)
        cur.advance(lanes)
    return keys, vals


def operands(seed):
    """Random padded operands: distinct rows per A column, a fifth of the
    A columns empty, B entries naming any A column, trip counts full or
    (every third seed) cut."""
    rng = np.random.default_rng(seed)
    m, n_a = int(rng.integers(8, 200)), int(rng.integers(4, 60))
    za, zb = int(rng.integers(1, 12)), int(rng.integers(1, 10))
    bc = int(rng.choice([4, 8, 16]))
    n_blocks = int(rng.integers(1, 4))
    n_b, batch = bc * n_blocks, int(rng.choice([1, 2, 3]))
    a_nnz = rng.integers(0, za + 1, n_a)
    a_nnz[rng.random(n_a) < 0.2] = 0
    a_rows = np.zeros((n_a, za), np.int32)
    for i in range(n_a):
        a_rows[i, :a_nnz[i]] = rng.choice(m, a_nnz[i], replace=False)
    b_nnz = rng.integers(0, zb + 1, n_b)
    b_rows = rng.integers(0, n_a, (n_b, zb)).astype(np.int32)
    full = np.array([sum(max(1, a_nnz[k]) for k in b_rows[l, :b_nnz[l]])
                     for l in range(n_b)])
    steps = full.reshape(n_blocks, bc).max(1)
    if seed % 3 == 0:
        steps = np.maximum(steps - rng.integers(0, 5, n_blocks), 0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))

    av = torch.from_numpy(rng.normal(size=(batch, n_a, za)).astype(
        np.float32))
    bv = torch.from_numpy(rng.normal(size=(batch, n_b, zb)).astype(
        np.float32))
    h = int(rng.choice([4, 8, 16, 64]))
    return (t(a_rows), av, t(a_nnz), t(b_rows), bv, t(b_nnz), t(steps), m,
            bc, h)


def same_bits(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(got.numpy().view(np.uint8), want.numpy().view(
            np.uint8))


@pytest.mark.parametrize("seed", range(40))
def test_plain_versions_equal_the_step_loops(seed):
    ar, av, an, br, bv, bn, steps, m, bc, h = operands(seed)
    assert same_bits(spa_spgemm_batched_plain(ar, av, an, br, bv, bn, m=m),
                     spa_loop(ar, av, an, br, bv, bn, m))
    for got, want in zip(
            spars_spgemm_batched_plain(ar, av, an, br, bv, bn, steps, m=m,
                                       block_cols=bc),
            spars_loop(ar, av, an, br, bv, bn, steps, m, bc)):
        assert same_bits(got, want)
    for got, want in zip(
            hash_spgemm_batched_plain(ar, av, an, br, bv, bn, steps, h=h,
                                      block_cols=bc),
            hash_loop(ar, av, an, br, bv, bn, steps, h, bc)):
        assert same_bits(got, want)
