"""Mixture-of-Experts layer with sort-based capacity dispatch.

The port of the JAX package's ``repro/models/moe.py``.  The router's top-k
assignment defines a sparse tokens x experts matrix; the dispatch ``R^T X``
and combine ``R Y`` are the SpGEMM pattern of the paper: the per-expert
token count is the ``Op_j`` load statistic, capacity is the block size,
and dropping beyond capacity is the masked-lane tail.  Two paths:

 * :func:`moe_ffn` (the model's): flat top-k pairs sorted by expert,
   gathered, padded to per-expert capacity within token groups, and the
   expert FFNs run as batched products in full f32.  GShard capacity
   semantics: an overflowing pair is dropped.
 * :func:`moe_dispatch_spgemm`: the routing matrix materialised as CSC and
   the dispatch run through the port's ``core.spgemm``.

Every shape is static and no step reads a value back to the host: counts
are a fixed-size integer ``scatter_add_`` (``bincount`` sizes its output
from the data), the sorts are stable, and the overflow pairs go to one
extra row that is cut, so a decode step on the card never waits for it.
The backward adds in a fixed order too: every gather is by a permutation
or writes one nonzero per row, and a token's k pair gradients meet in one
``expand``'s sum.
The reference's sharding hints are no-ops on one device and are left out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import params as pp
from repro_torch.models.layers import _einsum, dense


def moe_table(cfg):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    t = {
        "router": pp.linear(d, e, "embed", None, init="normal:0.02"),
        "gate": pp.Leaf((e, d, f), ("experts", "embed", "mlp"), "fan_in"),
        "up": pp.Leaf((e, d, f), ("experts", "embed", "mlp"), "fan_in"),
        "down": pp.Leaf((e, f, d), ("experts", "mlp", "embed"), "fan_in"),
    }
    if m.d_ff_shared:
        t["shared"] = {
            "gate": pp.linear(d, m.d_ff_shared, "embed", "mlp"),
            "up": pp.linear(d, m.d_ff_shared, "embed", "mlp"),
            "down": pp.linear(m.d_ff_shared, d, "mlp", "embed"),
        }
    return t


def _capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _n_groups(t: int, target: int = 32) -> int:
    """Largest divisor of t not exceeding ``target``; one group below 4096
    tokens (decode-sized batches), where the per-group capacity floor would
    multiply the expert slots."""
    if t < 4096:
        return 1
    g = min(target, t)
    while t % g:
        g -= 1
    return max(g, 1)


def _route(p, x):
    """Router softmax of x [T, D] in f32: probs [T, E]."""
    return torch.softmax(dense(p["router"], x).float(), dim=-1)


def _top_k(probs, k: int):
    """``lax.top_k`` of the rows: the k largest, a tie to the lower index
    first (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _dispatch(xg, eg, gg, *, e: int, cap: int):
    """Sort-based dispatch of G token groups at once, each group's indices
    kept apart: the pairs are sorted by (group, expert), stably, so each
    group's order is the reference's vmapped ``_dispatch_group``'s.

    xg [G, Tg, D]; eg/gg [G, Tg, k] expert ids / gates.  Returns (x_disp
    [G, E, cap, D], dst, keep, g_sorted, tok_sorted, order), each of the
    last five [G*Tg*k] over the sorted pairs: ``dst`` a row of x_disp seen
    as [G*E*cap, D] (``G*E*cap`` for a dropped pair), ``tok_sorted`` a
    token of the flat [G*Tg] axis, ``order`` the flat pair index
    ``token * k + j`` at each sorted position.
    """
    g, tg, d = xg.shape
    k = eg.shape[2]
    n = g * tg * k
    dev = xg.device
    key = (eg.long() + e * torch.arange(g, device=dev)[:, None, None]
           ).reshape(-1)                                     # group * E + e
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    tok_sorted = order // k
    g_sorted = gg.reshape(-1)[order]
    counts = torch.zeros(g * e, dtype=torch.long, device=dev).scatter_add_(
        0, key, torch.ones_like(key))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n, device=dev) - seg_start[key_sorted]
    keep = pos_in_e < cap
    dst = torch.where(keep, key_sorted * cap + pos_in_e, g * e * cap)
    # each token's row once per pair, gathered by the pairs' permutation:
    # the backward adds a token's k pair gradients by ``expand``'s sum, in
    # a fixed order, where gathering rows by ``tok_sorted`` would add them
    # with atomics on the card
    x_sorted = xg.reshape(g * tg, 1, d).expand(g * tg, k, d).reshape(
        n, d)[order]
    # every kept destination is unique; only the overflow row g * e * cap
    # repeats, it receives zeros and is cut: a copy, not an accumulation
    x_disp = torch.zeros((g * e * cap + 1, d), dtype=xg.dtype, device=dev)
    x_disp.index_copy_(0, dst, torch.where(keep[:, None], x_sorted, 0.0))
    return (x_disp[:-1].reshape(g, e, cap, d), dst, keep, g_sorted,
            tok_sorted, order)


def _dispatch_group(xg, eg, gg, *, e: int, cap: int):
    """Sort-based dispatch within one token group, as the reference's
    ``_dispatch_group``: xg [Tg, D]; eg/gg [Tg, k] expert ids / gates.
    Returns (x_disp [E, cap, D], dst [Tg*k], keep [Tg*k], g_sorted,
    tok_sorted)."""
    x_disp, dst, keep, g_sorted, tok_sorted, _ = _dispatch(
        xg[None], eg[None], gg[None], e=e, cap=cap)
    return x_disp[0], dst, keep, g_sorted, tok_sorted


def _combine(y_disp, dst, keep, g_sorted, order, eg):
    """The weighted sum of each token's kept pairs' expert outputs.

    y_disp [G, E, cap, D]; dst/keep/g_sorted/order from :func:`_dispatch`;
    eg [G, Tg, k] the expert ids.  Returns [G*Tg, D].  The reference
    scatter-adds a group's pairs in sorted position (``.at[toks].add``,
    which XLA applies update by update), so each token's pairs arrive in
    ascending expert id onto a zero.  The same sum here: each token's k
    contributions ordered by expert and added left to right, a fixed
    order with no atomics.
    """
    g, tg, k = eg.shape
    d = y_disp.shape[-1]
    y_pair = y_disp.reshape(-1, d)[torch.where(keep, dst, 0)]
    y_pair = torch.where(keep[:, None], y_pair, 0.0) * g_sorted[:, None]
    # back to flat (token, j) order, then each token's k pairs by expert
    flat = torch.empty_like(y_pair).index_copy_(0, order, y_pair)
    by_expert = torch.argsort(eg.reshape(g * tg, k).long(), dim=1)
    y_tok = torch.gather(flat.reshape(g * tg, k, d), 1,
                         by_expert[:, :, None].expand(g * tg, k, d))
    y = torch.zeros((g * tg, d), dtype=y_disp.dtype, device=y_disp.device)
    for j in range(k):
        y = y + y_tok[:, j]
    return y


def moe_ffn(p, cfg, x):
    """x [B,S,D] -> [B,S,D]. Grouped sort-based capacity dispatch.

    Tokens are split into groups (:func:`_n_groups`); the permutation,
    gather and scatter of the dispatch are group-local, and each expert
    takes at most ``_capacity(tokens a group)`` pairs of a group: the pairs
    past it are dropped (GShard semantics).
    """
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xf = x.reshape(t, d)

    probs = _route(p, xf)
    gate_vals, expert_idx = _top_k(probs, k)                 # [T, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)           # renormalize

    g = _n_groups(t)
    tg = t // g
    cap = _capacity(tg, cfg)
    eg = expert_idx.reshape(g, tg, k)
    x_disp, dst, keep, g_sorted, _, order = _dispatch(
        xf.reshape(g, tg, d), eg, gate_vals.reshape(g, tg, k), e=e, cap=cap)

    # the reference's plain products "gecd,edf->gecf", "gecf,efd->gecd"
    hid = _einsum("gecd,edf->gecf", x_disp, p["gate"].to(x.dtype))
    up = _einsum("gecd,edf->gecf", x_disp, p["up"].to(x.dtype))
    y_disp = _einsum("gecf,efd->gecd", F.silu(hid) * up,
                     p["down"].to(x.dtype))                  # [G,E,cap,D]
    y = _combine(y_disp, dst, keep, g_sorted, order, eg)

    if "shared" in p:
        sh = p["shared"]
        y = y + dense(sh["down"], F.silu(dense(sh["gate"], xf))
                      * dense(sh["up"], xf))
    return y.reshape(b, s, d)


def moe_aux_loss(p, cfg, x):
    """Switch-style load-balance loss (fraction * mean-prob per expert)."""
    m = cfg.moe
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    probs = _route(p, xf)
    top1 = torch.argmax(probs, dim=-1)      # the first of equal maxima
    counts = torch.zeros(m.n_experts, dtype=torch.float32,
                         device=x.device).scatter_add_(
        0, top1, torch.ones_like(top1, dtype=torch.float32))
    frac = counts / xf.shape[0]
    mean_p = probs.mean(0)
    return m.n_experts * torch.sum(frac * mean_p)


# ---------------------------------------------------------------------------
# the dispatch as an explicit SpGEMM through the port's engine
# ---------------------------------------------------------------------------


def moe_dispatch_spgemm(x, expert_idx, gate_vals, n_experts: int,
                        method: str = "h-hash-256/256", *, device=None):
    """The linear part of the dispatch, ``R^T X``, through ``core.spgemm``.

    R [T, E] holds the gate weight of token t on expert e (``expert_idx``,
    ``gate_vals`` [T, k]); X [T, D] is dense.  The product is computed as
    the SpGEMM ``X^T R`` ([D, T] sparse view of x times R) and returned as
    the ``[E, D]`` per-expert weighted token sums, a tensor on ``device``.

    ``device=None`` is the card: the cuda backend's per-group kernels in
    f32.  ``device="cpu"`` is the host backend in f64, as the reference
    runs it.  The patterns are built on the host from ``x`` and
    ``expert_idx`` (this path reads its operands back).
    """
    from repro_torch.core import spgemm
    from repro_torch.sparse.format import csc_to_dense

    xt, r, backend = dispatch_operands(x, expert_idx, gate_vals, n_experts,
                                       device=device)
    out = spgemm(xt, r, method, backend=backend, device=xt.device)  # [D, E]
    return csc_to_dense(out).T


def dispatch_operands(x, expert_idx, gate_vals, n_experts: int, *,
                      device=None):
    """The operands of :func:`moe_dispatch_spgemm`: ``(X^T [D, T], R [T, E],
    backend)`` as CSC on ``device`` (default the card; f32 there on the
    cuda backend, f64 on the CPU's host backend), their patterns built on
    the host."""
    from repro_torch.device import resolve_device
    from repro_torch.sparse.format import csc_from_dense

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = np.float32 if on_card else np.float64
    x = _host(x, dtype)                                      # [T, D]
    t = x.shape[0]
    idx = _host(expert_idx, np.int64)
    rows = np.repeat(np.arange(t), idx.shape[1])
    vals = _host(gate_vals, dtype).reshape(-1)
    r_dense = np.zeros((t, n_experts), dtype)
    r_dense[rows, idx.reshape(-1)] += vals
    r = csc_from_dense(r_dense).to(dev)
    xt = csc_from_dense(np.ascontiguousarray(x.T)).to(dev)   # [D, T]
    return xt, r, "cuda" if on_card else "host"


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)
