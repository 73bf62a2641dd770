"""Declarative parameters: one table drives init, shapes, and sharding.

A *table* is a nested dict whose leaves are ``Leaf(shape, axes, init)``:
  shape : tuple of ints
  axes  : tuple of logical axis names (len == len(shape)); None = replicated
  init  : "normal:<std>" | "zeros" | "ones" | "fan_in" | "ssm_a" | "dt_bias"

The port of the JAX package's ``repro/models/params.py``.  From one table
  * :func:`init_params` draws every leaf from one explicit
    ``torch.Generator``;
  * :func:`abstract_params` gives its tensors on ``device="meta"`` (a shape
    and a dtype, no storage: the counterpart of ``jax.ShapeDtypeStruct``);
  * :func:`partition_specs` gives each leaf's
    :class:`~repro_torch.distributed.sharding.PartitionSpec`.
:func:`stack_tables` prepends the reps' axis that ``models.blocks`` loops
over.

``rules`` maps logical axis -> mesh axis (or tuple).  Divisibility is
checked per leaf: if a dim doesn't divide over the assigned mesh axes, the
rule falls back to a prefix of the mesh-axis tuple, then to replication,
so one rule set serves every architecture.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import PartitionSpec


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple
    init: str = "fan_in"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in length")


def _is_leaf(x):
    return isinstance(x, Leaf)


def _map_table(table, fn):
    """``fn`` on every leaf of ``table``, keys in sorted order (the order
    ``jax.tree_util`` flattens a dict)."""
    if _is_leaf(table):
        return fn(table)
    return {k: _map_table(table[k], fn) for k in sorted(table)}


def _init_leaf(leaf: Leaf, generator, device):
    shape, kind = leaf.shape, leaf.init
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "ssm_a":
        # mamba: A = -exp(A_log), A_log = log(1..n) with n the last axis
        # (for Mamba2's (nh,) leaf that is nh), as in the reference
        n = shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=device))
        return torch.broadcast_to(base, shape).clone()
    if kind == "dt_bias":
        # mamba: dt bias so softplus(dt) ~ uniform[1e-3, 1e-1]
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if kind.startswith("normal:"):
        std = float(kind.split(":")[1])
    elif kind == "fan_in":
        # the reference's rule: the first axis, which on a stacked leaf is
        # the reps' axis (std 1 / sqrt(n_rep)), kept as it is
        std = 1.0 / math.sqrt(max(shape[0], 1))
    else:
        raise ValueError(kind)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * std


def init_params(table, generator: torch.Generator, device=None,
                dtype=torch.float32):
    """The table's tensors in ``dtype`` on ``device`` (default the card).

    Leaves are drawn in f32, in sorted-key order (the order
    ``jax.tree_util`` flattens a dict), one after another from
    ``generator``, which must lie on ``device``; each is then rounded once
    to ``dtype`` (to nearest, ties to even, as the reference's ``astype``),
    so a bf16 draw is the f32 draw rounded and an f32 draw is unchanged.
    The numbers differ from the JAX package's for the same seed: tests
    carry weights across as numpy arrays instead.
    """
    dev = resolve_device(device)
    return _map_table(
        table, lambda l: _init_leaf(l, generator, dev).to(dtype))


def abstract_params(table, dtype=torch.float32):
    """The table's tensors on ``device="meta"``: shapes and ``dtype``, no
    storage."""
    return _map_table(
        table, lambda l: torch.empty(l.shape, dtype=dtype, device="meta"))


def _spec_for(leaf: Leaf, rules: dict) -> PartitionSpec:
    parts = []
    used: set = set()  # a mesh axis may shard at most one dim per tensor
    for dim, ax in zip(leaf.shape, leaf.axes):
        assigned = rules.get(ax)
        if assigned is None:
            parts.append(None)
            continue
        if isinstance(assigned, str):
            assigned = (assigned,)
        assigned = tuple(a for a in assigned if a not in used)
        # longest prefix of the mesh-axis tuple that divides the dim
        chosen = None
        for k in range(len(assigned), 0, -1):
            prod = math.prod(rules["__sizes__"][a] for a in assigned[:k])
            if dim % prod == 0:
                chosen = assigned[:k]
                break
        if chosen:
            used.update(chosen)
        parts.append(chosen if chosen is None or len(chosen) > 1
                     else chosen[0])
    return PartitionSpec(*parts)


def partition_specs(table, rules: dict):
    return _map_table(table, lambda l: _spec_for(l, rules))


def linear(d_in, d_out, ax_in, ax_out, *, bias=False, init="fan_in"):
    t = {"w": Leaf((d_in, d_out), (ax_in, ax_out), init)}
    if bias:
        t["b"] = Leaf((d_out,), (ax_out,), "zeros")
    return t


def stack_tables(table, n: int):
    """Prepend a scan ('layers') axis of length n to every leaf."""
    if isinstance(table, Leaf):
        return Leaf((n,) + table.shape, ("layers",) + table.axes, table.init)
    return {k: stack_tables(v, n) for k, v in table.items()}


def rmsnorm(d, ax="embed"):
    return {"scale": Leaf((d,), (ax,), "ones")}
