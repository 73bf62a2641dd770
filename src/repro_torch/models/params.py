"""Declarative parameters: one table drives init and shapes.

A *table* is a nested dict whose leaves are ``Leaf(shape, axes, init)``:
  shape : tuple of ints
  axes  : tuple of logical axis names (len == len(shape)); None = replicated
  init  : "normal:<std>" | "zeros" | "ones" | "fan_in" | "ssm_a" | "dt_bias"

The port of the JAX package's ``repro/models/params.py`` as far as the
dense model stack needs it: :func:`init_params` draws every leaf from one
explicit ``torch.Generator``; :func:`stack_tables` prepends the reps' axis
that ``models.blocks`` loops over.  ``abstract_params`` and
``partition_specs`` wait for the mesh and the dry run, the only callers of
a table's shapes and shardings without its values.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple
    init: str = "fan_in"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in length")


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


def init_params(table, generator: torch.Generator, device=None):
    """The table's tensors, f32, on ``device`` (default the card).

    Leaves are drawn in sorted-key order (the order ``jax.tree_util``
    flattens a dict), one after another from ``generator``, which must lie
    on ``device``.  The numbers differ from the JAX package's for the same
    seed: tests carry weights across as numpy arrays instead.
    """
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Leaf):
            return _init_leaf(node, generator, dev)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(table)


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
