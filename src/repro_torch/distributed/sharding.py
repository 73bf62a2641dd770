"""Sharding rules: logical parameter/activation axes -> mesh axes.

The port of the JAX package's ``repro/distributed/sharding.py``.  One rule
set serves all ten architectures:
  * TP over 'model'  — heads (fused q/kv dims), d_ff, experts, vocab, d_inner
  * FSDP over 'data' (+ 'pod' when present) — the d_model ('embed') axis of
    every weight, so parameters + optimizer state are fully sharded (ZeRO-3)
  * DP over ('pod','data') — the batch dim of every activation/input
Divisibility fallbacks are applied per-tensor in
``models.params.partition_specs``.

PyTorch has no ``jax.sharding``, so the port keeps its own two small
types: :class:`PartitionSpec`, a tuple whose entries are ``None``, a mesh
axis name, or a tuple of names (equal, entry by entry, to the reference's
``P``), and :class:`NamedSharding`, a spec on a mesh
(``repro_torch.launch.mesh.Mesh``) that gives a tensor's per-device shape.
Nothing here places a tensor: the launch dry run sizes every device's share
with them, and on the one-card mesh every share is the whole tensor.
"""

from __future__ import annotations

import math


class PartitionSpec(tuple):
    """The mesh axes each dimension of a tensor is split over: per entry
    ``None`` (replicated), an axis name, or a tuple of axis names.  Shorter
    than the tensor's rank means the trailing dimensions are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def _axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


class NamedSharding:
    """``spec`` on ``mesh``: the counterpart of ``jax.sharding.
    NamedSharding`` as far as the dry run needs it."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def local_shape(self, global_shape) -> tuple:
        """One device's share of a tensor of ``global_shape`` (a dimension
        that does not divide is padded up, as XLA pads it)."""
        sizes = mesh_axis_sizes(self.mesh)
        parts = tuple(self.spec) + (None,) * (len(global_shape)
                                             - len(self.spec))
        return tuple(-(-n // math.prod(sizes[a] for a in _axes(part)))
                     for n, part in zip(global_shape, parts))

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh == self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """Axes carrying data parallelism (pod is DP unless pipelining)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def sharding_rules(mesh, mode: str = "train") -> dict:
    """mode="train": ZeRO-3 (params+optimizer FSDP over dp) x TP.
    mode="serve": params replicated over dp, TP only — decode reads every
    weight once per token, so per-token FSDP all-gathers would dominate the
    step; replication costs params_bytes/TP per device."""
    if mode not in ("train", "serve"):
        raise ValueError(f"unknown mode {mode!r}; 'train' or 'serve'")
    dp = dp_axes(mesh)
    return {
        "__sizes__": mesh_axis_sizes(mesh),
        # parameters
        "embed": dp if mode == "train" else None,  # FSDP on d_model (train)
        "vocab": "model",
        "mlp": "model",
        "heads": "model",         # fused (n_heads * d_head) projection dim
        # EP: train shards experts over TP; serving shards them over DP so
        # per-device expert bytes stay bounded with replicated dense weights
        "experts": "model" if mode == "train" else tuple(dp),
        "ssm_inner": "model",
        "layers": None,           # the reps' axis is never sharded
        None: None,
    }


def _dp_for(mesh, batch: int):
    """The longest prefix of the DP axes whose sizes divide ``batch``: a
    name, a tuple of names, or None."""
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    for k in range(len(dp), 0, -1):
        if batch % math.prod(sizes[a] for a in dp[:k]) == 0:
            return dp[:k] if k > 1 else dp[0]
    return None


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> PartitionSpec:
    """[B, ...] activations/inputs: shard B over the DP axes that divide
    it."""
    return P(_dp_for(mesh, batch), *([None] * extra_dims))


def param_sharding(table_specs, mesh):
    """PartitionSpec tree -> NamedSharding tree."""
    if isinstance(table_specs, PartitionSpec):
        return NamedSharding(mesh, table_specs)
    return {k: param_sharding(v, mesh) for k, v in table_specs.items()}


def cache_specs(cfg, cache_abstract, mesh):
    """Serve-cache sharding, leaf by leaf, by each leaf's key.

    KV caches [rep, B, S, Hkv, Dh]: B over DP when divisible; heads over
    'model' when divisible, else the sequence dim (context-parallel cache).
    SSM states: d_inner over 'model'.  Cross-memory caches like KV.
    """
    model = mesh_axis_sizes(mesh).get("model", 1)

    def leaf_spec(name, leaf):
        shape = leaf.shape
        if name in ("k", "v", "xk", "xv"):      # [rep, B, S, H, Dh]
            _, b, s, h, _ = shape
            bspec = _dp_for(mesh, b)
            if h % model == 0 and h >= model:
                return P(None, bspec, None, "model", None)
            if s % model == 0:
                return P(None, bspec, "model", None, None)
            return P(None, bspec, None, None, None)
        if name == "conv":                       # [rep, B, K-1, d_inner]
            din = shape[-1]
            return P(None, _dp_for(mesh, shape[1]), None,
                     "model" if din % model == 0 else None)
        if name == "h":                          # mamba state
            if len(shape) == 4:                  # [rep, B, din, ds]
                din = shape[2]
                return P(None, _dp_for(mesh, shape[1]),
                         "model" if din % model == 0 else None, None)
            # [rep, B, nh, hd, ds]
            nh = shape[2]
            return P(None, _dp_for(mesh, shape[1]),
                     "model" if nh % model == 0 else None, None, None)
        return P()

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        return leaf_spec(name, node)

    return walk(None, cache_abstract)
