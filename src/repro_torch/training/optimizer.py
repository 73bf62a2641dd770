"""AdamW with optional 8-bit moments.

The port of the JAX package's ``repro/training/optimizer.py``.  The
quantized variant stores both Adam moments as int8 with per-row f32 absmax
scales (last-axis granularity), keeping each tensor's shape; tensors with
fewer than 2 dims (norm scales, biases) keep f32 moments.

The update runs in place under ``torch.no_grad()``: the params and the
optimizer state handed to :func:`adamw_update` are the ones it returns,
updated, the counterpart of the reference's donated buffers, so a step
holds no second copy of either.  Its arithmetic is the reference's,
operation for operation in f32 (``torch.round``, like ``jnp.round``,
rounds half to even); the gradient norm adds the leaves in sorted-key
order, the order of ``jax.tree_util``.  :func:`opt_state_specs` gives
the state's ``PartitionSpec`` tree, leaf for leaf the layout of
:func:`adamw_init`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.training.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantize_moments: bool = False
    grad_clip: float = 1.0


def _quantizable(x) -> bool:
    return x.dim() >= 2


def _quantize(x):
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q, scale):
    return q.float() * scale


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments beside ``params``, and the step counter (int32) on the
    first leaf's device."""

    def moment(p):
        if cfg.quantize_moments and _quantizable(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros(p.shape[:-1] + (1,),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(moment, params),
        "v": tree_map(moment, params),
    }


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr):
    """Returns (params, opt_state), both updated in place.  ``lr`` is a
    float or an f32 0-dim tensor (on the host or the params' device)."""
    step = opt_state["step"].add_(1).float()
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    def upd(p, g, m, v):
        g = g.float() * clip
        quant = isinstance(m, dict)
        m_f = _dequantize(m["q"], m["scale"]) if quant else m
        v_f = _dequantize(v["q"], v["scale"]) if quant else v
        # b1 * m + (1 - b1) * g, each product rounded, then the sum
        m_f.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_f.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        v_f.clamp_(min=0.0)   # quantization can ring slightly negative
        denom = (v_f / bc2).sqrt_().add_(cfg.eps)
        delta = (m_f / bc1).div_(denom)
        if p.dim() >= 2:      # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        if quant:
            for state, x in ((m, m_f), (v, v_f)):
                q, s = _quantize(x)
                state["q"].copy_(q)
                state["scale"].copy_(s)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, opt_state


def opt_state_specs(param_specs, cfg: AdamWConfig, params_abstract):
    """PartitionSpec tree for the optimizer state (mirrors params): an
    8-bit moment is ``{"q": spec, "scale": spec}`` with the scale's last
    entry None (its last dim is 1), an f32 moment the param's spec."""

    def moment_spec(spec, p):
        if cfg.quantize_moments and _quantizable(p):
            scale = (PartitionSpec(*(list(spec)[:-1] + [None])) if len(spec)
                     else spec)
            return {"q": spec, "scale": scale}
        return spec

    m = tree_map(moment_spec, param_specs, params_abstract)
    return {"step": PartitionSpec(), "m": m, "v": m}
