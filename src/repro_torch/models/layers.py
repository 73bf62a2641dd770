"""The layers of the model stack that the sparse FFN needs: ``dense``,
``ffn_table`` and ``ffn`` (dense SwiGLU), as in the JAX package's
``repro/models/layers.py``.  ``ffn`` on the pruned weights is the oracle of
:mod:`repro_torch.models.sparse_ffn`, and its arithmetic is the dense
path's.  The rest of that module waits for the model-stack slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import params as pp


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def ffn_table(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "gate": pp.linear(d, f, "embed", "mlp"),
        "up": pp.linear(d, f, "embed", "mlp"),
        "down": pp.linear(f, d, "mlp", "embed"),
    }


def ffn(p, x):
    return dense(p["down"], torch.nn.functional.silu(dense(p["gate"], x))
                 * dense(p["up"], x))
