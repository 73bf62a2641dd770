"""Input specs: meta-tensor stand-ins and shardings for every cell.

The port of the JAX package's ``repro/launch/specs.py``; a tensor on
``device="meta"`` (a shape and a dtype, no storage) stands in for
``jax.ShapeDtypeStruct``.  Train cells feed (state, batch, step); decode
cells feed (params, token, cache, cur_len); prefill cells feed (params,
tokens[, aux]).  Modality frontends are stubs: aux inputs are precomputed
frame/patch embeddings.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import NamedSharding, batch_spec, \
    cache_specs, param_sharding
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.lm import init_cache


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _aux_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
    if cfg.family == "vlm":
        return _meta((batch, cfg.n_image_tokens, cfg.d_model), dtype)
    if cfg.family == "encdec":
        return _meta((batch, cfg.n_audio_frames, cfg.d_model), dtype)
    return None


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
    }
    shardings = {
        "tokens": NamedSharding(mesh, batch_spec(mesh, b, 1)),
        "labels": NamedSharding(mesh, batch_spec(mesh, b, 1)),
    }
    aux = _aux_spec(cfg, b)
    if aux is not None:
        batch["aux"] = aux
        shardings["aux"] = NamedSharding(mesh, batch_spec(mesh, b, 2))
    return batch, shardings


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       cache_dtype=torch.bfloat16):
    b, s = shape.global_batch, shape.seq_len
    token = _meta((b, 1), torch.int32)
    cur_len = _meta((b,), torch.int32)
    cache = init_cache(cfg, b, s, dtype=cache_dtype, device="meta")
    cache_sh = param_sharding(cache_specs(cfg, cache, mesh), mesh)
    tok_sh = NamedSharding(mesh, batch_spec(mesh, b, 1))
    len_sh = NamedSharding(mesh, batch_spec(mesh, b, 0))
    return (token, cache, cur_len), (tok_sh, cache_sh, len_sh)


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b, s = shape.global_batch, shape.seq_len
    tokens = _meta((b, s), torch.int32)
    sh = {"tokens": NamedSharding(mesh, batch_spec(mesh, b, 1))}
    batch = {"tokens": tokens}
    aux = _aux_spec(cfg, b)
    if aux is not None:
        batch["aux"] = aux
        sh["aux"] = NamedSharding(mesh, batch_spec(mesh, b, 2))
    return batch, sh
