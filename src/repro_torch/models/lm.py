"""Full language model: tables, init, train/prefill/decode entry points.

The port of the JAX package's ``repro/models/lm.py``, every family.  Public
surface:
  model_tables(cfg)                          -> declarative param table
  init_model(cfg, generator, device=None)    -> param tree on the card
  train_loss(params, cfg, batch)             batch: tokens, labels (+aux)
  prefill(params, cfg, tokens, aux=None)     -> final hidden
  decode_step(params, cfg, token, cache, cur_len) -> (logits, cache)
  init_cache(cfg, batch, cache_len)

``sparse_ffn=`` is the spgemm-path FFN overlay of
:func:`~repro_torch.models.sparse_ffn.sparsify_ffn_params`: each overlaid
sub-layer's FFN runs the cached SpGEMM plans' product stream on its rep's
value stacks instead of the dense SwiGLU.  ``torch.autograd`` differentiates
``train_loss`` through every family (``repro_torch.training`` builds the
train step on it); ``cfg.remat`` picks what its backward keeps.

``aux`` is the cross-attention families' input: the VLM's pre-projected
patch embeddings [B, n_image_tokens, D] and the encoder-decoder's frame
embeddings [B, n_audio_frames, D] (the reference's frontends are stubs);
the other families ignore it.  Decode reads the memory's K/V from the
cache, where the serving engine writes them
(``repro_torch.serving.ServeEngine``).
"""

from __future__ import annotations

import torch

from repro_torch.models import params as pp
from repro_torch.models.blocks import stage_cache, stage_decode, \
    stage_decode_loop, stage_forward, superblock_table, _sub_table
from repro_torch.models.layers import embed, embed_table, lm_logits, \
    lm_loss, rms_norm, unembed_table
from repro_torch.models.params import init_params, stack_tables

AUX_COEF = 0.01


def model_tables(cfg):
    table, _, n_rep, shared = superblock_table(cfg)
    t = {
        "embed": embed_table(cfg),
        "blocks": stack_tables(table, n_rep),
        "final_norm": pp.rmsnorm(cfg.d_model),
        "unembed": unembed_table(cfg),
    }
    if shared is not None:
        t["shared"] = shared
    if cfg.family == "encdec":
        t["encoder"] = stack_tables({"l0": _sub_table(cfg, "enc_attn_ffn")},
                                    cfg.n_encoder_layers)
        t["enc_norm"] = pp.rmsnorm(cfg.d_model)
    return t


def init_model(cfg, generator: torch.Generator, device=None):
    """The model's f32 params on ``device`` (default the card), drawn from
    ``generator`` (which lies on that device)."""
    return init_params(model_tables(cfg), generator, device)


def _memory_from_aux(params, cfg, aux):
    """The cross-attention memory: for encdec the encoder's output on the
    frame embeddings ``aux`` (``n_encoder_layers`` non-causal layers, then
    ``enc_norm``), for vlm the patch embeddings ``aux`` as they are, and
    None for the other families (which ignore ``aux``)."""
    if cfg.family == "encdec":
        h, _ = stage_forward(params["encoder"], None, cfg, ["enc_attn_ffn"],
                             aux, causal=False)
        return rms_norm(params["enc_norm"], h, cfg.norm_eps)
    if cfg.family == "vlm":
        return aux
    return None


def backbone(params, cfg, tokens, aux=None, *, sparse_ffn=None):
    """tokens [B,S] -> final-normed hidden [B,S,D] (+ MoE aux loss)."""
    h = embed(params["embed"], tokens)
    memory = _memory_from_aux(params, cfg, aux)
    _, kinds, _, _ = superblock_table(cfg)
    h, aux_loss = stage_forward(params["blocks"], params.get("shared"), cfg,
                                kinds, h, memory=memory,
                                sparse_ffn=sparse_ffn)
    return rms_norm(params["final_norm"], h, cfg.norm_eps), aux_loss


def train_loss(params, cfg, batch, *, sparse_ffn=None):
    """batch: dict(tokens [B,S], labels [B,S], aux?) -> scalar loss."""
    h, aux_loss = backbone(params, cfg, batch["tokens"], batch.get("aux"),
                           sparse_ffn=sparse_ffn)
    loss = lm_loss(params["unembed"], cfg, h, batch["labels"])
    return loss + AUX_COEF * aux_loss.to(loss.dtype)


def prefill(params, cfg, tokens, aux=None, *, sparse_ffn=None):
    h, _ = backbone(params, cfg, tokens, aux, sparse_ffn=sparse_ffn)
    return h


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None):
    """Zero caches stacked on the reps' axis, on ``device`` (default the
    card): K/V in ``dtype`` (bf16 by default, as in the reference), a mamba
    sub-layer's conv window in ``dtype`` and its SSM state in f32.  A
    decode step returns the window in f32 (the step's input is promoted
    with it, as in the reference)."""
    _, kinds, n_rep, _ = superblock_table(cfg)
    return stage_cache(cfg, kinds, n_rep, batch, cache_len, dtype, device)


def decode_step(params, cfg, token, cache, cur_len, *, sparse_ffn=None):
    """token [B,1] int -> (logits [B,1,Vpad], new_cache).

    ``cur_len``: an int, or a ``[B]`` tensor of per-slot counts of tokens
    already in the cache.  With ``sparse_ffn``, each overlaid sub-layer's
    FFN runs its plans' product stream on the device; on operands already
    there, a step whose plans are built makes no host sync.
    """
    h = embed(params["embed"], token)
    _, kinds, _, _ = superblock_table(cfg)
    h, new_cache = stage_decode(params["blocks"], params.get("shared"), cfg,
                                kinds, h, cache, cur_len,
                                sparse_ffn=sparse_ffn)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params["unembed"], cfg, h), new_cache


def decode_step_loop(params, cfg, token, cache, cur_len, *,
                     sparse_ffn=None, sparse_host=True):
    """:func:`decode_step` with overlay FFNs on the host product stream
    (``sparse_host=True``): the serving fallback tick, which never waits on
    a device plan build.  Same signature and return as
    :func:`decode_step`."""
    h = embed(params["embed"], token)
    _, kinds, _, _ = superblock_table(cfg)
    h, new_cache = stage_decode_loop(
        params["blocks"], params.get("shared"), cfg, kinds, h, cache, cur_len,
        sparse_ffn=sparse_ffn, sparse_host=sparse_host)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return lm_logits(params["unembed"], cfg, h), new_cache
