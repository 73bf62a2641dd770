"""Super-block assembly: every architecture is a loop over repeated blocks.

The port of the JAX package's ``repro/models/blocks.py``.  A *super-block*
is the smallest repeating unit of a family (one layer for dense/MoE/SSM;
``attn_every`` Mamba layers + one shared attention block for zamba2;
``cross_attn_every`` layers with a trailing cross-attention layer for the
VLM; an alternating dense/MoE pair for llama4).  Its params are stacked on
a leading 'layers' axis; the reference scans over it (``lax.scan``), the
port loops over it in Python, rep by rep, with the same arithmetic.

Sub-layer kinds: "attn_ffn", "attn_moe", "mamba", "shared_attn" (applies the
tied block of the hybrid family's shared table, which the functions here
take as ``shared``), "attn_ffn_cross" (the VLM's gated cross-attention
layer), "enc_attn_ffn" (the encoder's non-causal layer) and
"dec_attn_cross_ffn" (the decoder's layer with cross-attention to the
encoder's memory).  The reference's sharding hints
(``distributed/hints.py``) are no-ops on one device and are left out until
the mesh is ported.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import params as pp
from repro_torch.models.layers import attention, attention_decode, \
    attention_table, cross_attention_cached, ffn, ffn_table, remat, rms_norm
from repro_torch.models.moe import moe_aux_loss, moe_ffn, moe_table
from repro_torch.models.ssm import mamba_forward, mamba_init_state, \
    mamba_table

ATTN_KINDS = ("attn_ffn", "attn_moe", "attn_ffn_cross", "enc_attn_ffn",
              "dec_attn_cross_ffn")
CROSS_KINDS = ("attn_ffn_cross", "dec_attn_cross_ffn")


def block_structure(cfg):
    """(sub-layer kinds per super-block, n_rep, has_shared)."""
    f = cfg.family
    if f == "dense":
        return ["attn_ffn"], cfg.n_layers, False
    if f == "moe":
        il = cfg.moe.interleave
        if il == 1:
            return ["attn_moe"], cfg.n_layers, False
        _check_divides(cfg.n_layers, il)
        return ["attn_ffn"] * (il - 1) + ["attn_moe"], cfg.n_layers // il, \
            False
    if f == "ssm":
        return ["mamba"], cfg.n_layers, False
    if f == "hybrid":
        k = cfg.attn_every
        _check_divides(cfg.n_layers, k)
        return ["mamba"] * k + ["shared_attn"], cfg.n_layers // k, True
    if f == "vlm":
        k = cfg.cross_attn_every
        _check_divides(cfg.n_layers, k)
        return ["attn_ffn"] * (k - 1) + ["attn_ffn_cross"], \
            cfg.n_layers // k, False
    if f == "encdec":
        return ["dec_attn_cross_ffn"], cfg.n_layers, False
    raise ValueError(f)


def _check_divides(n_layers: int, k: int) -> None:
    if n_layers % k:
        raise ValueError(f"{n_layers} layers do not split into super-blocks "
                         f"of {k}")


def _sub_table(cfg, kind):
    if kind in ("attn_ffn", "enc_attn_ffn"):
        return {"ln1": pp.rmsnorm(cfg.d_model), "attn": attention_table(cfg),
                "ln2": pp.rmsnorm(cfg.d_model), "ffn": ffn_table(cfg)}
    if kind == "attn_moe":
        return {"ln1": pp.rmsnorm(cfg.d_model), "attn": attention_table(cfg),
                "ln2": pp.rmsnorm(cfg.d_model), "moe": moe_table(cfg)}
    if kind == "mamba":
        return {"ln": pp.rmsnorm(cfg.d_model), "mamba": mamba_table(cfg)}
    if kind == "shared_attn":
        return {}   # its weights live in the shared table
    if kind in CROSS_KINDS:
        t = {"ln1": pp.rmsnorm(cfg.d_model), "attn": attention_table(cfg),
             "lnx": pp.rmsnorm(cfg.d_model),
             "xattn": attention_table(cfg, bias=False)}
        if kind == "attn_ffn_cross":   # the VLM's tanh gate, 0 at init
            t["xgate"] = pp.Leaf((), (), "zeros")
        return dict(t, ln2=pp.rmsnorm(cfg.d_model), ffn=ffn_table(cfg))
    raise ValueError(kind)


def superblock_table(cfg):
    """(table of one super-block, kinds, n_rep, shared table or None)."""
    kinds, n_rep, has_shared = block_structure(cfg)
    table = {f"l{i}": _sub_table(cfg, k) for i, k in enumerate(kinds)}
    # the hybrid's tied block is an attn_ffn sub-layer, not stacked
    shared = _sub_table(cfg, "attn_ffn") if has_shared else None
    return table, kinds, n_rep, shared


def _rep(tree, r: int):
    """Rep ``r`` of a stacked tree (every leaf indexed on its first axis)."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return tree[r]


def _n_rep(tree) -> int | None:
    """The length of the reps' axis: the first axis of the tree's first
    leaf (a shared_attn sub-layer's subtree is empty)."""
    if isinstance(tree, dict):
        for v in tree.values():
            n = _n_rep(v)
            if n is not None:
                return n
        return None
    return int(tree.shape[0])


def _unstack(tree, n: int) -> list:
    """The ``n`` reps' trees of a stacked tree, each leaf ``unbind`` on its
    first axis: one backward ``stack`` per leaf gathers the reps'
    gradients, where indexing rep by rep would add ``n`` full-size zero
    tensors per leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return torch.unbind(tree)


def _stack(per_rep: list):
    """The reps' trees stacked leaf by leaf on a new first axis."""
    first = per_rep[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in per_rep]) for k in first}
    return torch.stack(per_rep)


def _restack(stacked, old_reps: list, new_reps: list):
    """``new_reps`` stacked leaf by leaf like :func:`_stack`, except that a
    leaf which every rep passed through unchanged (the very views
    ``old_reps`` took of ``stacked``: the memory's K/V at decode) keeps
    ``stacked``'s tensor instead of a copy of it."""
    if isinstance(stacked, dict):
        return {k: _restack(stacked[k], [t[k] for t in old_reps],
                            [t[k] for t in new_reps]) for k in new_reps[0]}
    if all(n is o for n, o in zip(new_reps, old_reps)):
        return stacked
    return torch.stack(new_reps)


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _cross(p, h, xa):
    """The residual add of a cross-attention output, through the VLM's
    ``tanh(xgate)`` where the sub-layer has one."""
    if "xgate" in p:
        xa = torch.tanh(p["xgate"]).to(h.dtype) * xa
    return h + xa


def _sub_forward(p, shared, cfg, kind, h, *, memory=None, causal=True,
                 sffn=None):
    """One sub-layer, full sequence. Returns (h, aux_loss).

    ``shared`` is the hybrid family's tied block (``shared_attn``), None
    for the other families.  ``memory`` [B, N, D] is what the cross kinds
    attend to (image embeddings or the encoder's output); ``causal`` False
    makes every self-attention non-causal (the encoder's kind is always
    non-causal).  ``sffn`` is this sub-layer's spgemm-path FFN overlay: a
    shared-pattern :class:`~repro_torch.models.sparse_ffn.SparseFFN`
    applied with the rep's value stacks ``p["ffn"]`` in place of the dense
    SwiGLU.
    """
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in ATTN_KINDS:
        h = h + attention(p["attn"], cfg,
                          rms_norm(p["ln1"], h, cfg.norm_eps),
                          causal=causal and kind != "enc_attn_ffn")
        if kind in CROSS_KINDS:
            h = _cross(p, h, attention(
                p["xattn"], cfg, rms_norm(p["lnx"], h, cfg.norm_eps),
                kv_src=memory, causal=False, use_rope=False))
        hn = rms_norm(p["ln2"], h, cfg.norm_eps)
        if kind == "attn_moe":
            aux = moe_aux_loss(p["moe"], cfg, hn)
            h = h + moe_ffn(p["moe"], cfg, hn)
        elif sffn is not None:
            h = h + sffn.apply(p["ffn"], hn)
        else:
            h = h + ffn(p["ffn"], hn)
        return h, aux
    if kind == "mamba":
        y, _ = mamba_forward(p["mamba"], cfg,
                             rms_norm(p["ln"], h, cfg.norm_eps))
        return h + y, aux
    if kind == "shared_attn":     # causal, as in the reference
        return _sub_forward(shared, None, cfg, "attn_ffn", h)
    raise ValueError(kind)


def stage_forward(stacked, shared, cfg, kinds, h, *, memory=None,
                  causal=True, sparse_ffn=None):
    """Run the super-block over its reps. Returns (h, total_aux).

    ``cfg.remat`` is the reference's checkpoint policy around each rep
    (:func:`~repro_torch.models.layers.remat`): "full" keeps only a rep's
    input for the backward, "dots" also its un-batched matrix products,
    "none" everything.  It changes what a backward keeps and recomputes,
    never a value of the forward pass.
    """
    sparse_ffn = sparse_ffn or {}

    def block(h, aux, p_rep):
        for i, kind in enumerate(kinds):
            h, a = _sub_forward(p_rep.get(f"l{i}", {}), shared, cfg, kind, h,
                                memory=memory, causal=causal,
                                sffn=sparse_ffn.get(f"l{i}"))
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p_rep in _unstack(stacked, _n_rep(stacked)):
        h, aux = remat(block, h, aux, p_rep, policy=cfg.remat)
    return h, aux


# ---------------------------------------------------------------------------
# decode (one token against caches)
# ---------------------------------------------------------------------------


def sub_cache_shape(cfg, kind, batch, cache_len, dtype=torch.bfloat16,
                    device=None):
    """Zero cache for one sub-layer, on ``device`` (default the card): K/V
    for an attention kind, (conv window, SSM state) for a mamba one, and
    for a cross kind also the memory's K/V ``xk``/``xv`` [B, N, Hkv, Dh]
    (N the config's image tokens or audio frames), which the serving
    engine fills (``ServeEngine._install_memory``)."""
    device = resolve_device(device)
    if kind == "mamba":
        conv, h = mamba_init_state(cfg, batch, dtype, device)
        return {"conv": conv, "h": h}
    if kind not in ("attn_ffn", "attn_moe", "shared_attn") + CROSS_KINDS:
        raise ValueError(kind)

    def kv(n):
        return torch.zeros((batch, n, cfg.n_kv_heads, cfg.d_head),
                           dtype=dtype, device=device)

    out = {"k": kv(cache_len), "v": kv(cache_len)}
    if kind in CROSS_KINDS:
        n = cfg.n_image_tokens if kind == "attn_ffn_cross" \
            else cfg.n_audio_frames
        out.update(xk=kv(n), xv=kv(n))
    return out


def _sub_decode(p, shared, cfg, kind, h, cache, cur_len, *, sffn=None,
                sffn_host=False):
    if kind == "mamba":
        y, (conv, hs) = mamba_forward(
            p["mamba"], cfg, rms_norm(p["ln"], h, cfg.norm_eps),
            state=(cache["conv"], cache["h"]))
        return h + y, {"conv": conv, "h": hs}
    if kind == "shared_attn":
        return _sub_decode(shared, None, cfg, "attn_ffn", h, cache, cur_len)
    if kind not in ("attn_ffn", "attn_moe") + CROSS_KINDS:
        raise ValueError(kind)
    a, ck, cv = attention_decode(
        p["attn"], cfg, rms_norm(p["ln1"], h, cfg.norm_eps),
        cache["k"], cache["v"], cur_len)
    h = h + a
    cache = dict(cache, k=ck, v=cv)
    if kind in CROSS_KINDS:
        h = _cross(p, h, cross_attention_cached(
            p["xattn"], cfg, rms_norm(p["lnx"], h, cfg.norm_eps),
            cache["xk"], cache["xv"]))
    hn = rms_norm(p["ln2"], h, cfg.norm_eps)
    if kind == "attn_moe":
        h = h + moe_ffn(p["moe"], cfg, hn)
    elif sffn is not None:
        # spgemm-path FFN overlay; sffn_host runs the host product stream
        # on the host's copy of hn (the serving fallback)
        y = (sffn.apply_host(p["ffn"], hn) if sffn_host
             else sffn.apply(p["ffn"], hn))
        h = h + torch.as_tensor(y, dtype=h.dtype, device=h.device)
    else:
        h = h + ffn(p["ffn"], hn)
    return h, cache


def _decode_reps(stacked, shared, cfg, kinds, h, caches, cur_len, sparse_ffn,
                 sffn_host):
    sparse_ffn = sparse_ffn or {}
    old_reps, per_rep = [], []
    for r in range(_n_rep(stacked)):
        p_rep, c_rep = _rep(stacked, r), _rep(caches, r)
        new_c = {}
        for i, kind in enumerate(kinds):
            h, new_c[f"l{i}"] = _sub_decode(
                p_rep.get(f"l{i}", {}), shared, cfg, kind, h,
                c_rep[f"l{i}"], cur_len, sffn=sparse_ffn.get(f"l{i}"),
                sffn_host=sffn_host)
        old_reps.append(c_rep)
        per_rep.append(new_c)
    return h, _restack(caches, old_reps, per_rep)


def stage_decode(stacked, shared, cfg, kinds, h, caches, cur_len, *,
                 sparse_ffn=None):
    """Decode over reps; caches stacked on the rep axis.  Overlay FFNs run
    the plans' device stream."""
    return _decode_reps(stacked, shared, cfg, kinds, h, caches, cur_len,
                        sparse_ffn, False)


def stage_decode_loop(stacked, shared, cfg, kinds, h, caches, cur_len, *,
                      sparse_ffn=None, sparse_host=True):
    """:func:`stage_decode` with overlay FFNs on the host product stream
    (``sparse_host=True``): the serving fallback, which needs no device
    plan.  The reference's eager spelling of its scan; here both are the
    same loop."""
    return _decode_reps(stacked, shared, cfg, kinds, h, caches, cur_len,
                        sparse_ffn, sparse_host)


def stage_cache(cfg, kinds, n_rep, batch, cache_len, dtype=torch.bfloat16,
                device=None):
    one = {f"l{i}": sub_cache_shape(cfg, k, batch, cache_len, dtype, device)
           for i, k in enumerate(kinds)}
    return _stack([one] * n_rep)
