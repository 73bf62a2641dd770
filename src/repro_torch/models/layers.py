"""Model primitives: norm, rotary, chunked (flash-style) attention, FFN, loss.

The port of the JAX package's ``repro/models/layers.py``.  All functions
are pure; parameters come from ``params.py`` tables.
Attention is two-level chunked with online softmax, so no ``[S, S]`` score
tensor is ever materialised (the 32k prefill shapes need that), in plain
PyTorch ops: these are the reference's plain-jnp computations outside any
Pallas kernel.  ``scaled_dot_product_attention`` is not used, so the
softmax runs in ``_chunked_attn``'s order, the reference's.

The reference's checkpoint policies are :func:`remat`: each key chunk of
``_chunked_attn`` and each logits chunk of ``lm_loss`` recompute their
insides in the backward, as the reference's ``jax.checkpoint`` does there.
They change what a backward keeps, never a value of the forward pass.

Every product sums in full f32 (:func:`check_full_f32`).  On f32
operands the products are f32; on bf16 params and activations ``dense``
and the unembedding are bf16 GEMMs with f32 sums and a bf16 result, as the
reference's bf16 dot; the attention's and the experts' einsums widen
their operands (exact) and sum in f32, as the reference's
``preferred_element_type=float32`` does (the experts' results are then
rounded to the activations' dtype, as the reference's plain einsum).
Cross-attention (the VLM and encoder-decoder kinds) is :func:`attention`
with ``kv_src=`` over a full sequence and :func:`cross_attention_cached`
against the memory's K/V at decode.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.distributed.hints import hint, hint_heads
from repro_torch.models import params as pp

NEG_INF = -1e30

#: the un-batched matrix products that ``remat(..., policy="dots")`` keeps:
#: the counterpart of ``jax.checkpoint_policies.
#: checkpoint_dots_with_no_batch_dims`` (``einsum``'s batched products run
#: as ``bmm`` and are recomputed)
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_full_f32(x: torch.Tensor) -> None:
    """The model's products sum in full f32, on the card as on the CPU.
    TF32 would keep about three decimal digits of an f32 operand, so a
    caller that switched it on is refused; a product of bf16 operands
    (``x``'s dtype) is refused while cuBLAS may reduce it in bf16
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
    PyTorch's default), where the reference's bf16 dot sums in f32.  The
    CPU has neither, so nothing is refused there."""
    if not x.is_cuda:
        return
    matmul = torch.backends.cuda.matmul
    if x.dtype == torch.bfloat16 \
            and matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "the model sums its bf16 products in f32, but cuBLAS may "
            "reduce them in bf16; set torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction = False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the model computes its products in full f32, but float32 "
            f"matmul precision is {torch.get_float32_matmul_precision()!r} "
            "(TF32); set torch.set_float32_matmul_precision('highest')")


def _dots_context():
    return create_selective_checkpoint_contexts(list(DOTS))


def remat(fn, *args, policy: str = "full"):
    """``fn(*args)``, with the activations inside it recomputed in the
    backward instead of kept: ``policy`` "full" keeps only the inputs (the
    reference's ``jax.checkpoint``, ``nothing_saveable``), "dots" also the
    outputs of the un-batched matrix products (:data:`DOTS`), "none" keeps
    everything.  Where autograd records nothing (``torch.no_grad``, the
    serving paths) this is ``fn(*args)``.  The forward's values are the
    same under every policy."""
    if policy not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat policy {policy!r}; "
                         "'full', 'dots' or 'none'")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    context = {"context_fn": _dots_context} if policy == "dots" else {}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **context)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of the operands widened to f32, with an f32 result: on
    bf16 operands the exact products and f32 sums of the reference's
    ``preferred_element_type=float32``."""
    a, b = a.float(), b.float()
    check_full_f32(a)
    return torch.einsum(eq, a, b)


def rms_norm(p, x, eps=1e-5):
    # variance in f32; the data path stays in x.dtype, as in the reference
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def dense(p, x):
    check_full_f32(x)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x [..., S, H, D]; positions [..., S] (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq             # [..., S, half]
    ang = ang[..., None, :]                               # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_table(cfg, *, bias=None):
    """QKV + out projections; fused head dims.  ``bias`` None takes the
    config's ``qkv_bias`` (the cross-attention tables pass False)."""
    d = cfg.d_model
    bias = cfg.qkv_bias if bias is None else bias
    return {
        "wq": pp.linear(d, cfg.qkv_fused_q, "embed", "heads", bias=bias),
        "wk": pp.linear(d, cfg.qkv_fused_kv, "embed", "heads", bias=bias),
        "wv": pp.linear(d, cfg.qkv_fused_kv, "embed", "heads", bias=bias),
        "wo": pp.linear(cfg.qkv_fused_q, d, "heads", "embed"),
    }


def _kv_step(qb, kb, vb, m, l, acc, q_pos, k0: int, causal: bool):
    """One key chunk of the online softmax: the running max ``m``, sum
    ``l`` and accumulator ``acc`` after the keys ``kb``/``vb`` (their first
    position ``k0``)."""
    s = _einsum("bqhgd,bkhd->bhgqk", qb, kb)
    if causal:
        k_pos = k0 + torch.arange(kb.shape[1], device=qb.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + _einsum(
        "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb)
    return m_new, l, acc


def _chunked_attn(q, k, v, *, causal: bool, q_offset, q_chunk, kv_chunk):
    """Online-softmax attention. q [B,Sq,Hkv,G,D], k/v [B,Skv,Hkv,D].

    The reference's two levels (a map over query chunks, a scan over key
    chunks) as two Python loops, every key chunk visited in order, so each
    query row's running max, sum and accumulator see the same sequence of
    updates.  Each key chunk's step is recomputed in the backward
    (:func:`remat`, the reference's flash-style ``jax.checkpoint``)."""
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    cq = min(q_chunk, sq)
    ck = min(kv_chunk, skv)
    if sq % cq:
        cq = sq   # non-divisible: single chunk
    if skv % ck:
        ck = skv
    nq, nk = sq // cq, skv // ck
    scale = dh ** -0.5
    dev = q.device

    qs = q.reshape(b, nq, cq, hkv, g, dh)
    ks = k.reshape(b, nk, ck, hkv, dh)
    vs = v.reshape(b, nk, ck, hkv, dh)
    outs = []
    for iq in range(nq):
        qb = qs[:, iq] * scale                             # [B,cq,Hkv,G,D]
        q_pos = q_offset + iq * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, dh), dtype=torch.float32,
                          device=dev)
        for ik in range(nk):
            m, l, acc = remat(_kv_step, qb, ks[:, ik], vs[:, ik], m, l, acc,
                              q_pos, ik * ck, causal)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))            # [B,cq,Hkv,G,D]
    return torch.stack(outs, dim=1).reshape(b, sq, hkv, g, dh)


def attention(p, cfg, x, *, kv_src=None, causal=True, use_rope=True):
    """Self- or cross-attention over full sequences (train/prefill).

    Keys and values come from ``kv_src`` [B, Skv, D] (the memory) when it is
    given, else from ``x``; with ``use_rope`` the queries take rotary
    positions 0..S-1 and the keys 0..Skv-1."""
    b, s, _ = x.shape
    kv_in = x if kv_src is None else kv_src
    skv = kv_in.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    q = hint_heads(dense(p["wq"], x).reshape(b, s, hkv, g, dh))
    k = hint_heads(dense(p["wk"], kv_in).reshape(b, skv, hkv, dh),
                   head_dims=(2,))
    v = hint_heads(dense(p["wv"], kv_in).reshape(b, skv, hkv, dh),
                   head_dims=(2,))
    if use_rope:
        positions = torch.arange(s, device=x.device)[None, :]
        kv_positions = torch.arange(skv, device=x.device)[None, :]
        q = hint_heads(rope(q.reshape(b, s, hkv * g, dh), positions,
                            cfg.rope_theta).reshape(b, s, hkv, g, dh))
        k = hint_heads(rope(k, kv_positions, cfg.rope_theta), head_dims=(2,))
    out = _chunked_attn(q, k, v, causal=causal, q_offset=0,
                        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    out = hint(out.reshape(b, s, hq * dh).to(x.dtype), "dp", None, "model")
    return dense(p["wo"], out)


def _row_index(cur, s_max):
    """Where :func:`_write_row` stores slot b's row: (slots, ``cur[b]``
    clamped into [0, S), whether ``cur[b]`` lies in [0, S)).  Taken once
    for a layer's K and V."""
    rows = torch.arange(cur.shape[0], device=cur.device)
    inside = ((cur >= 0) & (cur < s_max))[:, None, None]
    return rows, cur.clamp(0, s_max - 1).long(), inside


def _write_row(cache, new, at):
    """``cache`` [B,S,Hkv,Dh] with row ``cur[b]`` of slot b set to
    ``new[b]`` in place (``at``: :func:`_row_index`): an indexed store of
    B rows.  A slot whose ``cur`` lies outside [0, S) writes back the row
    it reads, so the cache keeps it as the masked write keeps it; nothing
    waits for the host."""
    rows, pos, inside = at
    cache[rows, pos] = torch.where(inside, new.to(cache.dtype),
                                   cache[rows, pos])
    return cache


def attention_decode(p, cfg, x, cache_k, cache_v, cur_len, *, donate=False):
    """One-token decode against a KV cache.

    x [B,1,D]; cache_k/v [B,S,Hkv,Dh]; cur_len: an int or a ``[B]`` tensor
    of per-slot counts of tokens already cached (continuous batching).  The
    new K/V is written at each slot's ``cur_len`` by ``torch.where`` on a
    slot mask, and the scores are masked past it: no index depends on the
    data and nothing waits for the host.  With ``donate`` the new rows are
    stored into ``cache_k``/``cache_v`` themselves (:func:`_write_row`), B
    rows each, where the masked write makes a new full-size tensor; the
    values are the same.  The copying step keeps the masked write: a
    clone and the indexed store are more, smaller launches a layer, and
    made a host-bound decode step at the engine's shape (qwen2-0.5b, 4
    slots of 256) 16 % slower on an H100.
    Returns (out [B,1,D], new_k, new_v).
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    cur = torch.broadcast_to(
        torch.as_tensor(cur_len, dtype=torch.int32, device=x.device), (b,))
    q = dense(p["wq"], x).reshape(b, 1, hkv, g, dh)
    k = dense(p["wk"], x).reshape(b, 1, hkv, dh)
    v = dense(p["wv"], x).reshape(b, 1, hkv, dh)
    pos = cur[:, None]
    q = rope(q.reshape(b, 1, hkv * g, dh), pos,
             cfg.rope_theta).reshape(b, 1, hkv, g, dh)
    k = rope(k, pos, cfg.rope_theta)
    # per-slot write of the new KV at position cur_len[b]
    steps = torch.arange(s_max, device=x.device)[None, :]
    if donate:
        at = _row_index(cur, s_max)
        cache_k = _write_row(cache_k, k[:, 0], at)
        cache_v = _write_row(cache_v, v[:, 0], at)
    else:
        slot = (steps == cur[:, None])[..., None, None]
        cache_k = torch.where(slot, k.to(cache_k.dtype), cache_k)
        cache_v = torch.where(slot, v.to(cache_v.dtype), cache_v)
    s = _einsum("bqhgd,bkhd->bhgqk", q * dh ** -0.5,
                cache_k.to(q.dtype))
    mask = (steps <= cur[:, None])[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = _einsum("bhgqk,bkhd->bqhgd", w.to(cache_v.dtype), cache_v)
    out = out.reshape(b, 1, hq * dh).to(x.dtype)
    return dense(p["wo"], out), cache_k, cache_v


def cross_attention_cached(p, cfg, x, mem_k, mem_v):
    """Cross-attention of one token against the memory's precomputed K/V
    (decode path): x [B,1,D]; mem_k/v [B,N,Hkv,Dh], every position visible,
    no rotary positions."""
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = hq // hkv
    q = dense(p["wq"], x).reshape(b, 1, hkv, g, dh)
    s = _einsum("bqhgd,bkhd->bhgqk", q * dh ** -0.5, mem_k.to(q.dtype))
    w = torch.softmax(s, dim=-1)
    out = _einsum("bhgqk,bkhd->bqhgd", w.to(mem_v.dtype), mem_v)
    return dense(p["wo"], out.reshape(b, 1, hq * dh).to(x.dtype))


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# embedding + chunked LM loss
# ---------------------------------------------------------------------------


def embed_table(cfg):
    return {"embedding": pp.Leaf((cfg.vocab_padded, cfg.d_model),
                                 ("vocab", "embed"), "normal:0.02")}


class _Embed(torch.autograd.Function):
    """Row gather whose backward adds each row's gradients in a fixed
    order: the tokens' gradients sorted (stably) by token id and summed
    segment by segment, a ``[V]`` count of each id's tokens as the segment
    lengths.  Indexing's own backward (``index_put_`` with accumulate) adds
    them with atomics, in an order that changes from run to run, on the
    card and on a multi-threaded CPU alike.  Every size is static: no host
    sync."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.n_rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        ids = tokens.reshape(-1).long()
        g = g.reshape(ids.shape[0], -1)
        order = torch.argsort(ids, stable=True)
        counts = torch.zeros(ctx.n_rows, dtype=torch.long,
                             device=ids.device).scatter_add_(
            0, ids, torch.ones_like(ids))
        grad = torch.segment_reduce(g[order], "sum", lengths=counts, axis=0,
                                    unsafe=True)
        return grad, None


def embed(p, tokens):
    return _Embed.apply(p["embedding"], tokens)


def unembed_table(cfg):
    return pp.linear(cfg.d_model, cfg.vocab_padded, "embed", "vocab")


def _loss_chunk(p_unembed, cfg, hc, lc):
    """(sum of the chunk's token losses, its count of valid labels)."""
    logits = lm_logits(p_unembed, cfg, hc)
    lc = lc.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
    valid = (lc >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def lm_loss(p_unembed, cfg, h, labels):
    """Mean next-token cross-entropy; seq-chunked so [B,S,Vpad] never exists.

    h [B,S,D] (already final-normed); labels [B,S] int (-1 = ignore).  Each
    chunk's logits are recomputed in the backward (:func:`remat`), as the
    reference's ``jax.checkpoint`` does, so no more than one chunk's
    ``[B, c, Vpad]`` logits exist at a time in either pass.
    """
    b, s, _ = h.shape
    c = min(cfg.logits_chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"logits chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        t, n = remat(_loss_chunk, p_unembed, cfg, h[:, i:i + c],
                     labels[:, i:i + c])
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_logits(p_unembed, cfg, h):
    """f32 logits of ``h``, the padded vocabulary masked to ``NEG_INF``
    (serve path; callers keep S tiny, and ``lm_loss`` calls it a chunk at a
    time)."""
    check_full_f32(h)
    logits = (h @ p_unembed["w"].to(h.dtype)).float()
    if cfg.vocab_padded > cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab
        logits = torch.where(pad, NEG_INF, logits)
    return logits
