"""Mamba1 (selective scan) and Mamba2 (scalar-decay SSD) blocks.

The port of the JAX package's ``repro/models/ssm.py``.  Training and
prefill cut the sequence into ``cfg.ssm.chunk``-length chunks; within a
chunk the linear recurrence runs as an associative scan in the order of
``jax.lax.associative_scan`` (:func:`_associative_scan`), and across
chunks a Python loop carries the state.  The state-expanded tensors
``[B, c, ..., d_state]`` exist for one chunk at a time.

Decode is the exact single-step recurrence with (conv window, SSM state)
carried in the serve cache.

As in the reference, Mamba2's short conv acts on x only (not on B/C).
Softplus is ``logaddexp(x, 0)``, the reference's definition
(``torch.nn.functional.softplus`` switches to x above its threshold).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import params as pp
from repro_torch.models.layers import _einsum, dense, rms_norm


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def mamba_table(cfg):
    s = cfg.ssm
    d, din, ds = cfg.d_model, cfg.d_inner, s.d_state
    if s.version == 1:
        dtr = cfg.dt_rank_actual
        return {
            "in_proj": pp.linear(d, 2 * din, "embed", "ssm_inner"),
            "conv_w": pp.Leaf((s.d_conv, din), (None, "ssm_inner"),
                              "normal:0.1"),
            "conv_b": pp.Leaf((din,), ("ssm_inner",), "zeros"),
            "x_proj": pp.linear(din, dtr + 2 * ds, "ssm_inner", None),
            "dt_proj": pp.linear(dtr, din, None, "ssm_inner",
                                 init="normal:0.01"),
            "dt_bias": pp.Leaf((din,), ("ssm_inner",), "dt_bias"),
            "a_log": pp.Leaf((din, ds), ("ssm_inner", None), "ssm_a"),
            "d_skip": pp.Leaf((din,), ("ssm_inner",), "ones"),
            "out_proj": pp.linear(din, d, "ssm_inner", "embed"),
        }
    nh = din // s.head_dim
    return {
        "in_proj": pp.linear(d, 2 * din + 2 * ds + nh, "embed", "ssm_inner"),
        "conv_w": pp.Leaf((s.d_conv, din), (None, "ssm_inner"), "normal:0.1"),
        "conv_b": pp.Leaf((din,), ("ssm_inner",), "zeros"),
        "dt_bias": pp.Leaf((nh,), (None,), "dt_bias"),
        "a_log": pp.Leaf((nh,), (None,), "ssm_a"),
        "d_skip": pp.Leaf((nh,), (None,), "ones"),
        "norm": pp.Leaf((din,), ("ssm_inner",), "ones"),
        "out_proj": pp.linear(din, d, "ssm_inner", "embed"),
    }


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b, window=None):
    """Depthwise causal conv. x [B,S,C], w [K,C]. window: [B,K-1,C] history
    for decode continuity (None = zero history); a window of another dtype
    is promoted with x, as ``jnp.concatenate`` promotes it."""
    k = w.shape[0]
    if window is None:
        window = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([window, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :]
              for i in range(k))
    return out + b[None, None, :]


def _combine(x, y):
    """The scan's operator on (a, u) pairs: x then y."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1 (even has as many
    elements as odd, or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], n) + even.shape[2:], dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a, u):
    """Inclusive scan of (a, u) under :func:`_combine` along axis 1, in the
    order of ``jax.lax.associative_scan``: adjacent pairs combined, the
    half-length result scanned by recursion (the odd positions), each even
    position then the odd one before it combined with its own element."""
    n = a.shape[1]
    if n < 2:
        return a, u
    reduced = _combine((a[:, 0:n - 1:2], u[:, 0:n - 1:2]),
                       (a[:, 1::2], u[:, 1::2]))
    odd_a, odd_u = _associative_scan(*reduced)
    if n % 2 == 0:
        prev = (odd_a[:, :-1], odd_u[:, :-1])
    else:
        prev = (odd_a, odd_u)
    even_a, even_u = _combine(prev, (a[:, 2::2], u[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_u = torch.cat([u[:, :1], even_u], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_u, odd_u)


def _scan_chunks(a, u, h0):
    """h_t = a_t * h_{t-1} + u_t over time axis 1, associative scan.

    a, u: [B, c, ...] (same shape); h0 [B, ...]. Returns (h_all [B,c,...],
    h_last).
    """
    a_cum, u_cum = _associative_scan(a, u)
    h_all = a_cum * h0[:, None] + u_cum
    return h_all, h_all[:, -1]


def _chunked_ssm_apply(build_fn, inputs, h0, chunk, seq_len):
    """Chunked linear recurrence without materialising [B,S,...,d_state].

    ``inputs``: a tuple of [B, S, ...] per-timestep tensors.  Per chunk,
    ``build_fn(chunk_inputs)`` -> (a [B,c,...,state], u [B,c,...,state],
    y_fn(h_all) -> y_chunk); the associative scan runs on (a, u) from the
    carried state, and only the chunk's output is kept, so the
    state-expanded tensors exist for one chunk at a time.  The reference
    runs the chunks under ``lax.scan`` with ``jax.checkpoint``, which
    changes what a backward recomputes and no value of the forward pass;
    here they are a Python loop.  Returns ([B, S, ...out], h_last).
    """
    c = min(chunk, seq_len)
    if seq_len % c:
        raise ValueError(f"sequence length {seq_len} is not a multiple of "
                         f"the scan chunk {c}")
    h, ys = h0, []
    for i in range(0, seq_len, c):
        a, u, y_fn = build_fn(tuple(x[:, i:i + c] for x in inputs))
        h_all, h = _scan_chunks(a, u, h)
        ys.append(y_fn(h_all))
    return torch.cat(ys, dim=1), h


def _new_window(conv_win, xin, d_conv):
    """The conv history after ``xin``: its last ``d_conv - 1`` steps."""
    b, _, din = xin.shape
    if conv_win is None:
        conv_win = torch.zeros((b, d_conv - 1, din), dtype=xin.dtype,
                               device=xin.device)
    return torch.cat([conv_win, xin], dim=1)[:, -(d_conv - 1):]


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def mamba1_forward(p, cfg, x, state=None):
    """x [B,S,D] -> (y [B,S,D], new_state). state = (conv_win, h)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    din, ds = cfg.d_inner, s_cfg.d_state
    dtr = cfg.dt_rank_actual
    conv_win, h0 = state if state is not None else (None, None)

    xz = dense(p["in_proj"], x)
    xin, z = torch.split(xz, din, dim=-1)
    xc = _causal_conv(xin, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                      conv_win)
    new_conv_win = _new_window(conv_win, xin, s_cfg.d_conv)
    xc = F.silu(xc)

    proj = dense(p["x_proj"], xc)
    dt_raw, bmat, cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = _softplus(dense(p["dt_proj"], dt_raw)
                   + p["dt_bias"][None, None, :]).float()
    a = -torch.exp(p["a_log"].float())                      # [din, ds]
    if h0 is None:
        h0 = torch.zeros((b, din, ds), dtype=torch.float32, device=x.device)

    def build(ch):
        dt_c, xc_c, b_c, c_c = ch                           # [B,c,...]
        decay = torch.exp(dt_c[..., None] * a[None, None])  # [B,c,din,ds]
        drive = (dt_c * xc_c.float())[..., None] \
            * b_c.float()[:, :, None, :]

        def y_fn(h_all):
            return _einsum("bsdn,bsn->bsd", h_all, c_c.float())

        return decay, drive, y_fn

    y, h_last = _chunked_ssm_apply(
        build, (dt, xc, bmat, cmat), h0, s_cfg.chunk, s)
    y = y + xc.float() * p["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    return dense(p["out_proj"], y), (new_conv_win, h_last)


# ---------------------------------------------------------------------------
# Mamba2 (scalar decay per head)
# ---------------------------------------------------------------------------


def mamba2_forward(p, cfg, x, state=None):
    """x [B,S,D] -> (y [B,S,D], new_state). state = (conv_win, h)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    din, ds, hd = cfg.d_inner, s_cfg.d_state, s_cfg.head_dim
    nh = din // hd
    conv_win, h0 = state if state is not None else (None, None)

    zxbcdt = dense(p["in_proj"], x)
    z, xin, bmat, cmat, dt_raw = torch.split(
        zxbcdt, [din, din, ds, ds, nh], dim=-1)
    xc = _causal_conv(xin, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                      conv_win)
    new_conv_win = _new_window(conv_win, xin, s_cfg.d_conv)
    xc = F.silu(xc)

    dt = _softplus(dt_raw.float() + p["dt_bias"][None, None, :])  # [B,S,nh]
    a = -torch.exp(p["a_log"].float())                        # [nh]
    xh = xc.reshape(b, s, nh, hd).float()
    if h0 is None:
        h0 = torch.zeros((b, nh, hd, ds), dtype=torch.float32,
                         device=x.device)

    def build(ch):
        dt_c, xh_c, b_c, c_c = ch
        decay = torch.exp(dt_c * a[None, None])[..., None, None]
        drive = (dt_c[..., None] * xh_c)[..., None] \
            * b_c.float()[:, :, None, None, :]              # [B,c,nh,hd,ds]

        def y_fn(h_all):
            return _einsum("bshdn,bsn->bshd", h_all, c_c.float())

        return decay.expand(drive.shape), drive, y_fn

    y, h_last = _chunked_ssm_apply(
        build, (dt, xh, bmat, cmat), h0, s_cfg.chunk, s)
    y = y + xh * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype) * F.silu(z)
    y = rms_norm({"scale": p["norm"]}, y, cfg.norm_eps)
    return dense(p["out_proj"], y), (new_conv_win, h_last)


def mamba_forward(p, cfg, x, state=None):
    fn = mamba1_forward if cfg.ssm.version == 1 else mamba2_forward
    return fn(p, cfg, x, state)


def mamba_init_state(cfg, batch: int, dtype=torch.float32, device=None):
    """Zero (conv window, SSM state) on ``device`` (default the card); the
    window in ``dtype``, the state in f32, as in the reference."""
    dev = resolve_device(device)
    s = cfg.ssm
    din = cfg.d_inner
    conv = torch.zeros((batch, s.d_conv - 1, din), dtype=dtype, device=dev)
    if s.version == 1:
        h = torch.zeros((batch, din, s.d_state), dtype=torch.float32,
                        device=dev)
    else:
        h = torch.zeros((batch, din // s.head_dim, s.head_dim, s.d_state),
                        dtype=torch.float32, device=dev)
    return conv, h
