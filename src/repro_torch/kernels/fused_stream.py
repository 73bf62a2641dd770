"""K1: the fused product-stream replay (``csrc/fused_stream.cu``).

The counterpart of the JAX package's Pallas fused stream kernel
(``repro/core/pallas_stream.py::_fused_call``): for every output slot s,
``out[s] = sum_{q in [seg_ptr[s], seg_ptr[s+1])} x[idx_x[q]] * y[idx_y[q]]``.
One kernel serves the forward replay of a plan's product stream and both
gradient replays (``core.fused_stream``).  On a CUDA tensor
:func:`fused_stream` launches the hand-written kernel (one thread per output
slot) or raises; on a CPU tensor it runs :func:`fused_stream_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_tensors, stream_handle


def _check(idx_x, idx_y, seg_ptr, x, y, device) -> torch.device:
    named = dict(idx_x=idx_x, idx_y=idx_y, seg_ptr=seg_ptr, x=x, y=y)
    dev = check_tensors(named, lambda name: name in ("x", "y"), device)
    for name, t in named.items():
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
    if idx_x.shape != idx_y.shape:
        raise ValueError(f"idx_x {tuple(idx_x.shape)} and idx_y "
                         f"{tuple(idx_y.shape)} differ in length")
    if seg_ptr.shape[0] < 1:
        raise ValueError("seg_ptr needs n_out + 1 >= 1 offsets")
    return dev


def fused_stream(idx_x, idx_y, seg_ptr, x, y, *, device=None) -> torch.Tensor:
    """Segment sums ``out [n_out]`` f32 of the products ``x[idx_x] *
    y[idx_y]``, segment s spanning ``[seg_ptr[s], seg_ptr[s+1])``.

    ``idx_*`` are int32 ``[P]``, ``seg_ptr`` int32 ``[n_out + 1]`` and
    non-decreasing from 0 to at most P, ``x``/``y`` f32 value vectors that
    every index lies within (the plan's views are in bounds by
    construction; the card does not check).  With no products or no
    segments the result is zeros and nothing is launched.  ``device``, when
    given, is where the operands must lie.
    """
    dev = _check(idx_x, idx_y, seg_ptr, x, y, device)
    if dev.type == "cpu":
        return fused_stream_plain(idx_x, idx_y, seg_ptr, x, y)
    n_out = seg_ptr.shape[0] - 1
    out = torch.zeros(n_out, dtype=torch.float32, device=dev)
    if n_out == 0 or idx_x.shape[0] == 0:
        return out
    _build.launch(
        "repro_fused_stream_launch", idx_x.data_ptr(), idx_y.data_ptr(),
        seg_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), n_out,
        out.data_ptr(), stream_handle(dev))
    fused_stream.n_launches += 1
    return out


fused_stream.n_launches = 0


def fused_stream_plain(idx_x, idx_y, seg_ptr, x, y) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the kernel's per-slot order.

    Step k adds the k-th product of every segment longer than k, vectorized
    over those segments, so each slot sums its products in stream order
    starting from 0, exactly as the kernel's thread does.  Segments are
    visited longest first, so the live ones at step k are a prefix.
    """
    dev = x.device
    n_out = seg_ptr.shape[0] - 1
    out = torch.zeros(n_out, dtype=torch.float32, device=dev)
    if n_out == 0 or idx_x.shape[0] == 0:
        return out
    starts = seg_ptr[:-1].long()
    lens = seg_ptr[1:].long() - starts
    lens_sorted, order = torch.sort(lens, descending=True, stable=True)
    # live[k] = number of segments longer than k (one host read)
    counts = lens_sorted.cpu()
    max_len = int(counts[0])
    live = torch.searchsorted(-counts, -torch.arange(max_len),
                              right=False).tolist()
    for k in range(max_len):
        seg = order[: live[k]]
        q = starts[seg] + k
        out[seg] = out[seg] + x[idx_x[q].long()] * y[idx_y[q].long()]
    return out
