"""Operand checks shared by the kernel wrappers.

K2-K4 take the padded-column operands of the JAX package's kernels
(``rows`` int32 / ``vals`` f32 ``[n, Z]``, ``nnz`` int32 ``[n]`` for A and for
one B group), K1 index and value vectors.  A wrapper raises on anything its
kernel does not take: another dtype, shape or device, or a non-contiguous
tensor.
"""

from __future__ import annotations

import torch


def check_tensors(named: dict, is_value, device=None) -> torch.device:
    """Check that every tensor of ``named`` is a contiguous torch.Tensor,
    f32 where ``is_value(name)`` and int32 elsewhere, all on one CPU or
    CUDA device (``device`` when given); return that device."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        want = torch.float32 if is_value(name) else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = devices.pop()
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(
                f"operands lie on {dev}, but device={device!r} was asked for")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, *extra,
                   block_cols: int, device=None) -> torch.device:
    """Validate one launch's operands; return the device they all lie on.

    ``extra`` holds further int32 index tensors (the per-block ``steps``).
    ``device``, when given, is where the caller requires them to lie: a
    tensor elsewhere raises rather than running anywhere else.
    """
    named = dict(a_rows=a_rows, a_vals=a_vals, a_nnz=a_nnz, b_rows=b_rows,
                 b_vals=b_vals, b_nnz=b_nnz)
    named.update({f"extra{i}": t for i, t in enumerate(extra)})
    dev = check_tensors(named, lambda name: name.endswith("vals"), device)
    if a_rows.dim() != 2 or a_vals.shape != a_rows.shape \
            or a_nnz.shape != a_rows.shape[:1]:
        raise ValueError(
            f"A operand shapes {tuple(a_rows.shape)}, {tuple(a_vals.shape)}, "
            f"{tuple(a_nnz.shape)} are not [n_a, za], [n_a, za], [n_a]")
    if b_rows.dim() != 2 or b_vals.shape != b_rows.shape \
            or b_nnz.shape != b_rows.shape[:1]:
        raise ValueError(
            f"B operand shapes {tuple(b_rows.shape)}, {tuple(b_vals.shape)}, "
            f"{tuple(b_nnz.shape)} are not [n_b, zb], [n_b, zb], [n_b]")
    if block_cols < 1 or b_rows.shape[0] % block_cols:
        raise ValueError(
            f"n_b={b_rows.shape[0]} is not a multiple of block_cols="
            f"{block_cols}")
    return dev


def check_steps(steps: torch.Tensor, n_b: int, block_cols: int) -> None:
    if steps.shape != (n_b // block_cols,):
        raise ValueError(
            f"steps has shape {tuple(steps.shape)}, expected "
            f"({n_b // block_cols},) — one trip count per lane block")


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
