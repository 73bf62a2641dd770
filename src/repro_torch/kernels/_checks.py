"""Operand checks shared by the kernel wrappers.

K2-K4 take the padded-column operands of the JAX package's kernels
(``rows`` int32 / ``vals`` f32 ``[n, Z]``, ``nnz`` int32 ``[n]`` for A and for
one B group), K1 index and value vectors; the batched wrappers take a
leading batch axis on the values only.  A wrapper raises on anything its
kernel does not take: another dtype, shape or device, or a non-contiguous
tensor.
"""

from __future__ import annotations

import torch


def check_tensors(named: dict, is_value, device=None,
                  value_dtypes=(torch.float32,)) -> torch.device:
    """Check that every tensor of ``named`` is a contiguous torch.Tensor,
    of one of ``value_dtypes`` where ``is_value(name)`` (f32 unless the
    wrapper's kernel takes more) and int32 elsewhere, all on one CPU or
    CUDA device (``device`` when given); return that device."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        want = value_dtypes if is_value(name) else (torch.int32,)
        if t.dtype not in want:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(map(str, want))}, got {t.dtype}")
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


#: the most value sets one launch takes: the batch is a grid axis of K1-b
#: … K4-b (y, at most 65535; K5-b puts it in its grid's one axis and keeps
#: the same limit); the executors and ``SparseMatmul.batched`` split a larger
#: batch (:func:`batch_chunks`)
MAX_BATCH = 65535


def batch_chunks(*stacks) -> list:
    """The value stacks cut along their leading batch axis into parts of at
    most ``MAX_BATCH`` value sets: a list of aligned tuples, one a launch."""
    return list(zip(*(torch.split(s, MAX_BATCH) for s in stacks)))


def check_batch(batch: int) -> None:
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a batch of {batch} value sets: one launch takes "
                         f"1 to {MAX_BATCH} (the grid's second axis)")


def check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, *extra,
                   block_cols: int, device=None,
                   batched: bool = False) -> torch.device:
    """Validate one launch's operands; return the device they all lie on.

    ``extra`` holds further int32 index tensors (the per-block ``steps``).
    ``device``, when given, is where the caller requires them to lie: a
    tensor elsewhere raises rather than running anywhere else.  ``batched``
    operands carry a leading batch axis on the values (``a_vals [B, n_a,
    za]``, ``b_vals [B, n_b, zb]``); the index operands are shared.
    """
    named = dict(a_rows=a_rows, a_vals=a_vals, a_nnz=a_nnz, b_rows=b_rows,
                 b_vals=b_vals, b_nnz=b_nnz)
    named.update({f"extra{i}": t for i, t in enumerate(extra)})
    dev = check_tensors(named, lambda name: name.endswith("vals"), device)
    lead: tuple = ()
    if batched:
        if a_vals.dim() != 3 or b_vals.dim() != 3 \
                or a_vals.shape[0] != b_vals.shape[0]:
            raise ValueError(
                f"batched value operands {tuple(a_vals.shape)}, "
                f"{tuple(b_vals.shape)} are not [B, n_a, za], [B, n_b, zb]")
        check_batch(a_vals.shape[0])
        lead = (a_vals.shape[0],)
    for x, rows, vals, nnz in (("a", a_rows, a_vals, a_nnz),
                               ("b", b_rows, b_vals, b_nnz)):
        if rows.dim() != 2 or tuple(vals.shape) != lead + tuple(rows.shape) \
                or nnz.shape != rows.shape[:1]:
            dims = f"n_{x}, z{x}"
            raise ValueError(
                f"{x.upper()} operand shapes {tuple(rows.shape)}, "
                f"{tuple(vals.shape)}, {tuple(nnz.shape)} are not [{dims}], "
                f"[{'B, ' * batched}{dims}], [n_{x}]")
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
