"""SparseFFN: pruned-weight FFN served through the paper's hybrid policy.

The port of the JAX package's ``repro/models/sparse_ffn.py`` serving paths.
The switching statistic is block-level density instead of per-column Op_j,
and the execution regimes are
  * dense path — a plain f32 matmul (the SPA analogue: dense accumulator,
    throughput-optimal when most blocks are present), chosen when the kept-
    block fraction >= ``t_density``;
  * bsr path — the BSR kernel K5 (``kernels/bsr_spmm.py``, one launch per
    matrix, K5-b for a batch), which skips absent blocks entirely (the
    SPARS/HASH analogue), chosen for sparser weights.

``from_dense`` prunes by block magnitude to a target density on the host
(numpy, as every plan-time step of the port), decides the path once, and
lifts the result to the card.  The reference's third path, ``"spgemm"``
(trainable values through the XLA device stream), and the serving
integration around it (``from_shared_pattern``, ``apply*``,
``sparsify_ffn_params``) wait for the slice that ports the device stream
and the model stack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._checks import batch_chunks
from repro_torch.kernels.bsr_spmm import bsr_from_dense, bsr_spmm, \
    bsr_spmm_batched

SPGEMM_LATER = (
    "path='spgemm' runs the SpGEMM plan's XLA device stream, which the port "
    "does not have yet (the slice after the sparse FFN's serving paths: "
    "the device stream and the model stack); use None, 'dense' or 'bsr'")


def prune_blocks(w, bm: int, bk: int, keep_density: float):
    """Keep the ``keep_density`` fraction of ``bm x bk`` blocks of ``w``
    with the largest max-magnitude (ties at the threshold all kept), zero
    the rest; returns ``(w_pruned f32 [M, K], kept-block fraction)``.
    Host numpy, the reference's own pruning."""
    w = np.asarray(w, np.float32)
    m, k = w.shape
    if m % bm or k % bk:
        raise ValueError(f"a {w.shape} weight does not split into {bm}x{bk} "
                         "blocks")
    n_rb, n_cb = m // bm, k // bk
    tiles = w.reshape(n_rb, bm, n_cb, bk).transpose(0, 2, 1, 3)
    norms = np.abs(tiles).max(axis=(2, 3))
    n_keep = max(1, int(round(keep_density * n_rb * n_cb)))
    thresh = np.partition(norms.reshape(-1), -n_keep)[-n_keep]
    kept = norms >= thresh
    pruned = np.where(kept[:, :, None, None], tiles, np.float32(0.0))
    return pruned.transpose(0, 2, 1, 3).reshape(m, k), float(kept.mean())


def _dense_matmul(w, x):
    """The dense path's matmul, in full f32: TF32 would keep about three
    decimal digits, so a caller that switched it on is refused."""
    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the dense path computes in full f32, but float32 matmul "
            f"precision is {torch.get_float32_matmul_precision()!r} (TF32); "
            "set torch.set_float32_matmul_precision('highest')")
    return w @ x


@dataclasses.dataclass
class SparseMatmul:
    """One pruned weight matrix (``W @ x`` orientation, ``[M, K]``) with its
    chosen execution path; its tensors lie on one device."""

    path: str                   # "dense" | "bsr"
    dense_w: torch.Tensor | None
    block_idx: torch.Tensor | None
    block_nnz: torch.Tensor | None
    blocks: torch.Tensor | None
    shape: tuple
    density: float

    @classmethod
    def from_dense(cls, w, *, bm=8, bk=8, keep_density=0.5,
                   t_density=0.75, path: str | None = None,
                   device=None) -> "SparseMatmul":
        """Prune ``w`` (host array ``[M, K]``) by block magnitude and pick an
        execution path.

        ``path=None`` applies the serving policy (dense above ``t_density``,
        BSR below); ``"dense"`` / ``"bsr"`` force a path.  The result lies
        on ``device`` (default the card).
        """
        if path == "spgemm":
            raise ValueError(SPGEMM_LATER)
        if path not in (None, "dense", "bsr"):
            raise ValueError(
                f"unknown path {path!r}; None, 'dense' or 'bsr'")
        dev = resolve_device(device)
        w_pruned, density = prune_blocks(w, bm, bk, keep_density)
        shape = w_pruned.shape
        if path == "dense" or (path is None and density >= t_density):
            # paper's hybrid switch: stay dense (SPA)
            return cls("dense", torch.from_numpy(w_pruned).to(dev), None,
                       None, None, shape, density)
        bi, bn, blocks = bsr_from_dense(w_pruned, bm, bk)
        bi, bn, blocks = (torch.from_numpy(a).to(dev)
                          for a in (bi, bn, blocks))
        return cls("bsr", None, bi, bn, blocks, shape, density)

    def __call__(self, x, *, bn=None):
        """y [M, N] = W @ x for x [K, N] f32 (one K5 launch on the bsr
        path, whose N must be a multiple of ``bn``, default min(128, N))."""
        if self.path == "dense":
            return _dense_matmul(self.dense_w, x)
        n = x.shape[1]
        return bsr_spmm(self.block_idx, self.block_nnz, self.blocks, x,
                        bn=bn or min(128, n))

    def batched(self, xs, *, bn=None):
        """y [B, M, N] = W @ xs[b] for xs [B, K, N] — one launch for all B.

        The weight pattern is static (pruned at conversion time), so a batch
        of activations is the same-pattern regime of batched SpGEMM: the BSR
        structure is shared and only the activations carry the batch axis,
        one K5-b launch instead of B (past ``MAX_BATCH`` activations, one
        launch for each ``MAX_BATCH``).
        """
        if self.path == "dense":
            return _dense_matmul(self.dense_w, xs)   # broadcasts over B
        n = xs.shape[2]
        parts = [bsr_spmm_batched(self.block_idx, self.block_nnz,
                                  self.blocks, x, bn=bn or min(128, n))
                 for x, in batch_chunks(xs)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    @property
    def flops_per_col(self) -> int:
        m, k = self.shape
        if self.path == "dense":
            return 2 * m * k
        nb = int(self.block_nnz.sum())
        bm, bk = self.blocks.shape[2], self.blocks.shape[3]
        return 2 * nb * bm * bk


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


@dataclasses.dataclass
class SparseFFN:
    """SwiGLU FFN with pruned gate/up/down matrices."""

    gate: SparseMatmul
    up: SparseMatmul
    down: SparseMatmul

    @classmethod
    def from_params(cls, p, *, keep_density=0.4, t_density=0.75, bm=8, bk=8,
                    path: str | None = None, device=None):
        """Convert FFN params ``{"gate"/"up"/"down": {"w": [d_in, d_out]}}``
        (torch tensors or numpy arrays, ``ffn_table``'s orientation): each
        matrix is pruned and placed on its path by
        :meth:`SparseMatmul.from_dense`, on ``device`` (default the card)."""

        def mk(w):
            return SparseMatmul.from_dense(
                _host(w).T, bm=bm, bk=bk, keep_density=keep_density,
                t_density=t_density, path=path, device=device)

        return cls(mk(p["gate"]["w"]), mk(p["up"]["w"]), mk(p["down"]["w"]))

    def __call__(self, x):
        """x [T, D] -> [T, D], or a batch [B, T, D] -> [B, T, D].

        A 3-D input runs the batched path: one launch per matrix for the
        whole batch (K5-b on the bsr path), replacing the caller-side
        per-sequence loop.  The result is a transposed view.
        """
        silu = torch.nn.functional.silu
        if x.dim() == 3:
            xt = x.transpose(1, 2).contiguous()        # [B, D, T]
            h = silu(self.gate.batched(xt)) * self.up.batched(xt)
            return self.down.batched(h).transpose(1, 2)
        xt = x.T.contiguous()                          # [D, T]
        h = silu(self.gate(xt)) * self.up(xt)
        return self.down(h).T

    @property
    def flops_per_token(self) -> int:
        return (self.gate.flops_per_col + self.up.flops_per_col
                + self.down.flops_per_col)
