"""SparseFFN: pruned-weight FFN served through the paper's hybrid policy.

The port of the JAX package's ``repro/models/sparse_ffn.py``.  The
switching statistic is block-level density instead of per-column Op_j, and
the execution regimes are
  * dense path — a plain f32 matmul (the SPA analogue: dense accumulator,
    throughput-optimal when most blocks are present), chosen when the kept-
    block fraction >= ``t_density``;
  * bsr path — the BSR kernel K5 (``kernels/bsr_spmm.py``, one launch per
    matrix, K5-b for a batch), which skips absent blocks entirely (the
    SPARS/HASH analogue), chosen for sparser weights;
  * spgemm path — the differentiable one (``path="spgemm"``): the pruned
    weight is an element-level CSC whose values are trainable (host numpy
    structure, values on the device), activations ride as the value array
    of a dense-pattern CSC, and the multiply is the product stream of a
    cached ``backend="torch"`` SpGEMM plan (``plan.stream_apply``,
    ``core.device_stream``), differentiable through ``torch.autograd``.
    Weight patterns are static (pruned at conversion time), so each
    distinct token count plans once and every later call replays it with no
    host sync.  ``apply_values_host`` runs the same multiply through the
    numpy host stream (the serving fallback).

``from_dense`` prunes by block magnitude to a target density on the host
(numpy, as every plan-time step of the port), decides the path once, and
lifts the result to the card.  :func:`sparsify_ffn_params` converts every
FFN sub-layer of a model to the spgemm path on one pattern shared across
its reps, and :func:`densify_ffn_params` is its dense oracle.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.api import cached_plan
from repro_torch.device import resolve_device
from repro_torch.kernels._checks import batch_chunks
from repro_torch.kernels.bsr_spmm import bsr_from_dense, bsr_spmm, \
    bsr_spmm_batched
from repro_torch.models.layers import check_full_f32
from repro_torch.sparse.format import CSC, csc_from_dense


def prune_blocks(w, bm: int, bk: int, keep_density: float):
    """Keep the ``keep_density`` fraction of ``bm x bk`` blocks of ``w``
    with the largest max-magnitude (ties at the threshold all kept), zero
    the rest; returns ``(w_pruned f32 [M, K], kept-block fraction)``.
    Host numpy, the reference's own pruning; ``w`` is an array or a tensor
    (a bf16 one widened to f32, as the reference widens its weight)."""
    w = np.asarray(_host(w), np.float32)
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
    """The dense path's matmul, in full f32 (TF32 is refused).  A bf16 x is
    widened (exact), so the result is f32, as the reference's f32 weight
    times a bf16 x gives."""
    x = x.to(w.dtype)
    check_full_f32(x)
    return w @ x


def _host(w) -> np.ndarray:
    """``w`` as a host numpy array; a bf16 tensor widened to f32 (exact:
    numpy has no bf16, and the reference's pruning widens to f32 too)."""
    if isinstance(w, torch.Tensor):
        w = w.detach()
        return (w.float() if w.dtype == torch.bfloat16 else w).cpu().numpy()
    return np.asarray(w)


def _dense_pattern(k: int, n: int) -> CSC:
    """The fully dense ``[k, n]`` activation pattern, structure only: its
    row indices ``tile(arange(k), n)`` stay int32 host numpy."""
    return CSC(torch.zeros(0), np.tile(np.arange(k, dtype=np.int32), n),
               np.arange(n + 1, dtype=np.int32) * k, (k, n))


def _column_major(x: torch.Tensor) -> torch.Tensor:
    """Dense activations ``[K, N]`` (or ``[B, K, N]``) as the value array
    (or ``[B, K·N]`` stack) of the dense ``[K, N]`` CSC: column-major."""
    return x.transpose(-1, -2).reshape(x.shape[:-2] + (-1,))


@dataclasses.dataclass
class SparseMatmul:
    """One pruned weight matrix (``W @ x`` orientation, ``[M, K]``) with its
    chosen execution path; its tensors lie on one device."""

    path: str                   # "dense" | "bsr" | "spgemm"
    dense_w: torch.Tensor | None
    block_idx: torch.Tensor | None
    block_nnz: torch.Tensor | None
    blocks: torch.Tensor | None
    shape: tuple
    density: float
    w_csc: CSC | None = None    # spgemm path: host pattern, device values
    #: spgemm path: this matrix's plan-memory guard (products); a large FFN
    #: times a long token block exceeds the global default, and changing
    #: fast.STREAM_MAX_PRODUCTS would re-key every cached plan
    stream_limit: int | None = None
    # spgemm path: per-token-count plan + scatter indices, resolved once.
    # A bounded LRU: each entry pins a plan (host and device stream,
    # O(nnz_w * N)) past plan-LRU eviction, so callers cycling through many
    # token counts must not accumulate them
    _spgemm_memo: OrderedDict = dataclasses.field(
        default_factory=OrderedDict, repr=False)
    # the memo is shared by a background warm (torch plans) and serving
    # ticks (host plans)
    _memo_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    SPGEMM_MEMO_SIZE = 8        # distinct token counts held per matrix

    @classmethod
    def from_dense(cls, w, *, bm=8, bk=8, keep_density=0.5,
                   t_density=0.75, path: str | None = None,
                   stream_limit: int | None = None,
                   device=None) -> "SparseMatmul":
        """Prune ``w`` (host array ``[M, K]``) by block magnitude and pick an
        execution path.

        ``path=None`` applies the serving policy (dense above ``t_density``,
        BSR below); ``"spgemm"`` forces the differentiable CSC/SpGEMM path,
        whose values are trainable; ``"dense"`` / ``"bsr"`` force the
        serving paths.  ``stream_limit`` raises this matrix's plan-memory
        guard (the spgemm path's stream holds ``nnz_w * tokens`` products)
        without touching the global knob.  The result lies on ``device``
        (default the card).
        """
        if path not in (None, "dense", "bsr", "spgemm"):
            raise ValueError(
                f"unknown path {path!r}; None, 'dense', 'bsr' or 'spgemm'")
        dev = resolve_device(device)
        w_pruned, density = prune_blocks(w, bm, bk, keep_density)
        shape = w_pruned.shape
        if path == "spgemm":
            # the nonzeros as an element CSC: host structure, device values
            return cls("spgemm", None, None, None, None, shape, density,
                       w_csc=csc_from_dense(w_pruned).to(dev),
                       stream_limit=stream_limit)
        if path == "dense" or (path is None and density >= t_density):
            # paper's hybrid switch: stay dense (SPA)
            return cls("dense", torch.from_numpy(w_pruned).to(dev), None,
                       None, None, shape, density)
        bi, bn, blocks = bsr_from_dense(w_pruned, bm, bk)
        bi, bn, blocks = (torch.from_numpy(a).to(dev)
                          for a in (bi, bn, blocks))
        return cls("bsr", None, bi, bn, blocks, shape, density)

    @classmethod
    def from_shared_pattern(cls, w_stack, *, keep_density=0.5,
                            stream_limit: int | None = None, device=None):
        """Shared-pattern spgemm matmuls for a stack of same-shape weights.

        Every rep of a super-block replays one cached plan, so the reps
        must share one CSC structure (the paper's static pre-processing,
        batched over depth).  ``w_stack`` is ``[R, m, k]`` in ``W @ x``
        orientation (a host array or a tensor); pruning keeps the element
        positions whose rep-wise max magnitude lands in the top
        ``keep_density`` fraction (ties at the threshold all kept).
        Returns ``(matmul, values)``: ``matmul`` holds rep 0's values, and
        ``values`` is the ``[R, nnz]`` trainable stack in the pattern's CSC
        (column-major) order, both on ``device`` (default the card).
        """
        dev = resolve_device(device)
        w = np.asarray(_host(w_stack), np.float32)
        if w.ndim != 3:
            raise ValueError(f"w_stack must be [R, m, k], got {w.shape}")
        _, m, k = w.shape
        mag = np.abs(w).max(axis=0)
        n_keep = max(1, int(round(keep_density * m * k)))
        thresh = np.partition(mag.reshape(-1), -n_keep)[-n_keep]
        cols, rows = np.nonzero((mag >= thresh).T)   # CSC coordinate order
        col_ptr = np.zeros(k + 1, np.int64)
        np.cumsum(np.bincount(cols, minlength=k), out=col_ptr[1:])
        values = torch.from_numpy(w[:, rows, cols]).to(dev)  # [R, nnz]
        csc = CSC(values[0], rows.astype(np.int32),
                  col_ptr.astype(np.int32), (m, k))
        mat = cls("spgemm", None, None, None, None, (m, k),
                  float(rows.size / (m * k)), w_csc=csc,
                  stream_limit=stream_limit)
        return mat, values

    # -- spgemm path ------------------------------------------------------

    def _check_spgemm(self, what: str) -> None:
        if self.path != "spgemm":
            raise ValueError(
                f"{what} needs path='spgemm' (this matmul runs "
                f"path={self.path!r})")

    @property
    def w_values(self) -> torch.Tensor:
        """Trainable weight values (spgemm path): the CSC value array."""
        self._check_spgemm("w_values")
        return self.w_csc.values

    def _spgemm_plan(self, n: int, backend: str = "torch"):
        """Plan W @ X for X dense [K, N], memoized per token count.

        The activation operand is a fully dense pattern, whose structure
        depends only on (K, N), so the symbolic phase runs once per
        distinct N.  ``backend="torch"`` plans on the values' device (the
        torch stream); ``"host"`` plans numpy on the CPU (the host stream,
        the serving fallback).  Returns ``(plan, rows, cols)``, the
        indices that densify the plan's canonical result into ``[M, N]``:
        on the torch backend one int64 tensor of flat ``row * N + col``
        positions on the plan's device, on the host numpy rows and columns.
        """
        dev = self.w_csc.values.device
        memo_key = (n, backend, str(dev))
        with self._memo_lock:
            entry = self._spgemm_memo.get(memo_key)
            if entry is not None:
                self._spgemm_memo.move_to_end(memo_key)
                return entry
        # built outside the lock, so a serving thread's host plan never
        # waits on a background warm's torch plan; the LRU builds each plan
        # once however many threads ask
        m, k = self.shape
        plan = cached_plan(self.w_csc, _dense_pattern(k, n), "expand",
                           backend=backend, stream_limit=self.stream_limit,
                           device=dev if backend == "torch" else None)
        s = plan.stream
        if s is None:
            raise ValueError(
                "spgemm-path weight stream exceeds the plan-memory guard; "
                "pass stream_limit= to from_dense/from_params/"
                "sparsify_ffn_params (per-plan override) or shrink the "
                "token block")
        rows = s.c_rows
        cols = np.repeat(np.arange(n, dtype=np.int32), np.diff(s.c_col_ptr))
        if backend == "torch":
            flat = rows.astype(np.int64) * n + cols
            entry = (plan, torch.from_numpy(flat).to(dev), None)
        else:
            entry = (plan, rows, cols)
        with self._memo_lock:
            entry = self._spgemm_memo.setdefault(memo_key, entry)
            self._spgemm_memo.move_to_end(memo_key)
            while len(self._spgemm_memo) > self.SPGEMM_MEMO_SIZE:
                self._spgemm_memo.popitem(last=False)
        return entry

    def apply_values(self, w_values, x):
        """y [M, N] = W @ x for trainable values ``w_values`` (spgemm path).

        ``x`` is ``[K, N]``, or ``[B, K, N]`` for B activations under the
        same weight values (the reference's ``vmap`` with the weights held
        fixed): one ``[B, nnz]`` stack through the plan's stream, each
        element equal to an unbatched call bit for bit (the torch stream's
        ``ALIGN``).  A bf16 ``x`` is widened to f32 (exact), so its f32
        products and the result are the reference's, whose f32 values times
        bf16 activations promote to f32.  Differentiable in ``w_values`` and
        ``x``
        (``torch.autograd``); the plan lookup keys only on ``x``'s shape.
        Column-major flattening turns the dense activations into the value
        array of the plan's dense B pattern, and the plan's canonical
        result is placed into ``[M, N]`` through plan-static indices:
        ``index_copy`` (each position written once, no atomics), no host
        sync.
        """
        self._check_spgemm("apply_values")
        if x.dtype == torch.bfloat16:
            x = x.float()
        n = int(x.shape[-1])
        plan, flat, _ = self._spgemm_plan(n)
        xv = _column_major(x)
        wv = w_values if x.dim() == 2 else w_values.expand(x.shape[0], -1)
        c_vals = plan.stream_apply(wv, xv)
        out = torch.zeros(c_vals.shape[:-1] + (self.shape[0] * n,),
                          dtype=c_vals.dtype, device=c_vals.device)
        out = out.index_copy(-1, flat, c_vals)
        return out.view(c_vals.shape[:-1] + (self.shape[0], n))

    def apply_values_host(self, w_values, x) -> np.ndarray:
        """Host-stream spelling of :meth:`apply_values` (numpy in and out).

        The serving fallback: the same multiply through the host product
        stream of a ``backend="host"`` plan on the same LRU (numpy on the
        CPU, ``engine="stream"``, the reference's host stream bit for bit),
        no device plan and no device stream.  ``x`` is ``[K, N]``; tensors
        are read back to the host.
        """
        self._check_spgemm("apply_values_host")
        x = np.asarray(_host(x), np.float32)
        n = int(x.shape[1])
        plan, rows, cols = self._spgemm_plan(n, backend="host")
        c = plan.execute(np.asarray(_host(w_values), np.float32),
                         x.T.reshape(-1), engine="stream")
        out = np.zeros((self.shape[0], n), np.float32)
        out[rows, cols] = np.asarray(_host(c.values), np.float32)
        return out

    def __call__(self, x, *, bn=None):
        """y [M, N] = W @ x for x [K, N] (one K5 launch on the bsr path,
        whose N must be a multiple of ``bn``, default min(128, N)).

        x is f32 or bf16, and the result's dtype is the reference's: x's on
        the bsr path (the kernel's contract), f32 on the dense and spgemm
        paths (the f32 weight promotes a bf16 x)."""
        if self.path == "dense":
            return _dense_matmul(self.dense_w, x)
        if self.path == "spgemm":
            return self.apply_values(self.w_values, x)
        n = x.shape[1]
        return bsr_spmm(self.block_idx, self.block_nnz, self.blocks, x,
                        bn=bn or min(128, n))

    def batched(self, xs, *, bn=None):
        """y [B, M, N] = W @ xs[b] for xs [B, K, N] — one launch for all B.

        The weight pattern is static (pruned at conversion time), so a batch
        of activations is the same-pattern regime of batched SpGEMM: the
        structure is shared and only the activations carry the batch axis,
        one K5-b launch instead of B (past ``MAX_BATCH`` activations, one
        launch for each ``MAX_BATCH``) on the bsr path, one ``[B, nnz]``
        stack through the plan's stream on the spgemm path.
        """
        if self.path == "dense":
            return _dense_matmul(self.dense_w, xs)   # broadcasts over B
        if self.path == "spgemm":
            return self.apply_values(self.w_values, xs)
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
        if self.path == "spgemm":
            return 2 * self.w_csc.nnz
        nb = int(self.block_nnz.sum())
        bm, bk = self.blocks.shape[2], self.blocks.shape[3]
        return 2 * nb * bm * bk


def _silu_host(g: np.ndarray) -> np.ndarray:
    """The reference's numpy SiLU of the host path.  Below about -88,
    ``exp(-g)`` overflows to inf in f32 and the quotient is -0.0, as in the
    reference: the overflow is expected, not reported."""
    with np.errstate(over="ignore"):
        return g / (1.0 + np.exp(-g))


@dataclasses.dataclass
class SparseFFN:
    """SwiGLU FFN with pruned gate/up/down matrices."""

    gate: SparseMatmul
    up: SparseMatmul
    down: SparseMatmul

    @classmethod
    def from_params(cls, p, *, keep_density=0.4, t_density=0.75, bm=8, bk=8,
                    path: str | None = None,
                    stream_limit: int | None = None, device=None):
        """Convert FFN params ``{"gate"/"up"/"down": {"w": [d_in, d_out]}}``
        (torch tensors or numpy arrays, ``ffn_table``'s orientation): each
        matrix is pruned and placed on its path by
        :meth:`SparseMatmul.from_dense`, on ``device`` (default the card)."""

        def mk(w):
            # a tensor is transposed where it lies, so the host gets the
            # weight C-contiguous and pruning tiles it without a copy
            w = _host(w.T.contiguous()) if isinstance(w, torch.Tensor) \
                else np.asarray(w).T
            return SparseMatmul.from_dense(
                w, bm=bm, bk=bk, keep_density=keep_density,
                t_density=t_density, path=path, stream_limit=stream_limit,
                device=device)

        return cls(mk(p["gate"]["w"]), mk(p["up"]["w"]), mk(p["down"]["w"]))

    # -- differentiable spgemm path ---------------------------------------

    def trainable_params(self) -> dict:
        """The trainable weight values of an all-spgemm-path FFN."""
        mats = {"gate": self.gate, "up": self.up, "down": self.down}
        bad = [k for k, m in mats.items() if m.path != "spgemm"]
        if bad:
            raise ValueError(
                f"trainable_params needs every matmul on path='spgemm' "
                f"(convert with from_params(..., path='spgemm')); "
                f"{bad} are not")
        return {k: m.w_values for k, m in mats.items()}

    def apply(self, params, x):
        """Functional forward pass: ``params`` override the stored values.

        ``x`` is ``[T, D]`` (or a batch ``[B, T, D]``, each element under
        the same values); the three matmuls run the differentiable SpGEMM
        stream with ``params['gate'/'up'/'down']`` as the weight values, so
        a gradient of anything downstream reaches the sparse weights (the
        values of a fixed pruned pattern).
        """
        silu = torch.nn.functional.silu
        xt = x.transpose(-1, -2)                     # [(B,) D, T]
        h = (silu(self.gate.apply_values(params["gate"], xt))
             * self.up.apply_values(params["up"], xt))
        return self.down.apply_values(params["down"], h).transpose(-1, -2)

    def apply_host(self, params, x) -> np.ndarray:
        """Host-stream spelling of :meth:`apply` (numpy out).

        The serving fallback: the same SwiGLU dataflow, every matmul
        through the host product stream
        (:meth:`SparseMatmul.apply_values_host`) and SiLU in numpy, as the
        reference computes it.  ``x`` is ``[T, D]`` or a batch ``[B, T,
        D]`` (numpy or a tensor); returns float32 numpy.
        """
        x = np.asarray(_host(x), np.float32)
        # each matrix's values read back once, not once per batch element
        params = {name: _host(params[name]) for name in ("gate", "up",
                                                          "down")}
        if x.ndim == 3:
            return np.stack([self.apply_host(params, xb) for xb in x])
        xt = x.T                                     # [D, T]
        g = self.gate.apply_values_host(params["gate"], xt)
        u = self.up.apply_values_host(params["up"], xt)
        return self.down.apply_values_host(params["down"],
                                           _silu_host(g) * u).T

    def __call__(self, x):
        """x [T, D] -> [T, D], or a batch [B, T, D] -> [B, T, D].

        A 3-D input runs the batched path: one launch per matrix for the
        whole batch (K5-b on the bsr path, one stack through the stream on
        the spgemm path), replacing the caller-side per-sequence loop.  The
        result is a transposed view.  On a bf16 x each step keeps the
        reference's dtype (torch promotes as JAX does): bf16 through three
        bsr matmuls, f32 from the first matmul on the dense or spgemm path
        onward (a bf16 operand times an f32 one is f32).
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


# ---------------------------------------------------------------------------
# serving integration: a model's FFN sub-layers on the spgemm path
# ---------------------------------------------------------------------------


def _ffn_sub_layers(cfg, params):
    """``(key, ffn params)`` of each sub-layer of the super-block that holds
    a dense SwiGLU ``ffn`` subtree."""
    from repro_torch.models.blocks import block_structure

    kinds, _, _ = block_structure(cfg)
    for i in range(len(kinds)):
        sub = params["blocks"].get(f"l{i}", {})
        if "ffn" in sub:
            yield f"l{i}", sub["ffn"]


def sparsify_ffn_params(cfg, params, *, keep_density=0.5,
                        stream_limit: int | None = None):
    """Convert every stacked FFN sub-layer of a model to ``path="spgemm"``.

    For each sub-layer with a dense SwiGLU ``ffn`` subtree, its stacked
    ``[n_rep, d_in, d_out]`` weight leaves are replaced by CSC value stacks
    ``{"gate"/"up"/"down": [n_rep, nnz]}`` on a pattern shared across the
    reps (:meth:`SparseMatmul.from_shared_pattern`: one mask per matrix,
    so every rep replays one cached plan), on the leaves' device.  Pruning
    runs on the host.

    Returns ``(new_params, overlay)``: ``new_params`` is the param tree
    with the value stacks spliced in, ``overlay`` maps sub-layer keys
    ``"l{i}"`` to the pattern-holding :class:`SparseFFN` that
    ``decode_step(..., sparse_ffn=overlay)`` applies with each rep's
    values.  Raises if the config has no stacked FFN sub-layer.
    """
    overlay = {}
    new_blocks = dict(params["blocks"])
    for li, fp in _ffn_sub_layers(cfg, params):

        def shared(name):
            w = fp[name]["w"]                         # [R, d_in, d_out]
            return SparseMatmul.from_shared_pattern(
                _host(w).transpose(0, 2, 1),          # -> W @ x orientation
                keep_density=keep_density, stream_limit=stream_limit,
                device=w.device if isinstance(w, torch.Tensor) else None)

        gate, gv = shared("gate")
        up, uv = shared("up")
        down, dv = shared("down")
        overlay[li] = SparseFFN(gate, up, down)
        new_blocks[li] = dict(params["blocks"][li],
                              ffn={"gate": gv, "up": uv, "down": dv})
    if not overlay:
        raise ValueError(
            f"config {cfg.name!r} (family {cfg.family!r}) has no stacked "
            "dense-FFN sub-layer to convert to path='spgemm'")
    return dict(params, blocks=new_blocks), overlay


def densify_ffn_params(cfg, params, overlay):
    """Inverse view of :func:`sparsify_ffn_params` for reference checks.

    Places each overlay matrix's ``[n_rep, nnz]`` value stacks back into
    dense ``[n_rep, d_in, d_out]`` weight leaves (zeros at pruned
    positions), on the stacks' device, so a plain dense ``decode_step``
    over the result is the numerical oracle of the sparse decode path.
    """
    new_blocks = dict(params["blocks"])
    for li, sffn in overlay.items():
        vals = params["blocks"][li]["ffn"]
        dense = {}
        for name, mat in (("gate", sffn.gate), ("up", sffn.up),
                          ("down", sffn.down)):
            c = mat.w_csc
            m, k = c.shape
            rows = np.asarray(c.row_indices)[: c.nnz].astype(np.int64)
            cols = np.repeat(np.arange(k, dtype=np.int64),
                             np.diff(np.asarray(c.col_ptr)))
            v = torch.as_tensor(vals[name], dtype=torch.float32)  # [R, nnz]
            flat = torch.from_numpy(rows * k + cols).to(v.device)
            w = torch.zeros((v.shape[0], m * k), dtype=torch.float32,
                            device=v.device).index_copy_(1, flat, v)
            # back to the param table's [R, d_in, d_out] orientation
            dense[name] = {"w": w.view(-1, m, k).transpose(1, 2)
                           .contiguous()}
        new_blocks[li] = dict(new_blocks[li], ffn=dense)
    return dict(params, blocks=new_blocks)
