#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each of which fails the run (non-zero exit, no result line):

1. Header: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the ``nvcc`` build of ``src/repro_torch/csrc/*.cu``.
2. Kernel phase: K2 SPA, K3 SPARS and K4 HASH each against its plain
   PyTorch version on the same CUDA tensors — the first and last group of
   each kind in the main path's plans, on the integer values and on
   real-valued (normal) values of the same patterns, plus edge cases on
   both (K4's own among them: probing that wraps from slot h-1 to 0, rows
   sharing one home slot, a small arrow, 50 distinct rows in a lane, an
   empty A column met first, and a table of 32768 slots, so that K4 must
   launch in both table tiers), and K2's own edge cases (a B column of 3000
   entries, an A column of 2500 named by every B column, m off and past the
   slice height, unsorted A rows, empty columns, one CTA's worth of
   columns), through K2 and, at full and cut trip counts per lane block of
   8, through K3 — exactly equal; K1
   (the fused stream replay) likewise on the forward and both gradient
   views of every matrix's product stream, plus edge cases (among them,
   around K1's long-slot threshold L: slots of L - 1, L and L + 1
   products, 3000 slots of 3000, a long slot first and last, long slots
   beside empty ones, no long slot); then K1-b at B = 1, 3, 8, 9 and 17
   against a loop of K1, bit for bit, on all those views.
3. Main path: C = A·A through ``repro_torch.core.spgemm`` for eleven of the
   paper's Table-1 matrices (synthesized from their published statistics,
   integer values in {1, 2, 3} from ``--seed``) under the default method and
   four others; every C must equal ``scipy.sparse`` A@A in f64 exactly, and
   every per-group kernel's launch count must rise during this phase.
4. Fused path: ``spgemm(A, A, engine="fused")`` for the eleven matrices,
   each equal to scipy exactly and in structure to the per-group result;
   K1 must launch during this phase.  ``iprob`` (9.0M products, past the
   default stream guard) takes the transient path.
5. Backward: ``torch.autograd.grad`` of ``sum(w * plan.stream_apply(x, x,
   engine="fused"))`` on ``cage9`` must equal the dense-matmul gradient in
   f64 on the CPU exactly, with three K1 launches (forward and two grads).
5a. Torch stream (``backend="torch"``, the counterpart of the JAX
   package's ``"jax"``: the product stream in PyTorch ops, no hand-written
   kernel): ``spgemm(A, A, backend="torch")`` for the eleven matrices
   (``iprob`` through a plan under the fused phase's raised guard, passed
   as ``plan=``), with the counts set to 0 just before: each C equals scipy
   exactly and the fused engine bit for bit, and no kernel of ours runs.
   On real values per matrix: two runs bit for bit, a B = 8 stack equal to
   a loop bit for bit, 0 host syncs per (batched) execute on card
   operands, the device operations of one execute, and the difference from
   K1's order.  A probe of the card's 1-D ``torch.segment_reduce``: for
   segments of 2 to 100,000 products, whether it adds left to right, and
   whether a segment sums alike 1-3 products later and ``ALIGN`` products
   later (the last must hold: batched == looped rests on it).  On
   ``cage9`` the gradient of ``sum(w * C)`` through ``stream_apply`` equals
   the dense-matmul gradient in f64 exactly, and a B = 8 stack's forward
   and gradient equal a loop bit for bit.
5b. Stacked backward (the fused engine on ``[B, nnz]`` stacks): for every
   matrix and B = 1, 3, 8, 9, the gradient of ``sum(w * C)`` through
   ``stream_apply(..., engine="fused")``, with the counts set to 0 just
   before: three K1-b launches a call (the forward view and both gradient
   views), no K1; every element equal to a loop of unbatched calls bit for
   bit.  Then K1-b on both gradient views of every matrix at those B
   against its plain version and a loop of K1, bit for bit.
6. Batched kernels: K1-b … K4-b (one launch for B value sets, the batch a
   second grid axis) each against its batched plain version at B = 2 (an
   integer and a normal value set) on the first group of each kind of
   every matrix's plans and on every forward view, and K2-b, K3-b and K4-b
   at B = 3 on their edge cases (K4-b's in both table tiers); and, at B = 8,
   each batched launch's slice b against the unbatched kernel on value set
   b, bit for bit, on every group of the default method and of
   ``spars-16/64`` and on every forward view, at B = 3 on those edge
   cases.
7. Batched path: ``spgemm_batched(A, B)`` for the eleven matrices with
   B = 8 integer value sets per operand (the JAX package's batched
   benchmark setting), A's and B's drawn apart, under the five methods and
   ``engine="fused"``; every element equal to ``scipy.sparse`` A_b@B_b in
   f64 exactly and bit-identical to a looped execute, ``len(groups)``
   batched launches per naive execute and 1 per fused one, 1 and 0 host
   syncs on operands on the card; K1-b … K4-b must launch in this phase.
7a. Tiled path (``method="auto"``, ``repro_torch.core.
   plan_spgemm_tiled``): with the counts set to 0 just before, for every
   matrix ``spgemm(A, A, method="auto")`` on the auto grid (a 1 x 1 grid
   but for cage9's 3, ex22's 2 and Goodwin_013's 4 column blocks) and on
   ``tile=(1024, 1024)`` (the k axis cut on nine matrices, so the merge of
   row blocks runs on the card), ``spgemm_batched`` of the B = 8 stacks on
   that grid, and a torch grid of K1 tiles (``backend="torch",
   candidates=("fused",)``); K2, K3, K4, K1 and K2-b … K4-b must each
   launch.  Every result equals ``scipy.sparse`` exactly; on real values a
   one-row-block grid of one method equals the untiled plan of that method
   bit for bit, the card's merge equals the host's numpy merge of the same
   children bit for bit, two runs agree, and each batched element equals a
   looped execute.  Per matrix and grid: the tiles' method mix, launches
   and host syncs per execute (measured, equal to the executor's count:
   one a per-group tile, one for the merge).
7b. Calibration (``repro_torch.core.profile``; the run's profiles live in
   a temporary ``REPRO_PROFILE_DIR`` of its own, set before anything
   consults one): the torch and host backends' auto picks under the
   default profile; then ``calibrate_profile(scale=0.25, reps=2,
   save=True)`` on the card, with the counts set to 0 just before: K1 must
   launch, the fingerprint must name the card ``nvidia-smi`` names (count
   1), ``load_profile()`` must return the saved profile (equal tag), and a
   tiled plan cached before and one cached after must be two LRU entries.
   The fitted constants and the tuning are printed.  Under the measured
   profile, per matrix and backend, the auto pick beside the default's;
   each candidate (spa, expand, the torch stream, K1) untiled on host
   operands, equal to scipy exactly and timed (median of 3; iprob, whose
   streams are past the default guard, is not timed); Spearman's rank
   correlation of predicted cost against measured time per backend.  Then
   ``apply_tuning()``: iprob's ``cached_plan(..., stream_limit=None)``
   fused execute must keep its stream, timed beside the transient path's
   1505.0 ms; the guard and the default profile are restored.
8. Timing: per matrix and method, the host plan time, the execute time
   (median of ``--reps``), the host syncs of one execute on operands
   already on the card, each kernel's device time (CUDA events) and
   ``torch.sparse.mm(A, A)`` as ``library_ms``, a yardstick the port never
   calls; per matrix, the fused execute beside them (0 host syncs required)
   with its device time and idle share (``torch.profiler``) and K1's time
   on each view; per matrix, a batched execute per multiply against a
   looped one, both engines, with the batched execute's device time and
   idle share; per kernel, its time, its plain version's, its bound and a
   library call's, at its largest main-path group or view (the batched
   kernels at B = 8), K2 and K2-b also against their plain versions there
   on real values.  The library call of K2-K4 is ``torch.sparse.mm`` of A
   and the group's dense B columns (once per value set when batched),
   checked against the kernel's output turned dense; K4's rows add their
   launches per table tier, on the main path and in the edge cases.
   Device times are CUDA events around a loop queued behind a device-side
   wait (``event_ms``); the rows of K2, K3 and their batched forms add
   their and their library call's host-paced times; K1's gradient views
   are timed beside ``torch.sparse.sampled_addmm``, which computes them.
   K1's and K1-b's rows add the torch stream's replay of the same view
   (``torch_stream_ms``: several PyTorch calls, not one library call),
   and K1-b's launches count the batched path and the stacked backward
   (``launches_by_path``).  Per matrix, the torch stream's execute on card
   and host operands beside the fused one on card operands, with its plan
   and lift times, device time, idle share, device operations and a
   batched execute per multiply against a loop; and at the largest stream,
   the 1-D segmented sum beside ``torch.segment_reduce``'s ``axis=1`` path
   (which the port does not use) on the same products, each against K1.
   Per matrix, ``method="auto"``'s execute on the auto grid and on
   ``tile=(1024, 1024)`` beside the untiled default and each of the cuda
   backend's auto candidates (``spa``, ``spars-40/40``,
   ``hash-256/256``), with plan times and host syncs.
9. Sparse FFN set-up: granite-20b's FFN at full width (d_model 6144, d_ff
   24576), weights from ``--seed`` through the port's ``init_params``,
   converted by ``SparseFFN.from_params`` at keep_density 0.9 (the dense
   path) and 0.25 (the bsr path), each path asserted; per matrix the
   pruned weight from ``prune_blocks`` and an integer-valued SparseMatmul
   (values in {-2 ... 2}) on the same kept blocks.
10. BSR kernels: K5 and K5-b each against its plain version, bit for bit,
   on real and integer values, at B = 1 and B = 8: the full-width gate and
   down matrices of the bsr path on a 128-column slice of x, and edge cases
   (all block-rows empty, some empty, max_nb padding, 8x16 and 16x16
   blocks, a ragged column tile, 8x8 blocks on 132 and 130 columns: the
   128-column instance and the generic one); each batched slice against
   K5.
11. Sparse FFN path: a prefill x [2048, 6144] and a batch xs [8, 128, 6144]
   through ``SparseFFN`` at both densities, with the counts set to 0 just
   before: three K5 launches per prefill and three K5-b per batch on the
   bsr path, none on the dense path; every output within 1e-5 normwise of
   the f64 FFN on the pruned weights; then each SparseMatmul on its own at
   both shapes, exactly equal to the f64 product of its pruned weight on
   integer values and within 1e-5 normwise on real ones.
12. Sparse FFN timing: per density the conversion s, the forward's median
   ms, its device span and idle share by CUDA events, each matmul's device
   ms, the flop savings and the error against the unpruned FFN; the K5 /
   K5-b rows: each kernel against its plain version, bit for bit, on gate's
   and down's operands of the bsr path (prefill for K5, batch for K5-b),
   and timed on gate's beside ``torch.matmul`` of the pruned weight (and,
   for K5-b, the BSR-tensor product); each row adds the bound of the exact
   order (a multiply and an add a product, twice the operation bound) and
   the launch's shape (``bsr_layout``).

13. The model stack (``repro_torch.models.lm``) with its FFNs on the SpGEMM
   stream: granite-20b at full width (d_model 6144, 48 heads, 1 KV head,
   d_head 128, d_ff 24576, vocab 49152) with n_layers cut from 52 to 2
   (n_rep 2, one shared pattern per matrix), f32 weights from ``--seed``
   through ``init_model`` on the card, its FFNs converted by
   ``sparsify_ffn_params(keep_density=0.1, stream_limit=2**26)`` (about
   15.1M kept values per matrix) and the dense oracle by
   ``densify_ffn_params``.  Each overlay matrix's one-token plan (15.1M
   products) built and timed; then 4 requests of 8 prompt tokens from
   ``--seed``, admitted one a tick, through ``decode_step(...,
   sparse_ffn=overlay)`` with an f32 cache of 64 and a per-slot
   ``cur_len``, each decoding 8 greedy tokens, with the counts set to 0
   just before (the torch stream runs no kernel of ours: all must stay 0):
   at every step the logits within 1e-4 normwise of ``decode_step`` on the
   densified weights (cuBLAS on the pruned weights), fed the same tokens,
   and every step after the first 0 host syncs; both greedy sequences
   printed.  ``prefill(..., sparse_ffn=overlay)`` of a [1, 4] prompt (its
   4-token plans, 60.4M products each, built and timed first) and one step
   of ``decode_step_loop(..., sparse_host=True)`` (the host stream; its
   host plans built and timed first) each within 1e-4 normwise of the
   dense oracle and of ``decode_step``.  On each one-token plan, K1
   (``stream_apply(..., engine="fused")``) equal to the torch stream bit
   for bit on integer values and within 1e-5 normwise on real ones, K1's
   count rising; both timed per call (CUDA events, queued) beside K1's
   byte bound.  The sparse and dense decode-step times (median of
   ``--reps``), the sparse step's device time and idle share
   (``torch.profiler``), and the phase's seconds beside the card line.
14. The MoE family: qwen3-moe-30b-a3b at full width (d_model 2048, 32
   heads, 4 KV heads, d_head 128, 128 experts, top-8, d_ff_expert 768, vocab
   151936) with n_layers cut from 48 to 2, f32 weights from ``--seed``
   through ``init_model`` (7.5 GB); phase 13's model freed first.
   ``moe_ffn`` on layer 0's params at [4, 1] (no drop) and on a [1, 4096]
   prefill (32 groups of 128 tokens, cap 16: pairs drop) against an f64
   oracle on the card (the same top-k, the capacity rule recomputed on the
   host, each kept pair's expert FFN) within 1e-5 normwise, two runs bit
   for bit.  Serving at capacity factor 16 (no drop): 4 slots, slot b
   starting b ticks late, 16 teacher-forced steps each from an f32 cache, 0
   host syncs a warm step; on the weights as ``init_model`` draws them the
   error against ``prefill`` is printed by position, and on the same weights
   rescaled to std 1/sqrt(d_in) (``well_scaled``: the reference's
   ``fan_in`` rule gives stacked leaves std 1/sqrt(n_rep), which saturates
   the attention softmax at full width) every live slot's logits lie within
   1e-4 normwise of prefill's.  ``moe_dispatch_spgemm`` on layer 0's router
   top-8 for a [1, 256] prompt's embeddings (X [256, 2048], R [256, 128],
   4.2M products), with the counts set to 0 just before: K2 must launch,
   the result within 1e-5 of the f64 R^T X and exact on integer values,
   its plan and execute times.  The decode step at B = 4, its device time,
   idle share and byte floor, the [1, 4096] prefill and ``moe_ffn``'s share
   of it.  (``llama4-maverick-400b-a17b`` does not fit one card: 64 GB of
   f32 experts a MoE layer.)
15. The SSM and hybrid families: falcon-mamba-7b at full width (d_model
   4096, d_inner 8192, d_state 16, dt_rank 256, chunk 64) with n_layers cut
   from 64 to 2, then zamba2-2.7b (d_model 2560, Mamba2 of 80 heads of 64,
   d_state 64, chunk 32; the shared block 32 heads of d_head 80, d_ff
   10240) cut from 54 to 6 layers, one super-block.  Each: a [2, 128]
   prefill (2 or 4 scan chunks) and 128 teacher-forced decode steps from an
   empty f32 state and cache, printed against the prefill on the weights as
   drawn and held within 1e-4 normwise on the well-scaled ones; 0 host
   syncs a warm step; prefill and a decode step bit-stable; the chunked
   scan on layer 0's real (a, u) within 1e-5 normwise of a sequential f64
   recurrence on the card; decode-step and prefill times, device time and
   idle share, the phase's seconds beside the card line.
16. The cross-attention families through the serving engine
   (``repro_torch.serving.ServeEngine``), one model at a time:
   llama-3.2-vision-90b at full width (d_model 8192, 64 heads, 8 KV heads,
   d_ff 28672, vocab 128256, 1601 image tokens) cut from 100 to 5 layers
   (one super-block: 4 ``attn_ffn`` and one ``attn_ffn_cross``), 26.1 GB
   of f32 weights from ``--seed`` with every ``xgate`` at 0.5, patch
   embeddings [4, 1601, 8192]; 4 staggered slots, each 8 prompt tokens, 8
   teacher-forced ones and 8 greedy ones: one host sync a tick, and on the
   well-scaled weights every live slot's logits within 1e-4 normwise of
   ``prefill(tokens, aux)`` at its position (as drawn: printed); the
   logits must move when ``xgate`` is zeroed; the decode step at B = 4
   beside its byte floor.  Then seamless-m4t-large-v2 at full width and
   depth (24 encoder and 24 decoder layers, d_model 1024, d_ff 8192, vocab
   256206, 4096 frames): ``prefill(tokens, frames)`` at [4, 8], the
   encoder's time; on well-scaled weights the engine with its FFNs on the
   spgemm path (keep 0.1), the counts set to 0 just before (the torch
   stream: all must stay 0), each tick within 1e-4 of the engine on the
   densified weights; that engine within 1e-4 of ``prefill`` at every
   position, and an engine on the raw frames off it (the reference's
   ``_install_memory`` contract, C11); K1 against the torch stream on the
   one-token plans (bit for bit on integers, 1e-5 on real values, its
   count rising); plan, decode-step and encoder times beside the byte
   floor (the cross K/V alone 3.2 GB a step).
17. Training (``repro_torch.training``): qwen2-0.5b at full width and
   depth (24 layers, d_model 896, 14 heads, 2 KV heads, d_head 64, d_ff
   4864, vocab 151936; 630M f32 parameters), weights from ``--seed``.
   (a) The gradient of ``train_loss`` on a [2, 64] batch at 2 of the 24
   layers, on well-scaled weights, against the same model run by the port
   on the host's CPU: the loss and each leaf within 1e-5 normwise.  (b) 20
   ``Trainer`` steps on ``SyntheticLoader(DataConfig(vocab, 512, 8,
   seed))``, 4096 tokens a step, ``remat="full"``, 5 warmup steps, peak lr
   1e-3: every loss finite and the mean of the last 3 below that of the
   first 3; the median step time beside the bound of 8·N·tokens at the
   card's f32 peak; tokens/s; a step's device time and idle share
   (``torch.profiler``); the peak memory under "full" and under "none"
   (whose first loss must equal "full"'s, and whose peak must be higher).
   (e) ``accum_steps=2`` with a bf16 buffer: its first loss within 1e-3 of
   ``accum_steps=1``'s; 8-bit moments: 3 finite steps.  (c, d) Two runs of
   3 steps from one state equal bit for bit, and the resume drill: a
   checkpoint at step 3 (its seconds and GB), a new ``Trainer``'s
   ``try_resume`` and 3 more steps, equal bit for bit to an uninterrupted
   6-step run.  (f) Layer 0's FFN (of (a)'s weights) through
   ``SparseFFN.from_params(keep_density=0.5, path="spgemm",
   stream_limit=2**26)`` (2.18M values a matrix; x [16, 896]: 34.9M
   products, past the default 8M guard): 10
   ``build_sparse_ffn_train_step`` steps, the loss below 0.7x the first,
   every warm step 0 host syncs and no plan built, no kernel of ours
   launched; then on the same plans K1's forward and both gradient views
   against the torch stream, bit for bit on integer values and within
   1e-5 normwise on real ones, K1's count rising; K1's and the torch
   stream's forward+gradient time beside K1's byte bound, and the step's
   time.

The last two lines are the kernels' JSON and the card line; the very last is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import atexit
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MATRICES = ("S40PI_n1", "bcspwr09", "tols1090", "fpga_dcop_05", "watt_1",
            "pores_2", "cage9", "ex22", "adder_dcop_01", "Goodwin_013",
            "iprob")
DEFAULT = None   # spgemm()'s own default method (h-hash-256/256)
METHODS = (DEFAULT, "spa", "h-spa-16/64", "spars-16/64", "hash-256/256")

# NVIDIA H100 SXM data sheet: HBM3 rate, and f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

KERNELS = {
    "fused": dict(name="fused_stream", route="cuda",
                  source="src/repro_torch/csrc/fused_stream.cu",
                  replaces="src/repro/core/pallas_stream.py:244"),
    "spa": dict(name="spa_spgemm", route="cuda",
                source="src/repro_torch/csrc/spa.cu",
                replaces="src/repro/kernels/spa.py:28"),
    "spars": dict(name="spars_spgemm", route="cuda",
                  source="src/repro_torch/csrc/spars.cu",
                  replaces="src/repro/kernels/spars.py:27"),
    "hash": dict(name="hash_spgemm", route="cuda",
                 source="src/repro_torch/csrc/hash_spgemm.cu",
                 replaces="src/repro/kernels/hash_spgemm.py:30"),
    "fused_b": dict(name="fused_stream_batched", route="cuda",
                    source="src/repro_torch/csrc/fused_stream.cu",
                    replaces="src/repro/core/pallas_stream.py:349"),
    "spa_b": dict(name="spa_spgemm_batched", route="cuda",
                  source="src/repro_torch/csrc/spa.cu",
                  replaces="src/repro/kernels/spa.py:92"),
    "spars_b": dict(name="spars_spgemm_batched", route="cuda",
                    source="src/repro_torch/csrc/spars.cu",
                    replaces="src/repro/kernels/spars.py:124"),
    "hash_b": dict(name="hash_spgemm_batched", route="cuda",
                   source="src/repro_torch/csrc/hash_spgemm.cu",
                   replaces="src/repro/kernels/hash_spgemm.py:147"),
    "bsr": dict(name="bsr_spmm", route="cuda",
                source="src/repro_torch/csrc/bsr_spmm.cu",
                replaces="src/repro/kernels/bsr_spmm.py:26"),
    "bsr_b": dict(name="bsr_spmm_batched", route="cuda",
                  source="src/repro_torch/csrc/bsr_spmm.cu",
                  replaces="src/repro/models/sparse_ffn.py:264"),
}
GROUP_KERNELS = ("spa", "spars", "hash")   # the per-group path's
BATCH = 8   # value sets per batched call: BENCH_batched.json's config.batch
SLICE_METHODS = (DEFAULT, "spars-16/64")   # every group kind among them
BACKWARD_MATRIX = "cage9"   # the backward phase's mid-size matrix
GUARDED_MATRIX = "iprob"    # 9.0M products, past the default stream guard


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def method_name(method) -> str:
    return "default(h-hash-256/256)" if method is None else method


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------


def integer_matrix(name: str, seed: int):
    """Table-1 matrix ``name`` with values in {1, 2, 3}: every product and
    sum of A·A stays an exact integer in f32 (the largest, iprob's, is
    below 2^24)."""
    import torch
    from repro_torch.sparse import CSC, synthesize_suitesparse
    from repro_torch.sparse.suitesparse import name_seed

    m, _ = synthesize_suitesparse(name, seed=seed)
    rng = np.random.default_rng([seed, name_seed(name)])
    vals = rng.integers(1, 4, size=m.nnz).astype(np.float32)
    return CSC(torch.from_numpy(vals), m.row_indices, m.col_ptr, m.shape)


def real_valued(a, seed: int):
    """The same pattern with standard normal f32 values: sums that round,
    so a kernel that summed in another order than its plain version would
    differ from it."""
    import torch
    from repro_torch.sparse import CSC

    rng = np.random.default_rng([seed, 1])
    vals = rng.standard_normal(a.nnz).astype(np.float32)
    return CSC(torch.from_numpy(vals), a.row_indices, a.col_ptr, a.shape)


def scipy_product(a, b):
    """(indptr, indices, data) of A@B in f64 by scipy, zeros dropped."""
    import scipy.sparse as sps
    from repro_torch.sparse.format import _np

    def csc(m):
        return sps.csc_matrix((_np(m.values).astype(np.float64),
                               _np(m.row_indices), _np(m.col_ptr)),
                              shape=m.shape)

    c = (csc(a) @ csc(b)).tocsc()
    c.eliminate_zeros()
    c.sort_indices()
    return c.indptr, c.indices, c.data


def batched_stacks(name, a, seed: int):
    """(A, B) BatchedCSC stacks of ``BATCH`` value sets in {1, 2, 3} on the
    pattern of Table-1 matrix ``name`` (``a``), on the host: every element
    and each operand its own values, so C_b = A_b·B_b mixes two stacks."""
    import torch
    from repro_torch.sparse import BatchedCSC
    from repro_torch.sparse.suitesparse import name_seed

    rng = np.random.default_rng([seed, name_seed(name), 5])
    vals = rng.integers(1, 4, size=(2, BATCH, a.nnz)).astype(np.float32)
    return tuple(BatchedCSC.from_values(a, torch.from_numpy(v))
                 for v in vals)


# K4's own edge cases, as (A pattern, B pattern, h or None for the planner's
# size): probing that wraps from slot h-1 to 0, a lane whose rows share one
# home slot, a small arrow (row 39 in 60 A columns one lane names), a lane
# with more distinct rows (50) than a round of 32, an empty A column met
# first, and a table of 32768 slots, past shared memory (tier "global")
HASH_CASES = ("wrap", "one_home", "small_arrow", "many_rows",
              "empty_a_first", "tier_global")


def hash_case(name):
    rng = np.random.default_rng(11)
    lanes = 16
    if name == "wrap":
        a = np.zeros((64, 2))
        a[[7, 15, 23], 0] = 1
        a[[8, 0], 1] = 1
        b = np.zeros((2, lanes))
        b[:, 0] = b[1, 1] = b[0, 2] = 1
        return a, b, 8
    if name == "one_home":
        rows = [r for r in range(200) if r * 0x1E3779B1 % 16 == 5][:12]
        a = np.zeros((200, 3))
        for k in range(3):
            a[rows[4 * k:4 * k + 4], k] = 1
        b = np.zeros((3, lanes))
        b[:, 0] = 1
        b[[0, 2], 1] = b[1, 2] = 1
        return a, b, 16
    if name == "small_arrow":
        a = np.zeros((40, 60))
        a[39] = 1
        for k in range(60):
            a[rng.choice(39, 2, replace=False), k] = 1
        b = (rng.uniform(size=(60, lanes)) < 0.15).astype(float)
        b[:, 0] = 1
        return a, b, None
    if name == "many_rows":
        a = np.zeros((120, 10))
        for k in range(10):
            a[5 * k:5 * k + 5, k] = 1
        b = (rng.uniform(size=(10, lanes)) < 0.3).astype(float)
        b[:, 0] = 1
        return a, b, None
    if name == "empty_a_first":
        a = np.zeros((10, 4))
        a[[0, 3, 5], 1] = 1
        a[[0, 7], 2] = 1
        a[[2, 9], 3] = 1
        b = np.zeros((4, lanes))
        b[[0, 1, 2], 0] = 1
        b[0, 1] = 1
        b[[0, 3], 2] = 1
        return a, b, None
    if name == "tier_global":
        a = (rng.uniform(size=(300, 80)) < 0.08).astype(float)
        b = (rng.uniform(size=(80, 2 * lanes)) < 0.2).astype(float)
        return a, b, 32768
    raise AssertionError(name)


def with_normal_values(op, seed, batch=None):
    """``op`` with standard normal values (``batch`` value sets of them when
    given) in its live slots and 0 in its padding."""
    import torch

    rng = np.random.default_rng(seed)
    a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = op["ab"]
    lead = () if batch is None else (batch,)

    def normal(v):
        x = rng.standard_normal(lead + tuple(v.shape)).astype(np.float32)
        return (torch.from_numpy(x).to(v.device) * (v != 0)).contiguous()

    return dict(op, ab=(a_rows, normal(a_vals), a_nnz, b_rows,
                        normal(b_vals), b_nnz))


def edge_operands(dev):
    """Padded kernel operands for the edge cases: a B entry on an empty A
    column, empty B columns, an all-empty operand, a table exactly full
    (Op_j + 1 = H), H = 2, a lane block that is all padding, and K4's own
    (HASH_CASES), each with values in {1, 2, 3}."""
    import torch
    from repro_torch.core.analysis import hash_table_size
    from repro_torch.sparse import (
        csc_from_dense, csc_to_padded_columns, ops_per_column,
        random_uniform_csc, steps_per_column,
    )

    block = 32
    rng = np.random.default_rng(3)
    cases = {}
    ad = np.zeros((12, 12))
    ad[[1, 4], 3] = (2.0, 3.0)
    bd = np.zeros((12, 40))
    bd[[0, 3, 7], 5] = (1.0, 4.0, 1.0)
    bd[0, 9] = 2.0
    cases["empty_a_column"] = (ad, bd, None)
    ad = rng.integers(1, 4, (24, 20)) * (rng.uniform(size=(24, 20)) < 0.3)
    bd = rng.integers(1, 4, (20, 32)) * (rng.uniform(size=(20, 32)) < 0.3)
    bd[:, ::2] = 0
    cases["empty_b_columns"] = (ad, bd, None)
    cases["all_empty"] = (random_uniform_csc(16, 0), random_uniform_csc(16, 0),
                          None)
    ad = np.zeros((8, 8))
    ad[[1, 2, 3], 0] = (1.0, 2.0, 3.0)
    bd = np.zeros((8, 8))
    bd[[0, 1], 4] = (2.0, 5.0)
    cases["table_full"] = (ad, bd, None)
    cases["h2"] = (np.eye(16)[:, rng.permutation(16)], np.eye(16) * 3.0, 2)
    bd = rng.integers(1, 4, (24, 10)) * (rng.uniform(size=(24, 10)) < 0.3)
    cases["padding_block"] = (rng.integers(1, 4, (24, 24))
                              * (rng.uniform(size=(24, 24)) < 0.2), bd, None)
    for name in HASH_CASES:
        a, b, h = hash_case(name)
        cases[name] = (a * rng.integers(1, 4, a.shape),
                       b * rng.integers(1, 4, b.shape), h)
    out = {}
    for name, (a, b, h) in cases.items():
        a = a if not isinstance(a, np.ndarray) else csc_from_dense(a)
        b = b if not isinstance(b, np.ndarray) else csc_from_dense(b)
        ar, av, an = csc_to_padded_columns(a)
        br, bv, bn = csc_to_padded_columns(b)
        n_real = b.n_cols
        n_pad = (-(-n_real // block) + (name == "padding_block")) * block
        pad = n_pad - n_real
        steps = np.zeros(n_pad, np.int64)
        steps[:n_real] = steps_per_column(a, b)
        ops = int(ops_per_column(a, b).max(initial=0))
        out[name] = dict(
            ab=tuple(x.to(dev) for x in (
                ar, av.float(), an,
                torch.nn.functional.pad(br, (0, 0, 0, pad)),
                torch.nn.functional.pad(bv.float(), (0, 0, 0, pad)),
                torch.nn.functional.pad(bn, (0, pad)))),
            steps=torch.from_numpy(steps.reshape(-1, block).max(axis=1)
                                   .astype(np.int32)).to(dev),
            m=a.n_rows, block=block,
            h=h if h is not None else hash_table_size(ops))
    return out


# K2's own edge cases (slices of 512 rows, CTAs of 8 columns), as (m, A
# column lengths, B column lengths, shape): "arrow": every short A column
# holds row m - 1, "hub": every B column names A column 0
SPA_CASES = {
    # iprob's shape: one B column of 3000 entries over A columns of 3 rows,
    # each holding the arrow row m - 1
    "long_b_column": (3001, [3] * 3000 + [3000], [3000] + [4] * 127, "arrow"),
    # one A column of 2500 entries named by every B column
    "long_a_column": (2600, [2500] + [3] * 399, [20] * 64, "hub"),
    "m_not_a_multiple_of_the_slice": (1000, [30] * 300, [40] * 32, None),
    "m_below_one_slice": (5, [3] * 20, [10] * 16, None),
    "m_past_four_slices": (2300, [400] * 100, [60] * 16, None),
    "empty_a_and_b_columns": (300, [0, 5, 0, 0, 17, 0] * 10,
                              [0, 3, 0, 12, 0, 0, 60, 0], None),
    "one_cta_of_columns_and_padding": (400, [60] * 200,
                                       [150, 7, 0, 90] + [0] * 4, None),
}


def spa_edge_operands(dev, batch=None):
    """Per K2 edge case and value kind ("int": values in {1, 2, 3}, "real":
    standard normal), padded operands with A's rows unsorted and padding
    slots holding rows and values that must never be read; ``batch`` value
    sets of one pattern when given."""
    import torch

    out = {}
    for name, (m, a_lens, b_lens, shape) in SPA_CASES.items():
        for kind in ("int", "real"):
            rng = np.random.default_rng(len(name))
            n_a, n_b = len(a_lens), len(b_lens)
            za, zb = max(a_lens), max(b_lens)
            lead = () if batch is None else (batch,)

            def vals(dims):
                if kind == "int":
                    return rng.integers(1, 4, dims).astype(np.float32)
                return rng.standard_normal(dims).astype(np.float32)

            a_rows = rng.integers(0, m, (n_a, za)).astype(np.int32)
            for k, n in enumerate(a_lens):
                a_rows[k, :n] = rng.choice(m, n, replace=False)
                if shape == "arrow" and 0 < n < za \
                        and m - 1 not in a_rows[k, :n]:
                    a_rows[k, rng.integers(n)] = m - 1
            b_rows = rng.integers(0, n_a, (n_b, zb)).astype(np.int32)
            for c, n in enumerate(b_lens):
                b_rows[c, :n] = np.sort(rng.choice(n_a, n, replace=False))
                if shape == "hub" and n and 0 not in b_rows[c, :n]:
                    b_rows[c, :n] = np.sort(np.r_[0, b_rows[c, 1:n]])
            ops = (a_rows, vals(lead + (n_a, za)), np.array(a_lens, np.int32),
                   b_rows, vals(lead + (n_b, zb)), np.array(b_lens, np.int32))
            out[f"{name} {kind}"] = dict(
                ab=tuple(torch.from_numpy(x).to(dev) for x in ops), m=m,
                block=n_b)
    return out


SPARS_EDGE_BLOCK = 8   # K3's lane blocks on K2's edge cases


def spars_edge_operands(dev, batch=None):
    """K2's edge cases (``spa_edge_operands``) as K3 operands: a trip count
    per lane block of SPARS_EDGE_BLOCK columns, the block's largest lane
    (sum of max(nnz(A[:, k]), 1) over its B entries; "full") or half of it
    rounded up ("cut": lanes stop inside A columns, each block at its own
    count).  The step on an empty A column reads that column's padding slot
    0, which holds a random row and value here."""
    import torch

    out = {}
    for name, op in spa_edge_operands(dev, batch).items():
        _, _, a_nnz, b_rows, _, b_nnz = op["ab"]
        per = torch.clamp(a_nnz, min=1)[b_rows.long()]
        live = (torch.arange(b_rows.shape[1], device=dev)[None, :]
                < b_nnz[:, None])
        full = (per * live).sum(1).reshape(-1, SPARS_EDGE_BLOCK).max(1).values
        for cut, steps in (("full", full), ("cut", (full + 1) // 2)):
            out[f"{name}, {cut} trip counts"] = dict(
                op, steps=steps.int().contiguous(), block=SPARS_EDGE_BLOCK)
    return out


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def group_operands(plan, a, groups=None):
    """(ab, steps, m, block, h) of each of ``groups`` (default: all groups
    of ``plan``) on A's values, as the executor feeds them to the kernels."""
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.sparse.format import padded_values

    lay = plan.layout
    vals = a.values.to(plan.device, torch.float32)
    av = padded_values(vals, lay.a_gather, lay.a_mask)
    for g in lay.groups if groups is None else groups:
        yield g, dict(ab=(lay.a_rows, av, lay.a_nnz, g.b_rows,
                          padded_values(vals, g.b_vgather, g.b_vmask),
                          g.b_nnz),
                      steps=g.steps, m=plan.shape[0], block=BLOCK_COLS,
                      h=g.h)


def wrapper(kind, op, suffix=""):
    """The wrapper of group kernel ``kind`` (``suffix`` "_plain" for its
    plain version) that takes ``op``: the batched one when the values carry
    a batch axis."""
    from repro_torch import kernels

    batched = "_batched" if op["ab"][1].dim() == 3 else ""
    return getattr(kernels, f"{kind}_spgemm{batched}{suffix}")


def run_kernel(kind, op):
    fn = wrapper(kind, op)
    if kind == "spa":
        return (fn(*op["ab"], m=op["m"], block_cols=op["block"]),)
    if kind == "spars":
        return fn(*op["ab"], op["steps"], m=op["m"], block_cols=op["block"])
    return fn(*op["ab"], op["steps"], m=op["m"], h=op["h"],
              block_cols=op["block"])


def run_plain(kind, op):
    fn = wrapper(kind, op, "_plain")
    if kind == "spa":
        return (fn(*op["ab"], m=op["m"]),)
    if kind == "spars":
        return fn(*op["ab"], op["steps"], m=op["m"], block_cols=op["block"])
    return fn(*op["ab"], op["steps"], h=op["h"], block_cols=op["block"])


def compare(kind, op, label):
    """Kernel vs plain on the same tensors (one value set or a batch);
    returns max |difference|."""
    import torch

    got = run_kernel(kind, op)
    torch.cuda.synchronize()
    want = run_plain(kind, op)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{kind} {label}: shape/dtype {g.shape}/{g.dtype} vs "
              f"{w.shape}/{w.dtype}")
        check(torch.equal(g, w), f"{kind} {label}: kernel != plain version")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def tier_launches(wrapper, before) -> dict:
    """K4's (or K4-b's) launches per table tier since ``before``; fails
    unless both tiers launched."""
    tiers = {t: n - before[t] for t, n in wrapper.n_launches_by_tier.items()}
    print(f"kernel {wrapper.__name__}: edge-case launches by tier {tiers}",
          flush=True)
    check(all(tiers.values()), f"{wrapper.__name__}: the edge cases did not "
          f"reach every table tier: {tiers}")
    return tiers


def kernel_phase(plans, mats, dev, seed):
    """Every kernel against its plain version: the first and last group of
    each kind of every matrix's plans, on the integer values and on real
    values of the same pattern, and the edge cases on both; returns the
    largest differences and K4's edge-case launches per table tier."""
    errs = {k: 0.0 for k in GROUP_KERNELS}
    checked = {k: 0 for k in GROUP_KERNELS}
    for name in MATRICES:
        seen = {}
        for method in METHODS:
            for g in plans[name, method].layout.groups:
                seen.setdefault(g.kind, []).append((method, g))
        real = real_valued(mats[name], seed)
        for kind, groups in seen.items():
            picks = [groups[0]] + ([groups[-1]] if len(groups) > 1 else [])
            for method, g in picks:
                for values, a in (("int", mats[name]), ("real", real)):
                    (_, op), = group_operands(plans[name, method], a, [g])
                    errs[kind] = max(errs[kind], compare(
                        kind, op, f"{name} {method_name(method)} "
                        f"{len(g.cols)} cols, {values} values"))
                    checked[kind] += 1
    from repro_torch import kernels

    before = dict(kernels.hash_spgemm.n_launches_by_tier)
    for name, op in edge_operands(dev).items():
        for values, vop in (("int", op),
                            ("real", with_normal_values(op, seed))):
            for kind in GROUP_KERNELS:
                errs[kind] = max(errs[kind], compare(
                    kind, vop, f"{name}, {values} values"))
                checked[kind] += 1
    tiers = tier_launches(kernels.hash_spgemm, before)
    for name, op in spa_edge_operands(dev).items():
        errs["spa"] = max(errs["spa"], compare("spa", op, name))
        checked["spa"] += 1
    for name, op in spars_edge_operands(dev).items():
        errs["spars"] = max(errs["spars"], compare("spars", op, name))
        checked["spars"] += 1
    for kind in GROUP_KERNELS:
        check(checked[kind] > 0, f"{kind}: no group compared")
        print(f"kernel {KERNELS[kind]['name']}: {checked[kind]} comparisons "
              f"with the plain version, max |diff| {errs[kind]}", flush=True)
    return errs, tiers


# ---------------------------------------------------------------------------
# the batched kernels against their plain versions and the unbatched ones
# ---------------------------------------------------------------------------


def batched_group_operands(plan, a_vals, b_vals, groups=None):
    """(group, op) of each of ``groups`` (default: all groups of ``plan``)
    for the value stacks ``a_vals``/``b_vals`` [B, nnz], as the batched
    executor feeds them to the batched kernels."""
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.sparse.format import padded_values_batched

    lay = plan.layout
    av = padded_values_batched(a_vals.to(plan.device, torch.float32),
                               lay.a_gather, lay.a_mask)
    bv = b_vals.to(plan.device, torch.float32)
    for g in lay.groups if groups is None else groups:
        yield g, dict(ab=(lay.a_rows, av, lay.a_nnz, g.b_rows,
                          padded_values_batched(bv, g.b_vgather, g.b_vmask),
                          g.b_nnz),
                      steps=g.steps, m=plan.shape[0], block=BLOCK_COLS,
                      h=g.h)


def element_op(op, b):
    """The unbatched operands of value set b of a batched ``op``."""
    a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = op["ab"]
    return dict(op, ab=(a_rows, a_vals[b].contiguous(), a_nnz, b_rows,
                        b_vals[b].contiguous(), b_nnz))


def compare_slices(kind, op, label) -> None:
    """Slice b of one batched launch against the unbatched kernel on value
    set b, bit for bit, for every b."""
    import torch

    got = run_kernel(kind, op)
    for b in range(op["ab"][1].shape[0]):
        for g, w in zip(got, run_kernel(kind, element_op(op, b))):
            check(torch.equal(g[b], w), f"{kind} batched {label}: slice "
                  f"{b} != the unbatched kernel on value set {b}")
    torch.cuda.synchronize()


def two_value_sets(a, stack, seed):
    """[2, nnz] on the pattern of ``a``: the stack's first integer value set
    and a standard normal one (sums that round, so another summation order
    than the plain version's would show)."""
    import torch

    return torch.stack([stack.values[0],
                        real_valued(a, seed).values.to(stack.values.device)])


def batched_kernel_phase(plans, fplans, mats, stacks, dev, seed):
    """K2-b … K4-b against their batched plain versions at B = 2 on the
    first group of each kind of every matrix's plans, and their slices
    against the unbatched kernels at B = 8 on every group of
    ``SLICE_METHODS``; K1-b likewise on every forward view; K2-b's and
    K4-b's edge cases (K4-b's in both table tiers) at B = 3.  Returns the
    largest differences and K4-b's edge-case launches per table tier."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import fused_stream

    errs = {k: 0.0 for k in GROUP_KERNELS + ("fused",)}
    checked = {k: 0 for k in errs}
    sliced = {k: 0 for k in errs}
    for name in MATRICES:
        sa, sb = stacks[name]
        a2 = two_value_sets(mats[name], sa, seed)
        b2 = two_value_sets(mats[name], sb, seed + 1)
        firsts = {}
        for method in METHODS:
            for g in plans[name, method].layout.groups:
                firsts.setdefault(g.kind, (method, g))
        for kind, (method, g) in firsts.items():
            (_, op), = batched_group_operands(plans[name, method], a2, b2,
                                              [g])
            errs[kind] = max(errs[kind], compare(
                kind, op, f"{name} {method_name(method)} {len(g.cols)} cols, "
                "B = 2"))
            checked[kind] += 1
        for method in SLICE_METHODS:
            for g, op in batched_group_operands(plans[name, method],
                                                sa.values, sb.values):
                compare_slices(g.kind, op, f"{name} {method_name(method)} "
                               f"{len(g.cols)} cols")
                sliced[g.kind] += 1
        view = fused_stream(fplans[name]["plan"]).forward
        x, y = a2.to(dev), b2.to(dev)
        got = run_k1b(view, x, y)
        torch.cuda.synchronize()
        want = run_k1_plain(view, x, y, batched=True)
        check(torch.equal(got, want), f"fused_stream_batched {name} B = 2: "
              "kernel != plain version")
        errs["fused"] = max(errs["fused"], float(
            (got.double() - want.double()).abs().max()))
        checked["fused"] += 1
        x, y = sa.values.to(dev), sb.values.to(dev)
        got = run_k1b(view, x, y)
        for b in range(BATCH):
            check(torch.equal(got[b], run_k1(view, x[b], y[b])),
                  f"fused_stream_batched {name}: slice {b} != K1 on value "
                  f"set {b}")
        sliced["fused"] += 1
    for name, op in spa_edge_operands(dev, batch=3).items():
        errs["spa"] = max(errs["spa"], compare("spa", op, f"{name}, B = 3"))
        checked["spa"] += 1
        compare_slices("spa", op, name)
        sliced["spa"] += 1
    for name, op in spars_edge_operands(dev, batch=3).items():
        errs["spars"] = max(errs["spars"], compare("spars", op,
                                                   f"{name}, B = 3"))
        checked["spars"] += 1
        compare_slices("spars", op, name)
        sliced["spars"] += 1
    # K4's edge cases at B = 3 in both table tiers
    before = dict(kernels.hash_spgemm_batched.n_launches_by_tier)
    for name, op in edge_operands(dev).items():
        if name not in HASH_CASES:
            continue
        for h in sorted({op["h"], 32768}):
            bop = with_normal_values(dict(op, h=h), seed, batch=3)
            label = f"{name} h = {h}"
            errs["hash"] = max(errs["hash"], compare("hash", bop,
                                                     f"{label}, B = 3"))
            checked["hash"] += 1
            compare_slices("hash", bop, label)
            sliced["hash"] += 1
    tiers = tier_launches(kernels.hash_spgemm_batched, before)
    for kind in errs:
        name = KERNELS[kind + "_b"]["name"]
        check(checked[kind] > 0 and sliced[kind] > 0,
              f"{name}: nothing compared")
        print(f"kernel {name}: {checked[kind]} comparisons with the batched "
              f"plain version at B = 2, max |diff| {errs[kind]}; "
              f"{sliced[kind]} launches at B = {BATCH} equal the unbatched "
              "kernel slice by slice (K2-b's, K3-b's and K4-b's edge cases "
              "at B = 3 in both)", flush=True)
    return errs, tiers


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def main_path(mats, expected):
    """C = A·A through spgemm() for every matrix and method; exact check."""
    from repro_torch import kernels
    from repro_torch.core import plan_cache_clear, spgemm
    from repro_torch.sparse.format import _np

    plan_cache_clear()
    kernels.reset_launch_counts()
    for name in MATRICES:
        a = mats[name]
        for method in METHODS:
            c = spgemm(a, a) if method is None else spgemm(a, a, method)
            indptr, indices, data = expected[name]
            label = f"{name} {method_name(method)}"
            check(c.values.device.type == "cuda", f"{label}: result on "
                  f"{c.values.device}")
            check(np.array_equal(_np(c.col_ptr), indptr),
                  f"{label}: col_ptr differs from scipy")
            check(np.array_equal(_np(c.row_indices), indices),
                  f"{label}: row indices differ from scipy")
            vals = _np(c.values)
            check(np.isfinite(vals).all(), f"{label}: non-finite values")
            check(np.array_equal(vals.astype(np.float64), data),
                  f"{label}: values differ from scipy")
    counts = kernels.launch_counts()
    counts["hash_spgemm_by_tier"] = dict(
        kernels.hash_spgemm.n_launches_by_tier)
    print(f"main path: {len(MATRICES)} matrices x {len(METHODS)} methods "
          f"equal scipy A@A exactly; launches {json.dumps(counts)}",
          flush=True)
    for kind in GROUP_KERNELS:
        name = KERNELS[kind]["name"]
        check(counts[name] > 0, f"{name} was not launched on the main path")
    return counts


# ---------------------------------------------------------------------------
# the fused engine (K1)
# ---------------------------------------------------------------------------


def fused_plans(mats, dev):
    """Per matrix, a plan whose stream guard admits all its products, with
    its K1 views built: the plan, its plan and view-build times, its product
    count, and whether the guard had to be raised above the default."""
    import torch
    from repro_torch.core import fast, fused_stream, plan_spgemm
    from repro_torch.core.expand import product_count
    from repro_torch.sparse.format import _np

    out = {}
    for name in MATRICES:
        a = mats[name]
        products = product_count(_np(a.col_ptr), _np(a.col_ptr),
                                 _np(a.row_indices))
        t0 = time.perf_counter()
        plan = plan_spgemm(a, a, device=dev, stream_limit=max(
            products, fast.STREAM_MAX_PRODUCTS))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused_stream(plan)
        torch.cuda.synchronize()
        out[name] = dict(plan=plan, plan_ms=(t1 - t0) * 1e3,
                         view_build_ms=(time.perf_counter() - t1) * 1e3,
                         products=products,
                         guard_raised=products > fast.STREAM_MAX_PRODUCTS)
    return out


def view_operands(plan, a, seed):
    """(values, view name, view, x, y) of the three K1 views of ``plan``
    (C = A·A) as the engine feeds them, on A's integer values and on normal
    values of the same pattern: forward x = y = A's values; the gradient
    views x = an output cotangent (integer or normal, from ``seed``), y =
    A's values."""
    import torch
    from repro_torch.core import fused_stream

    fs = fused_stream(plan)
    dev = plan.device
    rng = np.random.default_rng([seed, 2])
    n_c = fs.forward.n_out
    for kind, m, g in (
            ("int", a, rng.integers(1, 4, n_c)),
            ("real", real_valued(a, seed), rng.standard_normal(n_c))):
        v = m.values.to(dev, torch.float32)
        g = torch.from_numpy(g.astype(np.float32)).to(dev)
        yield kind, "forward", fs.forward, v, v
        yield kind, "grad_a", fs.grad_a, g, v
        yield kind, "grad_b", fs.grad_b, g, v


def run_k1(view, x, y):
    from repro_torch import kernels

    return kernels.fused_stream(view.idx_x, view.idx_y, view.seg_ptr, x, y,
                                long_slots=view.long_slots)


def run_k1b(view, x, y):
    from repro_torch import kernels

    return kernels.fused_stream_batched(view.idx_x, view.idx_y, view.seg_ptr,
                                        x, y, long_slots=view.long_slots)


def run_k1_plain(view, x, y, batched=False):
    from repro_torch import kernels

    fn = (kernels.fused_stream_batched_plain if batched
          else kernels.fused_stream_plain)
    return fn(view.idx_x, view.idx_y, view.seg_ptr, x, y)


def compare_k1(view, x, y, label):
    """K1 vs its plain version on the same tensors; max |difference|."""
    import torch

    got = run_k1(view, x, y)
    torch.cuda.synchronize()
    want = run_k1_plain(view, x, y)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (view.n_out,)
          and got.dtype == want.dtype == torch.float32,
          f"fused_stream {label}: shape/dtype {got.shape}/{got.dtype} vs "
          f"{want.shape}/{want.dtype}")
    check(torch.equal(bits(got), bits(want)),
          f"fused_stream {label}: kernel != plain version")
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def k1_edge_views(dev):
    """K1 views of the edge cases, and normal values for them: zero
    products, one segment spanning the whole stream, many one-product
    segments, and empty segments between full ones; around K1's long-slot
    threshold L (``LONG_SLOT``): slots of L - 1, L and L + 1 products, 3000
    slots of 3000 products (iprob's gradient views), a long slot first and
    last, long slots beside empty ones, and a view with no long slot."""
    import torch
    from repro_torch.core.fused_stream import FusedView
    from repro_torch.kernels.fused_stream import LONG_SLOT, long_slots_of

    rng = np.random.default_rng(4)
    n_val = 1000

    def view(lens):
        seg_ptr = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
        p = int(seg_ptr[-1])

        def lift(v):
            return torch.as_tensor(np.asarray(v, np.int32), device=dev)

        return FusedView(
            idx_x=lift(rng.integers(0, n_val, p)),
            idx_y=lift(rng.integers(0, n_val, p)), seg_ptr=lift(seg_ptr),
            long_slots=long_slots_of(torch.from_numpy(seg_ptr)).to(dev),
            out_map=None, n_out=len(seg_ptr) - 1, n_products=p)

    lens = rng.integers(0, 4, 5000)
    near = rng.choice([LONG_SLOT - 1, LONG_SLOT, LONG_SLOT + 1], 3000)
    beside_empty = np.zeros(4000, int)
    beside_empty[1::3] = rng.integers(LONG_SLOT + 1, 400, len(
        beside_empty[1::3]))
    cases = {
        "zero_products": view(np.zeros(3, int)),
        "one_segment": view(np.array([20_000])),
        "one_product_segments": view(np.ones(200_000, int)),
        "empty_segments": view(lens),
        "around_the_threshold": view(near),
        "3000_slots_of_3000": view(np.full(3000, 3000)),
        "long_first_and_last": view(np.concatenate((
            [5000], rng.integers(0, 8, 20_000), [4321]))),
        "long_beside_empty": view(beside_empty),
        "no_long_slot": view(rng.integers(0, LONG_SLOT + 1, 50_000)),
    }
    check(cases["no_long_slot"].long_slots.numel() == 0
          and cases["3000_slots_of_3000"].long_slots.numel() == 3000,
          "K1's edge views: long-slot lists not as built")
    x, y = (torch.from_numpy(rng.standard_normal(n_val).astype(np.float32))
            .to(dev) for _ in range(2))
    return cases, x, y


def fused_kernel_phase(fplans, mats, dev, seed):
    """K1 against its plain version on the forward and both gradient views
    of every matrix, on integer and normal values, and the edge cases."""
    err, checked = 0.0, 0
    for name in MATRICES:
        for kind, vname, view, x, y in view_operands(
                fplans[name]["plan"], mats[name], seed):
            err = max(err, compare_k1(view, x, y,
                                      f"{name} {vname}, {kind} values"))
            checked += 1
    cases, x, y = k1_edge_views(dev)
    for label, view in cases.items():
        err = max(err, compare_k1(view, x, y, label))
        checked += 1
    print(f"kernel fused_stream: {checked} comparisons with the plain "
          f"version, max |diff| {err}", flush=True)
    return err


# K1-b's batch sizes: within one tile of 8 value sets, one whole tile, and
# one or two tiles and a part
K1B_BATCHES = (1, 3, 8, 9, 17)


def bits(t):
    """``t``'s f32 values as their bit patterns (torch.equal of two of
    them tells -0.0 from 0.0)."""
    import torch

    return t.contiguous().view(torch.int32)


def fused_batch_phase(fplans, mats, dev, seed):
    """K1-b at B = 1, 3, 8, 9 and 17 normal value sets against a loop of K1,
    slice by slice, bit for bit, on the three views of every matrix and on
    K1's edge views; on the edge views K1-b also against its plain version
    at B = 3."""
    import torch
    from repro_torch.core import fused_stream

    gen = torch.Generator(device=dev).manual_seed(seed)
    views = []
    for name in MATRICES:
        fs = fused_stream(fplans[name]["plan"])
        nnz = mats[name].nnz
        for vname in ("forward", "grad_a", "grad_b"):
            n_x = nnz if vname == "forward" else fs.forward.n_out
            views.append((f"{name} {vname}", getattr(fs, vname), n_x, nnz))
    cases, x, _ = k1_edge_views(dev)
    edges = [(label, view, x.numel(), x.numel())
             for label, view in cases.items()]
    launches = 0
    for i, (label, view, n_x, n_y) in enumerate(views + edges):
        for batch in K1B_BATCHES:
            xs, ys = (torch.randn((batch, n), generator=gen, device=dev)
                      for n in (n_x, n_y))
            got = run_k1b(view, xs, ys)
            launches += 1
            for b in range(batch):
                check(torch.equal(bits(got[b]),
                                  bits(run_k1(view, xs[b], ys[b]))),
                      f"fused_stream_batched {label} B = {batch}: slice {b} "
                      f"!= K1 on value set {b}")
            if batch == 3 and i >= len(views):
                check(torch.equal(bits(got), bits(run_k1_plain(
                    view, xs, ys, batched=True))),
                      f"fused_stream_batched {label} B = 3: kernel != plain "
                      "version")
    print(f"kernel fused_stream_batched: {launches} launches at B in "
          f"{K1B_BATCHES} equal a loop of K1 bit for bit ({len(views)} "
          f"matrix views, {len(edges)} edge views; the edge views also the "
          "plain version at B = 3)", flush=True)


def fused_path(mats, expected):
    """C = A·A through spgemm(engine="fused") for every matrix; exact
    check against scipy and against the per-group result's structure."""
    from repro_torch import kernels
    from repro_torch.core import cached_plan, spgemm
    from repro_torch.sparse.format import _np

    kernels.reset_launch_counts()
    results = {name: spgemm(mats[name], mats[name], engine="fused")
               for name in MATRICES}
    counts = kernels.launch_counts()
    for name, c in results.items():
        indptr, indices, data = expected[name]
        label = f"{name} engine=fused"
        check(c.values.device.type == "cuda", f"{label}: result on "
              f"{c.values.device}")
        check(np.array_equal(_np(c.col_ptr), indptr),
              f"{label}: col_ptr differs from scipy")
        check(np.array_equal(_np(c.row_indices), indices),
              f"{label}: row indices differ from scipy")
        vals = _np(c.values)
        check(np.isfinite(vals).all(), f"{label}: non-finite values")
        check(np.array_equal(vals.astype(np.float64), data),
              f"{label}: values differ from scipy")
        naive = spgemm(mats[name], mats[name])
        for f in ("col_ptr", "row_indices"):
            check(np.array_equal(_np(getattr(c, f)), _np(getattr(naive, f))),
                  f"{label}: {f} differs from the per-group result")
    a = mats[GUARDED_MATRIX]
    plan = cached_plan(a, a)
    stats: dict = {}
    plan.execute(a, a, engine="fused", stats=stats)
    check(plan.stream is None and not stats["stream_cached"]
          and plan.fused_stream_nbytes == 0,
          f"{GUARDED_MATRIX} did not take the transient path past the "
          "stream guard")
    print(f"fused path: {len(MATRICES)} matrices equal scipy A@A and the "
          f"per-group structure exactly; {GUARDED_MATRIX} "
          f"({stats['stream_products']} "
          f"products > stream_limit {plan.stream_limit}) ran transiently; "
          f"launches {json.dumps(counts)}", flush=True)
    check(counts["fused_stream"] == len(MATRICES),
          f"fused_stream launched {counts['fused_stream']} times for "
          f"{len(MATRICES)} fused executes")
    for kind in GROUP_KERNELS:
        check(counts[KERNELS[kind]["name"]] == 0,
              f"the fused path launched {KERNELS[kind]['name']}")
    return counts


def stored_coords(row_indices, col_ptr):
    import torch
    from repro_torch.sparse.format import _np

    cp = _np(col_ptr).astype(np.int64)
    rows = torch.from_numpy(_np(row_indices)[: cp[-1]].astype(np.int64))
    cols = torch.from_numpy(np.repeat(np.arange(len(cp) - 1), np.diff(cp)))
    return rows, cols


def backward_phase(mats, dev, seed):
    """One backward through plan.stream_apply(engine="fused") on the card,
    against the dense-matmul gradient in f64 on the CPU, exactly."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import cached_plan, fused_stream

    a = mats[BACKWARD_MATRIX]
    plan = cached_plan(a, a)
    fs = fused_stream(plan)
    check(fs is not None, f"{BACKWARD_MATRIX}: no stream under the guard")
    rng = np.random.default_rng([seed, 3])
    x_np = rng.integers(1, 4, a.nnz).astype(np.float32)
    w_np = rng.integers(1, 4, fs.forward.n_out).astype(np.float32)
    kernels.reset_launch_counts()
    x = torch.from_numpy(x_np).to(dev).requires_grad_()
    w = torch.from_numpy(w_np).to(dev)
    c = plan.stream_apply(x, x, engine="fused")
    g, = torch.autograd.grad((w * c).sum(), x)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["fused_stream"]

    xd = torch.from_numpy(x_np).double().requires_grad_()
    ad = torch.zeros(a.shape, dtype=torch.float64).index_put(
        stored_coords(a.row_indices, a.col_ptr), xd)
    c_at = stored_coords(fs.c_rows, fs.c_col_ptr)
    wd = torch.zeros(a.shape, dtype=torch.float64).index_put(
        c_at, torch.from_numpy(w_np).double())
    prod = ad @ ad
    gd, = torch.autograd.grad((wd * prod).sum(), xd)
    check(torch.equal(c.detach().cpu().double(), prod.detach()[c_at]),
          f"{BACKWARD_MATRIX}: fused forward differs from the dense product")
    check(torch.equal(g.cpu().double(), gd),
          f"{BACKWARD_MATRIX}: fused gradient differs from the dense-matmul "
          f"gradient (max |diff| "
          f"{float((g.cpu().double() - gd).abs().max())})")
    check(launches == 3, f"backward launched fused_stream {launches} times, "
          "not 3 (forward, grad_a, grad_b)")
    print(f"backward: d sum(w * C) / dx through stream_apply(engine='fused') "
          f"on {BACKWARD_MATRIX} ({fs.n_products} products) equals the "
          f"dense-matmul gradient in f64 exactly; fused_stream launches "
          f"{launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# the torch stream (backend="torch") and the stacked gradient (K1-b)
# ---------------------------------------------------------------------------

# K1-b's batch sizes on the gradient views: within one tile of 8 value sets,
# one whole tile, and one tile and a part
GRAD_BATCHES = (1, 3, 8, 9)


def torch_plans(mats, fplans, dev):
    """Per matrix, the torch-backend plan: the LRU's (what spgemm(A, A,
    backend="torch") reaches) under the default guard, and past it (iprob)
    one under the fused phase's raised guard; its stream built and lifted,
    with the time each took."""
    import torch
    from repro_torch.core import cached_plan, device_stream, plan_spgemm

    out = {}
    for name in MATRICES:
        a = mats[name]
        t0 = time.perf_counter()
        if fplans[name]["guard_raised"]:
            plan = plan_spgemm(a, a, backend="torch", device=dev,
                               stream_limit=fplans[name]["plan"].stream_limit)
        else:
            plan = cached_plan(a, a, backend="torch")
        t1 = time.perf_counter()
        device_stream(plan, grads=True)
        torch.cuda.synchronize()
        out[name] = dict(plan=plan, plan_ms=(t1 - t0) * 1e3,
                         lift_ms=(time.perf_counter() - t1) * 1e3,
                         guard_raised=fplans[name]["guard_raised"])
    return out


def torch_stream_path(mats, expected, tplans):
    """C = A·A through spgemm(backend="torch") for every matrix (iprob
    through its raised-guard plan, ``plan=``), with the counts set to 0
    just before: each C equals scipy exactly, on the card, and no
    hand-written kernel runs; then each equals the fused engine on the same
    plan bit for bit (integer values: every order agrees)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import spgemm
    from repro_torch.sparse.format import _np

    kernels.reset_launch_counts()
    results = {}
    for name in MATRICES:
        a = mats[name]
        results[name] = (spgemm(a, a, plan=tplans[name]["plan"])
                         if tplans[name]["guard_raised"]
                         else spgemm(a, a, backend="torch"))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"the torch stream launched "
          f"hand-written kernels: {counts}")
    for name, c in results.items():
        indptr, indices, data = expected[name]
        label = f"{name} backend=torch"
        check(c.values.device.type == "cuda", f"{label}: result on "
              f"{c.values.device}")
        check(np.array_equal(_np(c.col_ptr), indptr)
              and np.array_equal(_np(c.row_indices), indices),
              f"{label}: structure differs from scipy")
        vals = _np(c.values)
        check(np.isfinite(vals).all()
              and np.array_equal(vals.astype(np.float64), data),
              f"{label}: values differ from scipy")
        a = mats[name]
        fused = tplans[name]["plan"].execute(a, a, engine="fused")
        check(torch.equal(bits(fused.values), bits(c.values)),
              f"{label}: values differ from the fused engine's")
    print(f"torch stream path: {len(MATRICES)} matrices equal scipy A@A "
          "exactly and the fused engine bit for bit; hand-written kernels "
          f"launched {json.dumps(counts)}", flush=True)
    return counts


def device_ops(fn, n=3) -> float:
    """Device operations (kernels, copies, memsets) per call of ``fn``, as
    torch.profiler counts them, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / n


def torch_stream_checks(mats, tplans, fplans, dev, seed):
    """Per matrix, on real (normal) values on the card: two executes of the
    torch stream bit for bit; a B = BATCH stack through one flat segmented
    sum equal to a loop of executes bit for bit; 0 host syncs per execute
    and per batched execute on card operands; the device operations of one
    execute; and how far the card's order is from K1's (bit-equal or the
    largest difference, relative to the largest magnitude)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name in MATRICES:
        plan = tplans[name]["plan"]
        a = real_valued(mats[name], seed).to(dev)
        label = f"{name} backend=torch, real values"
        first = plan.execute(a, a).values
        second = plan.execute(a, a).values
        check(torch.equal(bits(first), bits(second)),
              f"{label}: two runs differ")
        k1 = fplans[name]["plan"].execute(a, a, engine="fused").values
        diff = float((first.double() - k1.double()).abs().max()) \
            if first.numel() else 0.0
        scale = float(k1.abs().max()) if k1.numel() else 1.0
        xs = torch.randn((BATCH, a.nnz), generator=gen, device=dev)
        ys = torch.randn((BATCH, a.nnz), generator=gen, device=dev)
        batched = plan.execute_batched(xs, ys)
        for b in range(BATCH):
            check(torch.equal(bits(batched[b].values),
                              bits(plan.execute(xs[b], ys[b]).values)),
                  f"{label}: batched element {b} != a looped execute")
        syncs = host_syncs(lambda: plan.execute(a, a))
        b_syncs = host_syncs(lambda: plan.execute_batched(xs, ys))
        check(syncs == 0 and b_syncs == 0, f"{label}: {syncs} / {b_syncs} "
              "host syncs per (batched) execute on card operands")
        out[name] = dict(
            matrix=name, engine="torch", products=plan.stream.n_products,
            runs_bit_identical=True, batched_equals_looped=True,
            equals_k1_bits=bool(torch.equal(bits(first), bits(k1))),
            max_abs_diff_vs_k1=diff,
            rel_diff_vs_k1=diff / scale if scale else 0.0,
            host_syncs=syncs, batched_host_syncs=b_syncs,
            device_ops_per_execute=device_ops(lambda: plan.execute(a, a)))
        print(json.dumps(out[name]), flush=True)
    print(f"torch stream: {len(MATRICES)} matrices bit-stable on real "
          f"values, B = {BATCH} equal to a loop bit for bit, 0 host syncs",
          flush=True)
    return out


def segment_order_probe(dev, seed):
    """The order of the card's 1-D ``torch.segment_reduce``: for segments
    of several lengths, whether it equals the left-to-right sum (the CPU's,
    K1's), the difference if not, and whether the segment's sum changes
    when its first product sits 1, 2 or 3 products (4-12 bytes) or
    ``ALIGN`` products later in the buffer; and whether its ``[1, P]``
    (``axis=1``) path adds left to right."""
    import torch
    from repro_torch.core.device_stream import ALIGN

    rng = np.random.default_rng([seed, 5])
    rows = []
    for length in (2, 32, 33, 256, 1000, 3000, 4096, 5000, 20_000, 100_000):
        x = rng.standard_normal(length).astype(np.float32)
        seq = torch.segment_reduce(torch.from_numpy(x), "sum",
                                   lengths=torch.tensor([length]),
                                   unsafe=True)
        sums = {}
        for off in (0, 1, 2, 3, ALIGN):
            buf = torch.zeros(off + length, device=dev)
            buf[off:] = torch.from_numpy(x).to(dev)
            lengths = torch.tensor([off, length], device=dev)
            sums[off] = torch.segment_reduce(buf, "sum", lengths=lengths,
                                             unsafe=True)[1:].cpu()
        # the same segment through segment_reduce's [1, P] (axis=1) path,
        # which the torch stream does not use
        two_d = torch.segment_reduce(
            torch.from_numpy(x).to(dev)[None], "sum",
            lengths=torch.tensor([[length]], device=dev), axis=1,
            unsafe=True)[0].cpu()
        rows.append(dict(
            length=length,
            equals_left_to_right=bool(torch.equal(bits(sums[0]), bits(seq))),
            abs_diff=float((sums[0].double() - seq.double()).abs()),
            same_at_offsets_1_2_3=all(torch.equal(bits(sums[0]),
                                                  bits(sums[o]))
                                      for o in (1, 2, 3)),
            same_at_offset_align=bool(torch.equal(bits(sums[0]),
                                                  bits(sums[ALIGN]))),
            axis1_path_equals_left_to_right=bool(torch.equal(bits(two_d),
                                                             bits(seq)))))
    print(json.dumps({"segment_reduce_order_on_card": rows}), flush=True)
    for r in rows:
        check(r["same_at_offset_align"], f"segment_reduce: a segment of "
              f"{r['length']} products sums differently {ALIGN} products "
              "later, so the torch stream's batched == looped would fail")
    return rows


def torch_backward_phase(mats, tplans, dev, seed):
    """On cage9: the gradient of sum(w * C) through stream_apply (the torch
    stream) equals the dense-matmul gradient in f64 exactly on integer
    values; and a B = BATCH stack's forward and gradients equal a loop bit
    for bit on real values."""
    import torch

    a = mats[BACKWARD_MATRIX]
    plan = tplans[BACKWARD_MATRIX]["plan"]
    rng = np.random.default_rng([seed, 3])
    x_np = rng.integers(1, 4, a.nnz).astype(np.float32)
    n_c = plan.stream.nnz
    w_np = rng.integers(1, 4, n_c).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev).requires_grad_()
    w = torch.from_numpy(w_np).to(dev)
    c = plan.stream_apply(x, x)
    g, = torch.autograd.grad((w * c).sum(), x)
    xd = torch.from_numpy(x_np).double().requires_grad_()
    ad = torch.zeros(a.shape, dtype=torch.float64).index_put(
        stored_coords(a.row_indices, a.col_ptr), xd)
    s = plan.stream
    c_at = stored_coords(s.c_rows, s.c_col_ptr)
    wd = torch.zeros(a.shape, dtype=torch.float64).index_put(
        c_at, torch.from_numpy(w_np).double())
    prod = ad @ ad
    gd, = torch.autograd.grad((wd * prod).sum(), xd)
    check(torch.equal(c.detach().cpu().double(), prod.detach()[c_at]),
          f"{BACKWARD_MATRIX}: torch stream forward differs from the dense "
          "product")
    check(torch.equal(g.cpu().double(), gd),
          f"{BACKWARD_MATRIX}: torch stream gradient differs from the "
          "dense-matmul gradient (max |diff| "
          f"{float((g.cpu().double() - gd).abs().max())})")
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((BATCH, a.nnz), generator=gen, device=dev)
    ws = torch.randn((BATCH, n_c), generator=gen, device=dev)
    xb = xs.clone().requires_grad_()
    cb = plan.stream_apply(xb, xb)
    gb, = torch.autograd.grad((ws * cb).sum(), xb)
    for b in range(BATCH):
        xk = xs[b].clone().requires_grad_()
        ck = plan.stream_apply(xk, xk)
        gk, = torch.autograd.grad((ws[b] * ck).sum(), xk)
        check(torch.equal(bits(cb[b].detach()), bits(ck.detach()))
              and torch.equal(bits(gb[b]), bits(gk)),
              f"{BACKWARD_MATRIX}: stacked torch-stream element {b} != a "
              "looped call")
    print(f"torch backward: d sum(w * C) / dx through stream_apply on "
          f"{BACKWARD_MATRIX} ({s.n_products} products) equals the "
          f"dense-matmul gradient in f64 exactly; a B = {BATCH} stack "
          "equals a loop bit for bit, forward and gradient", flush=True)


def grad_view_path(fplans, mats, dev, seed):
    """The stacked backward through the fused engine: for every matrix and
    B in GRAD_BATCHES, sum(w * C) of plan.stream_apply on [B, nnz] stacks
    differentiated, with the counts set to 0 just before and read just
    after: K1-b launches on the forward view and on both gradient views (3
    a call), K1 none.  Then each stack's forward and gradients equal a loop
    of unbatched calls bit for bit.  Returns the counts."""
    import torch
    from repro_torch import kernels

    gen = torch.Generator(device=dev).manual_seed(seed)
    calls = []
    for name in MATRICES:
        plan = fplans[name]["plan"]
        for batch in GRAD_BATCHES:
            xs = torch.randn((batch, mats[name].nnz), generator=gen,
                             device=dev)
            ws = torch.randn((batch, plan.stream.nnz), generator=gen,
                             device=dev)
            calls.append((name, batch, xs, ws))
    kernels.reset_launch_counts()
    results = []
    for name, batch, xs, ws in calls:
        x = xs.clone().requires_grad_()
        c = fplans[name]["plan"].stream_apply(x, x, engine="fused")
        g, = torch.autograd.grad((ws * c).sum(), x)
        results.append((c.detach(), g))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts["fused_stream_batched"] == 3 * len(calls)
          and counts["fused_stream"] == 0,
          f"stacked fused backward: launches {counts}, expected "
          f"{3 * len(calls)} of fused_stream_batched and none else")
    for (name, batch, xs, ws), (c, g) in zip(calls, results):
        plan = fplans[name]["plan"]
        for b in range(batch):
            xk = xs[b].clone().requires_grad_()
            ck = plan.stream_apply(xk, xk, engine="fused")
            gk, = torch.autograd.grad((ws[b] * ck).sum(), xk)
            check(torch.equal(bits(c[b]), bits(ck.detach()))
                  and torch.equal(bits(g[b]), bits(gk)),
                  f"{name} B = {batch}: stacked fused element {b} != a "
                  "looped call")
    print(f"stacked fused backward: {len(calls)} calls ({len(MATRICES)} "
          f"matrices x B in {GRAD_BATCHES}) equal a loop bit for bit, "
          f"forward and gradient; launches {json.dumps(counts)}",
          flush=True)
    return counts


def grad_view_kernel_phase(fplans, mats, dev, seed):
    """K1-b on both gradient views of every matrix at B in GRAD_BATCHES,
    against its plain version and against a loop of K1, bit for bit."""
    import torch
    from repro_torch.core import fused_stream

    gen = torch.Generator(device=dev).manual_seed(seed)
    checked = 0
    for name in MATRICES:
        fs = fused_stream(fplans[name]["plan"])
        for vname in ("grad_a", "grad_b"):
            view = getattr(fs, vname)
            for batch in GRAD_BATCHES:
                g = torch.randn((batch, fs.forward.n_out), generator=gen,
                                device=dev)
                v = torch.randn((batch, mats[name].nnz), generator=gen,
                                device=dev)
                got = run_k1b(view, g, v)
                want = run_k1_plain(view, g, v, batched=True)
                label = f"fused_stream_batched {name} {vname} B = {batch}"
                check(torch.equal(bits(got), bits(want)),
                      f"{label}: kernel != plain version")
                for b in range(batch):
                    check(torch.equal(bits(got[b]),
                                      bits(run_k1(view, g[b], v[b]))),
                          f"{label}: slice {b} != K1 on value set {b}")
                checked += 1
    print(f"kernel fused_stream_batched on the gradient views: {checked} "
          f"launches at B in {GRAD_BATCHES} equal the plain version and a "
          "loop of K1 bit for bit", flush=True)


# ---------------------------------------------------------------------------
# the batched path (K1-b … K4-b)
# ---------------------------------------------------------------------------

BATCHED_RUNS = METHODS + ("fused",)   # the five methods, then the fused engine


def run_label(run) -> str:
    return "engine=fused" if run == "fused" else method_name(run)


def batched_call(stacks, run):
    """``spgemm_batched`` of ``stacks`` as a user calls it for ``run`` (a
    method of ``METHODS`` or ``"fused"``), and the launches it made."""
    from repro_torch import kernels
    from repro_torch.core import spgemm_batched

    args = () if run in (None, "fused") else (run,)
    engine = "fused" if run == "fused" else None
    before = kernels.launch_counts()
    res = spgemm_batched(*stacks, *args, engine=engine)
    after = kernels.launch_counts()
    return res, {k: n - before[k] for k, n in after.items() if n > before[k]}


def batched_path(stacks):
    """Drive spgemm_batched for every matrix and run, with the counts set
    to 0 just before and read just after; returns the results, each call's
    launches and the counts."""
    from repro_torch import kernels
    from repro_torch.core import plan_cache_clear

    plan_cache_clear()
    kernels.reset_launch_counts()
    results, launches = {}, {}
    for name in MATRICES:
        for run in BATCHED_RUNS:
            results[name, run], launches[name, run] = batched_call(
                stacks[name], run)
    counts = kernels.launch_counts()
    counts["hash_spgemm_batched_by_tier"] = dict(
        kernels.hash_spgemm_batched.n_launches_by_tier)
    print(f"batched path: {len(MATRICES)} matrices x {len(BATCHED_RUNS)} "
          f"runs at B = {BATCH}; launches {json.dumps(counts)}", flush=True)
    for kind in GROUP_KERNELS + ("fused",):
        name = KERNELS[kind + "_b"]["name"]
        check(counts[name] > 0, f"{name} was not launched on the batched "
              "path")
        check(counts[KERNELS[kind]["name"]] == 0,
              f"the batched path launched {KERNELS[kind]['name']}")
    return results, launches, counts


def check_batched_path(results, launches, stacks, fplans, dev):
    """Every element of every batched result equals scipy A_b@B_b in f64
    exactly and a looped execute bit for bit; each batched execute made
    len(groups) (naive) or 1 (fused) launches and, on operands on the card,
    1 or 0 host syncs."""
    import torch
    from repro_torch.core import cached_plan
    from repro_torch.sparse.format import _np

    syncs = {}
    for name in MATRICES:
        sa, sb = stacks[name]
        expected = [scipy_product(sa[b], sb[b]) for b in range(BATCH)]
        a_dev, b_dev = sa.to(dev), sb.to(dev)
        for run in BATCHED_RUNS:
            label = f"{name} {run_label(run)} batched"
            fused = run == "fused"
            engine = "fused" if fused else None
            plan = cached_plan(sa[0], sb[0],
                               None if run in (None, "fused") else run)
            res = results[name, run]
            check(len(res) == BATCH, f"{label}: {len(res)} results")
            want = ({"fused_stream_batched": 1} if fused else {})
            for g in plan.layout.groups if not fused else ():
                key = KERNELS[g.kind + "_b"]["name"]
                want[key] = want.get(key, 0) + 1
            check(launches[name, run] == want, f"{label}: launches "
                  f"{launches[name, run]}, expected {want}")
            # iprob's cached plan is guarded, so its looped fused executes
            # would rebuild the stream each time: they run on the
            # raised-guard plan of the same pattern, whose stream is equal
            loop_plan = fplans[name]["plan"] if fused else plan
            for b, c in enumerate(res):
                indptr, indices, data = expected[b]
                check(c.values.device.type == "cuda",
                      f"{label}: element {b} on {c.values.device}")
                check(np.array_equal(_np(c.col_ptr), indptr)
                      and np.array_equal(_np(c.row_indices), indices),
                      f"{label}: element {b}'s structure differs from scipy")
                vals = _np(c.values)
                check(np.isfinite(vals).all()
                      and np.array_equal(vals.astype(np.float64), data),
                      f"{label}: element {b}'s values differ from scipy")
                one = loop_plan.execute(sa[b], sb[b], engine=engine)
                for f in ("col_ptr", "row_indices", "values"):
                    check(torch.equal(torch.as_tensor(getattr(c, f)),
                                      torch.as_tensor(getattr(one, f))),
                          f"{label}: element {b}'s {f} differs from a "
                          "looped execute")
            # 0 syncs needs the stream kept (no views lifted per call)
            syncs[name, run] = host_syncs(
                lambda: loop_plan.execute_batched(a_dev, b_dev, engine=engine))
            check(syncs[name, run] == (0 if fused else 1),
                  f"{label}: {syncs[name, run]} host syncs on card operands")
    print(f"batched path: every element of {len(MATRICES)} matrices x "
          f"{len(BATCHED_RUNS)} runs x B = {BATCH} equals scipy A_b@B_b and "
          "a looped execute exactly; launches per execute len(groups) "
          "(naive) or 1 (fused); host syncs 1 (naive) and 0 (fused)",
          flush=True)
    return syncs


# ---------------------------------------------------------------------------
# the tiled path: method="auto"
# ---------------------------------------------------------------------------

# an explicit grid that cuts the k axis of the nine matrices of more than
# 1024 columns (the auto grid cuts none: their nnz stay far below
# DEFAULT_KSPLIT_NNZ), so that the merge of row blocks runs on the card
TILE = (1024, 1024)
AUTO_FIXED = ("spa", "spars-40/40", "hash-256/256")   # cuda's candidates


def csc_bits(c):
    """(col_ptr, rows, f32 value bits) of a CSC on the host."""
    from repro_torch.sparse.format import _np

    cp = _np(c.col_ptr).astype(np.int64)
    nnz = int(cp[-1])
    vals = np.ascontiguousarray(_np(c.values)[:nnz].astype(np.float32))
    return cp, _np(c.row_indices)[:nnz].astype(np.int64), vals.view(np.int32)


def same_bits(x, y) -> bool:
    return all(np.array_equal(u, v) for u, v in zip(csc_bits(x),
                                                     csc_bits(y)))


def check_scipy(c, want, label) -> None:
    from repro_torch.sparse.format import _np

    indptr, indices, data = want
    check(c.values.device.type == "cuda", f"{label}: result on "
          f"{c.values.device}")
    check(np.array_equal(_np(c.col_ptr), indptr)
          and np.array_equal(_np(c.row_indices), indices),
          f"{label}: structure differs from scipy")
    vals = _np(c.values)
    check(np.isfinite(vals).all()
          and np.array_equal(vals.astype(np.float64), data),
          f"{label}: values differ from scipy")


def method_mix(plan) -> dict:
    mix: dict = {}
    for m in plan.methods.values():
        mix[m] = mix.get(m, 0) + 1
    return mix


def host_merged(plan, av, bv):
    """The grid's children run one by one on the card and their results
    merged on the host by the numpy merge (the JAX package's): what the
    card's merge must equal bit for bit."""
    from repro_torch.core.executor import _merge_and_stitch

    per_block = {ni: [] for ni in range(plan.grid[1])}
    for t in plan.tiles:
        lo, hi = t.a_vals
        c = t.plan.execute(av[lo:hi], bv[t.b_index])
        per_block[t.n].append(c.to("cpu"))
    return _merge_and_stitch(plan, per_block, np.float32)


def tiled_path(mats, stacks):
    """The tiled path as a user calls it, with the counts set to 0 just
    before and read just after: per matrix ``spgemm(A, A, method="auto")``
    on the auto grid and on ``tile=TILE``, ``spgemm_batched`` of the B = 8
    stacks on ``TILE``, and a torch grid of K1 tiles (``backend="torch",
    candidates=("fused",)``) on ``TILE``.  K2, K3, K4 and K1 (and K2-b ...
    K4-b) must each launch."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import plan_cache_clear, spgemm, spgemm_batched

    plan_cache_clear()
    kernels.reset_launch_counts()
    results = {}
    for name in MATRICES:
        a = mats[name]
        results[name, "auto"] = spgemm(a, a, method="auto")
        results[name, "tile"] = spgemm(a, a, method="auto", tile=TILE)
        results[name, "batched"] = spgemm_batched(*stacks[name],
                                                  method="auto", tile=TILE)
        results[name, "fused"] = spgemm(a, a, method="auto", tile=TILE,
                                        backend="torch",
                                        candidates=("fused",))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"tiled path: {len(MATRICES)} matrices x (auto grid, tile={TILE}"
          f", B = {BATCH} on tile={TILE}, a torch grid of K1 tiles); "
          f"launches {json.dumps(counts)}", flush=True)
    for kind in GROUP_KERNELS + ("fused",):
        name = KERNELS[kind]["name"]
        check(counts[name] > 0, f"{name} was not launched on the tiled path")
    for kind in GROUP_KERNELS:
        name = KERNELS[kind + "_b"]["name"]
        check(counts[name] > 0, f"{name} was not launched on the tiled path")
    return results, counts


def check_tiled_path(results, mats, expected, stacks, dev, seed):
    """(a) the auto grid equals scipy exactly, and a grid of one row block
    whose tiles chose one method equals the untiled plan of that method bit
    for bit on real values; (b) ``tile=TILE`` equals scipy exactly, the
    card's merge equals the host's numpy merge of the same children bit for
    bit on real values, and two runs agree bit for bit; (c) each element of
    the B = 8 batched call equals scipy and, on real values, a loop of
    executes bit for bit; (d) the torch grid of K1 tiles equals scipy.
    Host syncs of one execute on card operands, measured, must equal the
    executor's count (a per-group tile's one, and one for the merge)."""
    import torch
    from repro_torch.core import cached_plan, plan_spgemm_tiled

    out = {}
    for name in MATRICES:
        a = mats[name]
        ar = real_valued(a, seed)
        a_dev, ar_dev = a.to(dev), ar.to(dev)
        for key in ("auto", "tile", "fused"):
            check_scipy(results[name, key], expected[name],
                        f"{name} auto {key}")
        auto = plan_spgemm_tiled(a, a)
        tiled = plan_spgemm_tiled(a, a, tile=TILE)
        # (a) one row block, one method: the untiled method's bits
        mix = method_mix(auto)
        if auto.grid[0] == 1 and len(mix) == 1:
            (only,) = mix
            check(same_bits(auto.execute(ar, ar),
                            cached_plan(ar, ar, only).execute(ar, ar)),
                  f"{name}: the {auto.grid} grid of {only} differs from "
                  "the untiled plan")
        # (b) the card's merge against the host's, and run to run
        got = tiled.execute(ar_dev, ar_dev)
        av = ar_dev.values.float()
        check(same_bits(got, host_merged(tiled, av, av)),
              f"{name} tile={TILE}: the card's merge differs from the "
              "host's")
        check(same_bits(got, tiled.execute(ar_dev, ar_dev)),
              f"{name} tile={TILE}: two runs differ")
        # (c) B = 8: scipy on integer stacks, a loop on real ones
        sa, sb = stacks[name]
        for b, c in enumerate(results[name, "batched"]):
            check_scipy(c, scipy_product(sa[b], sb[b]),
                        f"{name} auto batched element {b}")
        rng = np.random.default_rng([seed, 7])
        real = torch.from_numpy(rng.standard_normal(
            (BATCH, a.nnz)).astype(np.float32)).to(dev)
        batched = tiled.execute_batched(real, real)
        for b, c in enumerate(batched):
            check(same_bits(c, tiled.execute(real[b], real[b])),
                  f"{name} tile={TILE}: batched element {b} differs from "
                  "a loop")
        line = {"matrix": name}
        for label, plan in (("auto", auto), ("tile", tiled)):
            stats: dict = {}
            plan.execute(a_dev, a_dev, stats=stats)
            syncs = host_syncs(lambda: plan.execute(a_dev, a_dev))
            check(syncs == stats["host_syncs"], f"{name} {label}: {syncs} "
                  f"host syncs, the executor counts {stats['host_syncs']}")
            line[label] = dict(grid=plan.grid, tiles=len(plan.tiles),
                               methods=method_mix(plan),
                               merged_blocks=stats["merged_blocks"],
                               launches=stats["n_launches"],
                               host_syncs=syncs)
        out[name] = line
        print(json.dumps({"tiled": line}), flush=True)
    print(f"tiled path: {len(MATRICES)} matrices equal scipy A@A exactly on "
          f"the auto grid, on tile={TILE}, batched (B = {BATCH}) and "
          "through K1 tiles; the card's merge equals the host's bit for "
          "bit, bit-stable; batched equals a loop; host syncs as counted",
          flush=True)
    return out


def tiled_timing_phase(mats, dev, reps):
    """Per matrix, the execute time (host clock, host operands) of
    ``method="auto"`` on the auto grid and on ``TILE`` beside the untiled
    default (h-hash-256/256) and each of cuda's candidates untiled: the
    six plans run in turn, ``reps`` rounds after two warm-up rounds, so a
    drift of the host's pace touches all six alike; the median of each.
    With each plan's plan time (the tiled ones: their children too, the LRU
    emptied first) and host syncs on card operands; where the auto grid has
    several tiles, the profiler's device time of one execute of auto and of
    the default and the card's idle share."""
    import torch
    from repro_torch.core import cached_plan, plan_cache_clear, \
        plan_spgemm_tiled

    plan_cache_clear()
    rows = {}
    for name in MATRICES:
        a = mats[name]
        a_dev = a.to(dev)
        plans, plan_ms = {}, {}
        for label, build in (
                ("auto", lambda: plan_spgemm_tiled(a, a)),
                ("tile", lambda: plan_spgemm_tiled(a, a, tile=TILE)),
                ("default", lambda: cached_plan(a, a)),
                *((m, lambda m=m: cached_plan(a, a, m)) for m in AUTO_FIXED)):
            t0 = time.perf_counter()
            plans[label] = build()
            torch.cuda.synchronize()
            plan_ms[label] = (time.perf_counter() - t0) * 1e3
        samples = {label: [] for label in plans}
        for r in range(reps + 2):
            for label, plan in plans.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan.execute(a, a)
                torch.cuda.synchronize()
                if r >= 2:
                    samples[label].append((time.perf_counter() - t0) * 1e3)
        med = {label: statistics.median(v) for label, v in samples.items()}
        row = {"matrix": name, "grid": plans["auto"].grid,
               "methods": method_mix(plans["auto"]),
               "tile_grid": plans["tile"].grid,
               "tile_methods": method_mix(plans["tile"]),
               "plan_ms": plan_ms, "execute_ms_median": med,
               "host_syncs": {label: host_syncs(
                   lambda: plan.execute(a_dev, a_dev))
                   for label, plan in plans.items()},
               "device_ms": {}, "idle_share": {}}
        for label in ("auto", "default") if len(plans["auto"].tiles) > 1 \
                else ():
            d = profiled_device_ms(lambda: plans[label].execute(a, a), n=1)
            row["device_ms"][label] = d
            row["idle_share"][label] = idle_share(d, med[label])
        row["auto_vs_default"] = med["auto"] / med["default"]
        row["auto_vs_best_fixed"] = med["auto"] / min(med[m]
                                                      for m in AUTO_FIXED)
        rows[name] = row
        print(json.dumps({"tiled_timing": row}), flush=True)
    return rows


# ---------------------------------------------------------------------------
# calibration: the machine profile (core/profile.py) on the card
# ---------------------------------------------------------------------------

CAL_BACKENDS = ("torch", "host")   # the grids whose picks the profile moves
# the matrices the phase times: iprob's stream (9.0M products) is past the
# default guard, so its stream candidates rebuild it on every call, seconds
# each; its guarded fused execute is timed after apply_tuning() instead
CAL_TIMED = tuple(m for m in MATRICES if m != GUARDED_MATRIX)
CAL_REPS = 3
# iprob's fused execute past the default guard on the H100 (PERF.md §5)
TRANSIENT_FUSED_MS = 1505.0


def auto_picks(mats, dev) -> dict:
    """Per (matrix, backend) of ``CAL_BACKENDS``, the auto grid's per-tile
    method mix under the profile in force."""
    from repro_torch.core import plan_spgemm_tiled

    return {(name, be): method_mix(plan_spgemm_tiled(
        mats[name], mats[name], backend=be, cache=False, device=dev))
        for name in MATRICES for be in CAL_BACKENDS}


def candidate_runs(a, dev) -> dict:
    """Each auto candidate of the torch and host backends as an untiled
    plan through the LRU, run on host operands as a tile of that method
    runs: ``spa`` and ``expand`` (its stream engine) in numpy, ``torch``
    (the torch stream) and ``fused`` (K1) on the card."""
    from repro_torch.core import cached_plan

    spa = cached_plan(a, a, "spa", backend="host")
    expand = cached_plan(a, a, "expand", backend="host")
    dplan = cached_plan(a, a, "expand", backend="torch", device=dev)
    return {"spa": lambda: spa.execute(a, a),
            "expand": lambda: expand.execute(a, a),
            "torch": lambda: dplan.execute(a, a),
            "fused": lambda: dplan.execute(a, a, engine="fused")}


def median_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn``, each call waited for on the card (the
    caller has run ``fn`` once already: streams and views are built)."""
    import torch

    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def check_product(c, want, label) -> None:
    """C equal to scipy's A@A exactly, wherever it lies and in whatever row
    order each column holds (the host oracles keep discovery order)."""
    import scipy.sparse as sps
    from repro_torch.sparse.format import _np

    cp = _np(c.col_ptr).astype(np.int64)
    nnz = int(cp[-1])
    got = sps.csc_matrix((_np(c.values)[:nnz].astype(np.float64),
                          _np(c.row_indices)[:nnz], cp), shape=c.shape)
    got.sort_indices()
    indptr, indices, data = want
    check(np.array_equal(got.indptr, indptr)
          and np.array_equal(got.indices, indices),
          f"{label}: structure differs from scipy")
    check(np.isfinite(got.data).all() and np.array_equal(got.data, data),
          f"{label}: values differ from scipy")


def calibration_phase(mats, expected, dev, card):
    """Phase 7b: ``calibrate_profile(scale=0.25, reps=2, save=True)`` on
    the card, with the counts set to 0 just before: K1 must launch, the
    fingerprint must name this card (``nvidia-smi``'s name, count 1),
    ``load_profile()`` must return the saved profile, and a tiled plan
    cached before and after must be two LRU entries.  Then, per matrix and
    for the torch and host backends, the auto pick under the defaults and
    under the measured profile; each candidate untiled, timed (median of
    ``CAL_REPS``) and equal to scipy exactly; Spearman's rank correlation
    of predicted cost against measured time per backend.  Then
    ``apply_tuning()``: iprob's cached fused plan must keep its stream,
    timed beside the transient path.  The guard and the default profile
    are restored, so no later phase changes."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import cached_plan, fast, plan_cache_clear, \
        profile, spgemm
    from repro_torch.core.api import PLAN_CACHE
    from repro_torch.core.cost import AUTO_CANDIDATES, estimate_cost
    from repro_torch.core.planner import pattern_fingerprint
    from repro_torch.sparse.stats import tile_stats

    t_phase = time.perf_counter()
    check(profile.current_profile().source == "default",
          "a profile was in force before calibration")
    default_picks = auto_picks(mats, dev)
    probe = mats[MATRICES[0]]
    spgemm(probe, probe, method="auto", backend="torch",
           device=dev)   # its tag: "default"

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    prof = profile.calibrate_profile(scale=0.25, reps=2, save=True)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    fp = prof.fingerprint
    name = card.split(",")[0].strip()
    check(fp["platform"] == "cuda" and fp["device_kind"] == name
          and fp["device_count"] == 1,
          f"the fingerprint names {fp['device_kind']} x "
          f"{fp['device_count']}, not {name} x 1")
    k1 = KERNELS["fused"]["name"]
    check(counts[k1] > 0, f"{k1} was not launched by the calibration")
    loaded = profile.load_profile()
    check(loaded is not None and loaded.tag == prof.tag
          and loaded.constants == prof.constants,
          "load_profile() does not return the saved profile")
    check(profile.current_profile() is prof,
          "the calibrated profile is not the current one")
    spgemm(probe, probe, method="auto", backend="torch", device=dev)
    fp_probe = pattern_fingerprint(probe)
    tags = sorted(k[6] for k in PLAN_CACHE._plans
                  if k[:4] == (fp_probe, fp_probe, "auto", "torch"))
    check(tags == sorted(["default", prof.tag]),
          f"tiled plans cached before and after calibration: {tags}")
    print(json.dumps({"calibration_profile": dict(
        seconds=cal_s, tag=prof.tag, fingerprint=fp, launches=counts,
        fitted={f: getattr(prof.constants, f) for f in prof.fitted},
        tuning=prof.tuning, path=prof.path)}), flush=True)

    measured_picks = auto_picks(mats, dev)
    points = {be: ([], []) for be in CAL_BACKENDS}
    for mname in MATRICES:
        a = mats[mname]
        ms, pred = {}, {}
        if mname in CAL_TIMED:
            st = tile_stats(a, a)
            for method, run in candidate_runs(a, dev).items():
                check_product(run(), expected[mname],
                              f"{mname} {method} under the measured profile")
                ms[method] = median_ms(run, CAL_REPS)
                pred[method] = estimate_cost(st, method, "host")
        for be in CAL_BACKENDS:
            line = dict(matrix=mname, backend=be,
                        pick_default=default_picks[mname, be],
                        pick_measured=measured_picks[mname, be])
            if ms:
                cands = AUTO_CANDIDATES[be]
                line.update(ms={m: ms[m] for m in cands},
                            predicted_ms={m: pred[m] * 1e3 for m in cands},
                            fastest=min(cands, key=ms.get))
                points[be][0].extend(pred[m] for m in cands)
                points[be][1].extend(ms[m] for m in cands)
            print(json.dumps({"calibration": line}), flush=True)
    rho = {be: profile.rank_correlation(*points[be]) for be in CAL_BACKENDS}
    print(json.dumps({"calibration_rank_correlation": dict(
        rho, points={be: len(points[be][0]) for be in CAL_BACKENDS},
        timed=list(CAL_TIMED))}), flush=True)

    guard = fast.STREAM_MAX_PRODUCTS
    applied = profile.apply_tuning()
    a = mats[GUARDED_MATRIX]
    plan = cached_plan(a, a, stream_limit=None, device=dev)
    stats: dict = {}
    check_scipy(plan.execute(a, a, engine="fused", stats=stats),
                expected[GUARDED_MATRIX],
                f"{GUARDED_MATRIX} fused under the tuned guard")
    check(stats["stream_cached"], f"{GUARDED_MATRIX}'s cached fused plan "
          f"rebuilt its stream under the tuned guard {applied}")
    fused_ms = median_ms(lambda: plan.execute(a, a, engine="fused"),
                         CAL_REPS)
    print(json.dumps({"calibration_guard": dict(
        default=guard, tuned=fast.STREAM_MAX_PRODUCTS, applied=applied,
        matrix=GUARDED_MATRIX, stream_limit=plan.stream_limit,
        stream_cached=stats["stream_cached"], fused_ms=fused_ms,
        transient_fused_ms=TRANSIENT_FUSED_MS)}), flush=True)
    fast.STREAM_MAX_PRODUCTS = guard
    profile.set_profile(profile.default_profile())
    del plan
    plan_cache_clear()   # iprob's plan and views go back to the card
    gc.collect()
    torch.cuda.empty_cache()
    print(f"calibration: profile {prof.tag} fitted "
          f"{len(prof.fitted)} constants in {cal_s:.1f} s; rank correlation "
          f"torch {rho['torch']:.3f}, host {rho['host']:.3f}; the guard "
          f"restored to {guard} and the default profile reinstalled; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


# about 2.5 ms on the card: time for the host to queue a timed loop
QUEUE_CYCLES = 5_000_000


def event_ms(fn, reps: int, warmup: int = 1, per_call: bool = False,
             queued: bool = True, queue_cycles: int = QUEUE_CYCLES) -> float:
    """Mean device time of ``fn`` per call, by CUDA events around a loop of
    ``reps`` calls.  ``queued``: the loop is queued behind a device-side
    wait (``torch.cuda._sleep`` of ``queue_cycles``, long enough for the
    host to queue the loop), so the card runs the calls back to back
    and a call shorter than its host-side launch (a Python wrapper's checks
    take tens of microseconds) is timed by the card, not by the host's pace;
    not ``queued``, the host's pace counts as well.  With ``per_call``, the
    median over ``reps`` calls of the time from an event just before one
    call to one just after it (the card's busy time plus any gap between
    the call's kernels)."""
    import torch

    for _ in range(warmup):
        fn()
    if per_call:
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop))
        return statistics.median(samples)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(queue_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_syncs(fn) -> int:
    """How many times ``fn`` made the host wait for the card, as PyTorch's
    sync debug mode reports them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def torch_csr(a, dev):
    import scipy.sparse as sps
    import torch
    from repro_torch.sparse.format import _np

    s = sps.csc_matrix((_np(a.values), _np(a.row_indices), _np(a.col_ptr)),
                       shape=a.shape).tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(s.indptr.astype(np.int64)),
        torch.from_numpy(s.indices.astype(np.int64)),
        torch.from_numpy(s.data.astype(np.float32)), size=s.shape,
        device=dev)


def group_work(kind, op):
    """(products, bytes) one launch needs: each B entry and each referenced
    A column read once, the output tiles written once.  A batched launch
    (values [B, n, Z]) reads the shared rows, counts and trip counts once
    and B values per entry, and writes B tiles."""
    import torch

    a_rows, a_vals, a_nnz, b_rows, _, b_nnz = op["ab"]
    batch = a_vals.shape[0] if a_vals.dim() == 3 else 1
    n_b, zb = b_rows.shape
    live = torch.arange(zb, device=b_rows.device)[None, :] < b_nnz[:, None]
    ks = b_rows[live].long()
    # SPARS takes a step on an empty A column too
    per_col = a_nnz.clamp(min=1) if kind == "spars" else a_nnz
    products = int(per_col[ks].sum())
    ref_cols = torch.unique(ks)
    per_entry = 4 + 4 * batch   # its row once, its value in every element
    a_bytes = int(a_nnz[ref_cols].sum()) * per_entry + len(ref_cols) * 4
    b_bytes = int(live.sum()) * per_entry + n_b * 4
    if kind == "spa":
        out_bytes = batch * op["m"] * n_b * 4
    elif kind == "spars":
        out_bytes = batch * 2 * op["m"] * n_b * 4 + 4 * (n_b // op["block"])
    else:
        out_bytes = batch * 2 * op["h"] * n_b * 4 + 4 * (n_b // op["block"])
    return batch * products, a_bytes + b_bytes + out_bytes


def bound_ms(products, nbytes):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * products / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def spa_library_operands(op):
    """(sparse CSR A, dense B columns) of one SPA launch's operands, for
    ``torch.sparse.mm``."""
    import torch

    a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz = op["ab"]
    n_a, za = a_rows.shape
    n_b, zb = b_rows.shape
    dev = a_vals.device
    a_live = torch.arange(za, device=dev)[None, :] < a_nnz[:, None]
    a_cols = torch.arange(n_a, device=dev)[:, None].expand(n_a, za)
    a_csr = torch.sparse_coo_tensor(
        torch.stack([a_rows[a_live].long(), a_cols[a_live]]), a_vals[a_live],
        (op["m"], n_a)).coalesce().to_sparse_csr()
    b_live = torch.arange(zb, device=dev)[None, :] < b_nnz[:, None]
    b_dense = torch.zeros((n_a, n_b), dtype=torch.float32, device=dev)
    lanes = torch.arange(n_b, device=dev)[:, None].expand(n_b, zb)
    b_dense.index_put_((b_rows[b_live].long(), lanes[b_live]), b_vals[b_live],
                       accumulate=True)
    return a_csr, b_dense


def library_ms(kind, op, reps, queued=True):
    """One PyTorch call computing the group's C columns: the sparse A times
    the group's dense B columns (``torch.sparse.mm``), checked first against
    the kernel's output turned dense (SPA's tile, SPARS's accumulator tile,
    HASH's tables through ``hash_tables_to_dense``).  It yields the C
    columns in another layout than SPARS's (no flags) and HASH's (no
    tables).  For a batched launch, that call once per value set."""
    import torch
    from repro_torch.kernels.ref import hash_tables_to_dense

    out = run_kernel(kind, op)
    if op["ab"][1].dim() == 3:
        ops = [element_op(op, b) for b in range(op["ab"][1].shape[0])]
    else:
        ops = [op]
        out = tuple(x[None] for x in out)
    pairs = [spa_library_operands(o) for o in ops]
    for b, (a_csr, b_dense) in enumerate(pairs):
        want = (hash_tables_to_dense(out[0][b], out[1][b], op["m"])
                if kind == "hash" else out[0][b])
        check(torch.allclose(torch.sparse.mm(a_csr, b_dense), want),
              f"library call disagrees with {kind}'s C columns")
    return event_ms(lambda: [torch.sparse.mm(*p) for p in pairs], reps,
                    queued=queued)


def execute_ms(fn, reps):
    """Host-clock samples of ``fn`` ending in a synchronize, after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return samples


def timing_phase(plans, mats, plan_ms, dev, reps):
    import torch
    from repro_torch.core.planner import BLOCK_COLS
    from repro_torch.kernels import ops as kops

    runs = {"spa": kops.run_spa, "spars": kops.run_spars,
            "hash": kops.run_hash}
    biggest, medians, libs = {}, {}, {}
    for name in MATRICES:
        a = mats[name]
        a_dev = a.to(dev)
        a_csr = torch_csr(a, dev)
        lib = libs[name] = event_ms(lambda: torch.sparse.mm(a_csr, a_csr),
                                    reps)
        for method in METHODS:
            plan = plans[name, method]
            samples = execute_ms(lambda: plan.execute(a, a), reps)
            medians[name, method] = statistics.median(samples)
            syncs = host_syncs(lambda: plan.execute(a_dev, a_dev))
            per_kind = {}
            launches = {}
            for g, op in group_operands(plan, a):
                a_arrs, g_vals = op["ab"][:3], op["ab"][4]
                ms = event_ms(lambda: runs[g.kind](
                    g, a_arrs, g_vals, m=op["m"], block_cols=BLOCK_COLS),
                    reps=3)
                per_kind[g.kind] = per_kind.get(g.kind, 0.0) + ms
                launches[g.kind] = launches.get(g.kind, 0) + 1
                products, nbytes = group_work(g.kind, op)
                if products > biggest.get(g.kind, (0,))[0]:
                    biggest[g.kind] = (products, nbytes, name, method, g, op)
            print(json.dumps({
                "matrix": name, "method": method_name(method),
                "plan_ms": plan_ms[name, method],
                "execute_ms_median": statistics.median(samples),
                "execute_ms_min": min(samples), "host_syncs": syncs,
                "kernel_device_ms": per_kind, "launches": launches,
                "library_ms": lib}), flush=True)
    return biggest, medians, libs


def k1_work(view, x, y):
    """(products, bytes) one K1 replay needs: both index vectors (8 B a
    product), each element of x and y that the view gathers read once (in
    the forward view of A·A, x and y are one vector), the offsets and the
    output, each once.  A batched replay (x [B, n_x]) reads the indices and
    offsets once and gathers and writes B times."""
    import torch

    batch = x.shape[0] if x.dim() == 2 else 1
    if x.data_ptr() == y.data_ptr():
        gathered = torch.unique(torch.cat([view.idx_x, view.idx_y])).numel()
    else:
        gathered = (torch.unique(view.idx_x).numel()
                    + torch.unique(view.idx_y).numel())
    nbytes = (8 * view.n_products + 4 * (view.n_out + 1)
              + batch * (4 * gathered + 4 * view.n_out))
    return batch * view.n_products, nbytes


def profiled_device_ms(fn, n=3) -> float:
    """Device time (kernels and copies) per call of ``fn``, from
    torch.profiler, after one warm-up call."""
    return sum(device_profile(fn, n).values())


def idle_share(device_ms, wall_ms):
    """The share of ``wall_ms`` the card spent idle; None when the profiler
    recorded no device event at all (it sometimes drops a window's events,
    and a kernel did run), rather than an idle share of 1."""
    return max(0.0, 1 - device_ms / wall_ms) if device_ms > 0 else None


def device_profile(fn, n=3) -> dict:
    """Device time per call of ``fn`` by kernel or copy name, in ms, from
    torch.profiler, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels and copies only: an op's own row repeats its kernels' time
    return {e.key: device_us(e) / 1e3 / n for e in prof.key_averages()
            if e.device_type != DeviceType.CPU}


def fused_timing_phase(fplans, mats, dev, reps, naive_ms, libs):
    """Per matrix, the fused execute (views built, operands on the card)
    beside the default method's per-group execute and torch.sparse.mm, its
    host syncs (must be 0) and K1's device time on each view; then iprob's
    fused execute under the default guard, which rebuilds the stream each
    time.  Returns, per view, the largest (products) view timed."""
    import torch
    from repro_torch.core import cached_plan, fused_stream

    biggest = {}
    for name in MATRICES:
        f = fplans[name]
        plan = f["plan"]
        a = mats[name]
        a_dev = a.to(dev)
        # operands on the host, as the per-group timing above, and on the
        # card, as a caller that keeps its values there
        samples = execute_ms(lambda: plan.execute(a, a, engine="fused"),
                             reps)
        on_card = execute_ms(
            lambda: plan.execute(a_dev, a_dev, engine="fused"), reps)
        syncs = host_syncs(lambda: plan.execute(a_dev, a_dev,
                                                engine="fused"))
        check(syncs == 0, f"{name}: a fused execute on the card made "
              f"{syncs} host syncs")
        device_ms = profiled_device_ms(
            lambda: plan.execute(a_dev, a_dev, engine="fused"))
        fs = fused_stream(plan)
        v = a_dev.values
        g = torch.ones(fs.forward.n_out, dtype=torch.float32, device=dev)
        k1_ms = {}
        for vname, view, x in (("forward", fs.forward, v),
                               ("grad_a", fs.grad_a, g),
                               ("grad_b", fs.grad_b, g)):
            k1_ms[vname] = event_ms(lambda: run_k1(view, x, v), reps)
            if view.n_products > biggest.get(vname, (0,))[0]:
                biggest[vname] = (view.n_products, name, view, x, v)
        print(json.dumps({
            "matrix": name, "engine": "fused",
            "stream_limit": plan.stream_limit,
            "guard_raised_above_default": f["guard_raised"],
            "products": f["products"], "plan_ms": f["plan_ms"],
            "view_build_ms": f["view_build_ms"],
            "execute_ms_median": statistics.median(samples),
            "execute_ms_min": min(samples),
            "execute_on_card_ms_median": statistics.median(on_card),
            # of one execute on the card, from the profiler's device time
            "device_ms": device_ms,
            "device_idle_share": idle_share(device_ms,
                                            statistics.median(on_card)),
            "host_syncs": syncs, "k1_device_ms": k1_ms,
            "naive_execute_ms_median": naive_ms[name, DEFAULT],
            "library_ms": libs[name]}), flush=True)
    a = mats[GUARDED_MATRIX]
    plan = cached_plan(a, a)
    samples = execute_ms(lambda: plan.execute(a, a, engine="fused"), reps=3)
    print(json.dumps({
        "matrix": GUARDED_MATRIX, "engine": "fused", "path": "transient",
        "stream_limit": plan.stream_limit,
        "execute_ms_median": statistics.median(samples),
        "execute_ms_min": min(samples)}), flush=True)
    return biggest


def torch_timing_phase(tplans, fplans, mats, dev, reps):
    """Per matrix, the torch stream's execute beside the fused engine's, on
    operands on the card and on the host (host clock, median of
    ``reps``), with the plan and lift times, the profiler's device time and
    idle share of one on-card execute, its device operations, and a batched
    execute (B = BATCH, card operands) per multiply against a looped one."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    for name in MATRICES:
        t = tplans[name]
        plan, fplan = t["plan"], fplans[name]["plan"]
        a = mats[name]
        a_dev = a.to(dev)
        on_card = execute_ms(lambda: plan.execute(a_dev, a_dev), reps)
        on_host = execute_ms(lambda: plan.execute(a, a), reps)
        fused = execute_ms(
            lambda: fplan.execute(a_dev, a_dev, engine="fused"), reps)
        device_ms = profiled_device_ms(lambda: plan.execute(a_dev, a_dev))
        xs = torch.randn((BATCH, a.nnz), generator=gen, device=dev)
        t_b = statistics.median(execute_ms(
            lambda: plan.execute_batched(xs, xs), reps))
        t_l = statistics.median(execute_ms(
            lambda: [plan.execute(xs[b], xs[b]) for b in range(BATCH)],
            reps))
        print(json.dumps({
            "matrix": name, "engine": "torch",
            "stream_limit": plan.stream_limit,
            "guard_raised_above_default": t["guard_raised"],
            "products": plan.stream.n_products, "plan_ms": t["plan_ms"],
            "lift_ms": t["lift_ms"],
            "device_stream_bytes": plan.device_stream_nbytes,
            "execute_on_card_ms_median": statistics.median(on_card),
            "execute_on_card_ms_min": min(on_card),
            "execute_ms_median": statistics.median(on_host),
            "fused_execute_on_card_ms_median": statistics.median(fused),
            "device_ms": device_ms,
            "device_idle_share": idle_share(device_ms,
                                            statistics.median(on_card)),
            "device_ops_per_execute": device_ops(
                lambda: plan.execute(a_dev, a_dev)),
            "batched_ms_per_multiply": t_b / BATCH,
            "looped_ms_per_multiply": t_l / BATCH,
            "looped_over_batched": t_l / t_b}), flush=True)


def segment_path_timing(tplans, fplans, mats, dev, reps):
    """At the largest stream (iprob's forward view: 9.0M products, mostly
    one a slot), the device time of the torch stream's 1-D segmented sum
    beside ``torch.segment_reduce``'s ``[1, P]`` (``axis=1``) path on the
    same products, and whether each equals K1's sums bit for bit (real
    values)."""
    import torch
    from repro_torch.core import device_stream

    name = max(MATRICES, key=lambda n: tplans[n]["plan"].stream.n_products)
    view = device_stream(tplans[name]["plan"]).forward
    v = real_valued(mats[name], 0).values.to(dev)
    prod = v.index_select(0, view.idx_x) * v.index_select(0, view.idx_y)
    lengths_2d = view.lengths[None]

    def flat():
        return torch.segment_reduce(prod, "sum", lengths=view.lengths,
                                    unsafe=True)

    def axis1():
        return torch.segment_reduce(prod[None], "sum", lengths=lengths_2d,
                                    axis=1, unsafe=True)

    k1 = fplans[name]["plan"].execute(v, v, engine="fused").values
    n = view.n_out
    print(json.dumps({
        "segment_reduce_paths": {
            "matrix": name, "view": "forward",
            "products": view.n_products, "segments": n,
            "flat_ms": event_ms(flat, reps),
            "axis1_ms": event_ms(axis1, reps),
            "flat_equals_k1": bool(torch.equal(bits(flat()[:n]), bits(k1))),
            "axis1_equals_k1": bool(torch.equal(bits(axis1()[0, :n]),
                                                bits(k1)))}}), flush=True)


def torch_stream_ms(tplans, name, vname, x, y, reps) -> float:
    """Device time of the torch stream's replay of view ``vname`` of
    ``name``'s stream on ``x``, ``y`` (several PyTorch calls: two gathers,
    a multiply and a segmented sum), the same function as K1's (or K1-b's)
    replay of that view."""
    from repro_torch.core import device_stream
    from repro_torch.core.device_stream import replay

    view = getattr(device_stream(tplans[name]["plan"], grads=True), vname)
    return event_ms(lambda: replay(view, x, y), reps)


def batched_timing_phase(stacks, fplans, dev, reps, syncs):
    """Per matrix, at B = BATCH with operands on the card: a batched
    execute per multiply against a looped one (the same plan executed once
    per value set), for the default method and the fused engine, with the
    profiler's device time and idle share of one batched execute."""
    from repro_torch.core import cached_plan

    for name in MATRICES:
        sa, sb = stacks[name]
        a_dev, b_dev = sa.to(dev), sb.to(dev)
        line = {"matrix": name, "batch": BATCH, "operands": "card"}
        for run, plan in ((DEFAULT, cached_plan(sa[0], sb[0])),
                          ("fused", fplans[name]["plan"])):
            engine = "fused" if run == "fused" else None

            def batched():
                return plan.execute_batched(a_dev, b_dev, engine=engine)

            def looped():
                return [plan.execute(a_dev[b], b_dev[b], engine=engine)
                        for b in range(BATCH)]

            t_b = statistics.median(execute_ms(batched, reps))
            t_l = statistics.median(execute_ms(looped, reps))
            by_name = device_profile(batched)
            device_ms = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            line["naive" if engine is None else "fused"] = {
                "batched_ms_per_multiply": t_b / BATCH,
                "looped_ms_per_multiply": t_l / BATCH,
                "looped_over_batched": t_l / t_b,
                "batched_execute_ms": t_b,
                "device_ms": device_ms,
                "device_idle_share": idle_share(device_ms, t_b),
                # the three largest device entries, name cut to 60 chars
                "device_top_ms": {k[:60]: v for k, v in top},
                "host_syncs": syncs[name, run]}
        print(json.dumps(line), flush=True)


def host_paced(kind, op, reps) -> dict:
    """K2's and K3's (and their batched forms') time and their library
    call's with the host's pace counted as well (``event_ms(queued=False)``),
    as this script timed every kernel before it queued its loops."""
    if kind not in ("spa", "spars"):
        return {}
    return dict(ms_host_paced=event_ms(lambda: run_kernel(kind, op), reps,
                                       queued=False),
                library_ms_host_paced=library_ms(kind, op, reps,
                                                 queued=False))


def kernel_report(biggest, plans, mats, counts, errs, edge_tiers, seed,
                  reps):
    """The rows of K2-K4, each timed at its largest main-path group; K2 also
    held against its plain version there on real values; K4's with its
    launches per table tier on the main path and in the edge cases."""
    import torch

    rows = []
    for kind in GROUP_KERNELS:
        info = KERNELS[kind]
        check(kind in biggest, f"{kind}: no main-path group to time")
        products, nbytes, name, method, g, op = biggest[kind]
        err = errs[kind]
        if kind == "spa":
            (_, real_op), = group_operands(
                plans[name, method], real_valued(mats[name], seed), [g])
            err = max(err, compare(kind, real_op, f"{name} "
                                   f"{method_name(method)} timed group, "
                                   "real values"))
        ms = event_ms(lambda: run_kernel(kind, op), reps)
        plain = event_ms(lambda: run_plain(kind, op), reps=2)
        b_ms, by = bound_ms(products, nbytes)
        tiers = {} if kind != "hash" else dict(
            launches_by_tier=counts["hash_spgemm_by_tier"],
            edge_launches_by_tier=edge_tiers)
        rows.append(dict(
            info, launches=counts[info["name"]], max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=library_ms(kind, op, reps),
            **host_paced(kind, op, reps), **tiers,
            at=dict(matrix=name, method=method_name(method),
                    cols=len(g.cols), products=products, bytes=nbytes,
                    h=g.h)))
        torch.cuda.synchronize()
    return rows


def grad_library_ms(plan, a, vname, g, v, got, reps):
    """The time of the one PyTorch call that computes K1's gradient view
    ``vname`` of C = A·A (B = A): with G the cotangent ``g`` as a dense [m,
    n], grad_a = G·Bᵀ sampled at A's pattern and grad_b = Aᵀ·G sampled at
    B's, each ``torch.sparse.sampled_addmm`` (beta 0) of a CSR pattern and
    two dense operands.  Checked first against K1's output ``got`` at the
    view's positions, within 1e-5 of its largest magnitude (the order of
    the sums differs)."""
    import scipy.sparse as sps
    import torch
    from repro_torch.core import fused_stream
    from repro_torch.sparse.format import _np

    fs = fused_stream(plan)
    view = getattr(fs, vname)
    dev = v.device
    cp, ri = _np(a.col_ptr), _np(a.row_indices)
    # A's slots in CSR order, each holding its position in A's values
    csr = sps.csc_matrix((np.arange(a.nnz), ri, cp), shape=a.shape).tocsr()
    perm, crow, col = (torch.from_numpy(x.astype(np.int64)).to(dev)
                       for x in (csr.data, csr.indptr, csr.indices))
    pattern = torch.sparse_csr_tensor(crow, col, v[perm], size=a.shape)
    dense_a = pattern.to_dense()
    c_cols = torch.repeat_interleave(
        torch.arange(fs.shape[1], device=dev),
        torch.diff(fs.c_col_ptr.long()))
    dense_g = torch.zeros(fs.shape, device=dev)
    dense_g[fs.c_rows.long(), c_cols] = g
    mats = ((dense_g, dense_a.t().contiguous()) if vname == "grad_a"
            else (dense_a.t().contiguous(), dense_g))

    def call():
        return torch.sparse.sampled_addmm(pattern, *mats, beta=0)

    full = torch.zeros(a.nnz, device=dev)
    full[perm] = call().values()
    check(torch.allclose(full[view.out_map], got, rtol=1e-5,
                         atol=1e-5 * float(got.abs().max())),
          f"sampled_addmm disagrees with K1's {vname} view")
    return event_ms(call, reps)


def k1_chain(view) -> dict:
    """The view's long slots (a warp each in K1) and its longest slot, whose
    products one lane adds one after another, counted from the view."""
    import torch

    longest = int(torch.diff(view.seg_ptr).max()) if view.n_out else 0
    return dict(long_slots=int(view.long_slots.numel()),
                longest_slot=longest)


def k1_report(biggest, launches, err, libs, fplans, tplans, mats, reps):
    """K1's row of the kernels line: timed at its largest forward view,
    with the largest gradient views beside it, each beside the one PyTorch
    call that computes its function: torch.sparse.mm(A, A) for the forward
    view, torch.sparse.sampled_addmm for the gradient views
    (``grad_library_ms``); and beside the torch stream's replay of the same
    view (``torch_stream_ms``, several PyTorch calls)."""
    import torch

    timed = {}
    for vname in ("forward", "grad_a", "grad_b"):
        check(vname in biggest, f"fused_stream: no {vname} view to time")
        products, name, view, x, y = biggest[vname]
        ms = event_ms(lambda: run_k1(view, x, y), reps)
        plain = event_ms(lambda: run_k1_plain(view, x, y), reps=2)
        work = k1_work(view, x, y)
        b_ms, by = bound_ms(*work)
        lib = libs[name] if vname == "forward" else grad_library_ms(
            fplans[name]["plan"], mats[name], vname, x, y,
            run_k1(view, x, y), reps)
        timed[vname] = dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
            library_ms=lib,
            torch_stream_ms=torch_stream_ms(tplans, name, vname, x, y, reps),
            **k1_chain(view),
            at=dict(matrix=name, view=vname, products=products,
                    segments=view.n_out, bytes=work[1]))
        torch.cuda.synchronize()
    fwd = timed.pop("forward")
    return dict(KERNELS["fused"], launches=launches, max_abs_err=err,
                **fwd, grad_views=timed)


def batched_kernel_report(biggest, k1_biggest, plans, tplans, stacks,
                          counts, grad_counts, errs, edge_tiers, dev, seed,
                          reps):
    """The rows of K1-b … K4-b: each timed at B = BATCH on its unbatched
    kernel's largest main-path group or view, with that matrix's value
    stacks; the plain versions once (at iprob they take seconds); the
    library call is the unbatched row's, once per value set.  K2-b is also
    held against its plain version there on B = BATCH real value sets."""
    import torch
    from repro_torch import kernels

    rows = []
    for kind in GROUP_KERNELS:
        info = KERNELS[kind + "_b"]
        _, _, name, method, g, _ = biggest[kind]
        sa, sb = stacks[name]
        (_, op), = batched_group_operands(plans[name, method], sa.values,
                                          sb.values, [g])
        err = errs[kind]
        if kind == "spa":
            rng = np.random.default_rng([seed, 2])
            ra, rb = (torch.from_numpy(rng.standard_normal(
                tuple(s.values.shape)).astype(np.float32)) for s in (sa, sb))
            (_, real_op), = batched_group_operands(plans[name, method], ra,
                                                   rb, [g])
            err = max(err, compare(kind, real_op, f"{name} "
                                   f"{method_name(method)} timed group, "
                                   f"B = {BATCH} real value sets"))
        ms = event_ms(lambda: run_kernel(kind, op), reps)
        plain = event_ms(lambda: run_plain(kind, op), reps=1, warmup=0)
        products, nbytes = group_work(kind, op)
        b_ms, by = bound_ms(products, nbytes)
        tiers = {} if kind != "hash" else dict(
            launches_by_tier=counts["hash_spgemm_batched_by_tier"],
            edge_launches_by_tier=edge_tiers)
        rows.append(dict(
            info, launches=counts[info["name"]], max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
            library_ms=library_ms(kind, op, reps),
            **host_paced(kind, op, reps), **tiers,
            at=dict(matrix=name, method=method_name(method), batch=BATCH,
                    cols=len(g.cols), products=products, bytes=nbytes,
                    h=g.h)))
        torch.cuda.synchronize()
    _, name, view, _, _ = k1_biggest["forward"]
    sa, sb = stacks[name]
    x, y = sa.values.to(dev), sb.values.to(dev)
    ms = event_ms(lambda: run_k1b(view, x, y), reps)
    plain = event_ms(lambda: run_k1_plain(view, x, y, batched=True), reps=1,
                     warmup=0)
    products, nbytes = k1_work(view, x, y)
    b_ms, by = bound_ms(products, nbytes)
    csrs = [(torch_csr(sa[b], dev), torch_csr(sb[b], dev))
            for b in range(BATCH)]
    lib = event_ms(lambda: [torch.sparse.mm(*p) for p in csrs], reps)
    info = KERNELS["fused_b"]
    by_path = {"batched": counts[info["name"]],
               "stacked_backward": grad_counts[info["name"]]}
    rows.insert(0, dict(
        info, launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=errs["fused"],
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib,
        torch_stream_ms=torch_stream_ms(tplans, name, "forward", x, y, reps),
        **k1_chain(view),
        at=dict(matrix=name, view="forward", batch=BATCH,
                products=products, segments=view.n_out, bytes=nbytes)))
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# the sparse FFN serving policy (K5, K5-b) at granite-20b's full FFN width
# ---------------------------------------------------------------------------

FFN_ARCH = "granite-20b"
FFN_KEEPS = {0.9: "dense", 0.25: "bsr"}   # keep_density -> the policy's path
FFN_T_DENSITY = 0.75   # SparseFFN.from_params' own switch
FFN_BLOCK = 8          # bm = bk, the reference's default
FFN_MATRICES = ("gate", "up", "down")
PREFILL_TOKENS = 2048  # one prefill of 2048 tokens
FFN_BATCH, FFN_BATCH_TOKENS = 8, 128   # 8 sequences of 128 tokens: K5-b
FFN_TOL = 1e-5         # normwise relative error against f64, real values
BSR_SLICE = 128        # columns of x in the kernel phase's full-width cases


def rel_err(got, want) -> float:
    """Normwise relative error of ``got`` against the f64 ``want``."""
    return float((got.double() - want).norm() / want.norm())


def int_values(shape, gen, dev):
    """f32 values in {-2 ... 2} on the card: at granite's widths every sum
    of products stays below 2^24 (at most 4 * 24576), so f32 holds it
    exactly in any order."""
    import torch

    return torch.randint(-2, 3, shape, generator=gen, device=dev,
                         dtype=torch.int8).float()


def ffn_setup(dev, seed):
    """granite-20b's FFN at full width from ``seed``: the params through the
    port's ``init_params`` (``fan_in``, as ``ffn_table``), the real-valued
    activations of the prefill [T, D] and the batch [B, T, D], and per
    keep_density the SparseFFN as a user converts it (timed), each matrix's
    pruned weight from ``prune_blocks`` (the oracle's), and an
    integer-valued SparseMatmul on the same kept blocks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import SparseFFN, SparseMatmul, ffn_table, \
        init_params, prune_blocks

    cfg = get_config(FFN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(ffn_table(cfg), gen, device=dev)
    host = {name: params[name]["w"].T.cpu().numpy() for name in FFN_MATRICES}
    d = cfg.d_model
    data = dict(cfg=cfg, params=params, gen=gen, ffns={}, pruned={},
                ints={}, conversion_s={}, acts=dict(
                    prefill=torch.randn((PREFILL_TOKENS, d), generator=gen,
                                        device=dev),
                    batched=torch.randn((FFN_BATCH, FFN_BATCH_TOKENS, d),
                                        generator=gen, device=dev)))
    for keep, path in FFN_KEEPS.items():
        t0 = time.perf_counter()
        sp = SparseFFN.from_params(params, keep_density=keep,
                                   t_density=FFN_T_DENSITY, device=dev)
        torch.cuda.synchronize()
        data["conversion_s"][keep] = time.perf_counter() - t0
        data["ffns"][keep] = sp
        for name in FFN_MATRICES:
            m = getattr(sp, name)
            label = f"{FFN_ARCH} {name} keep {keep}"
            check(m.path == path, f"{label}: path {m.path}, not {path}")
            w_p, density = prune_blocks(host[name], FFN_BLOCK, FFN_BLOCK,
                                        keep)
            check(density == m.density, f"{label}: density {m.density} vs "
                  f"prune_blocks' {density}")
            data["pruned"][keep, name] = w_p
            vals = int_values(w_p.shape, gen, dev).cpu().numpy()
            w_int = np.where(w_p != 0, vals, np.float32(0))
            mi = SparseMatmul.from_dense(
                w_int, bm=FFN_BLOCK, bk=FFN_BLOCK, keep_density=keep,
                t_density=FFN_T_DENSITY, device=dev)
            check(mi.path == path and mi.density == density
                  and (path == "dense" or (
                      torch.equal(mi.block_nnz, m.block_nnz)
                      and torch.equal(mi.block_idx, m.block_idx))),
                  f"{label}: the integer-valued weight pruned to other "
                  "blocks")
            data["ints"][keep, name] = (mi, w_int)
    print(f"sparse FFN: {FFN_ARCH} (d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}) converted at keep_density "
          f"{json.dumps({str(k): v for k, v in FFN_KEEPS.items()})} in "
          f"{json.dumps({str(k): v for k, v in data['conversion_s'].items()})}"
          " s", flush=True)
    return data


def bsr_ops(m):
    return m.block_idx, m.block_nnz, m.blocks


EDGE_K = 320   # columns of the edge cases' weights (rows of their x)


def bsr_edge_cases(dev):
    """(label, BSR operands, N) of the K5 edge cases, each weight
    [192, EDGE_K]: every block-row empty,
    a few block-rows empty, one block-row far longer than the rest (the
    others padded to its max_nb), 8x16 and 16x16 blocks, a column count
    that is not a multiple of the kernel's column tile, and 8x8 blocks on
    132 columns (the 128-column instance, its second tile 4 wide) and on
    130 (the generic instance)."""
    import torch
    from repro_torch.kernels import bsr_from_dense
    from repro_torch.models import prune_blocks

    rng = np.random.default_rng(5)

    def ops(w, bm, bk):
        return tuple(torch.from_numpy(a).to(dev)
                     for a in bsr_from_dense(w, bm, bk))

    w = rng.standard_normal((192, EDGE_K)).astype(np.float32)
    empty_rows = w.copy()
    empty_rows[16:48] *= 1e-3
    empty_rows, _ = prune_blocks(empty_rows, 8, 8, 0.3)
    long_row = np.zeros_like(w)
    long_row[8:16] = w[8:16]
    long_row[100:108, :16] = w[100:108, :16]
    yield "all_empty", ops(np.zeros_like(w), 8, 8), 256
    yield "empty_block_rows", ops(empty_rows, 8, 8), 256
    yield "max_nb_padding", ops(long_row, 8, 8), 256
    yield "blocks_8x16", ops(prune_blocks(w, 8, 16, 0.4)[0], 8, 16), 256
    yield "blocks_16x16", ops(prune_blocks(w, 16, 16, 0.4)[0], 16, 16), 200
    yield "blocks_8x8_n132", ops(prune_blocks(w, 8, 8, 0.3)[0], 8, 8), 132
    yield "blocks_8x8_n130", ops(prune_blocks(w, 8, 8, 0.3)[0], 8, 8), 130


def compare_bsr(ops, xs, label):
    """K5 on xs[0] and K5-b on xs [B, K, N] against their plain versions
    on the same tensors, exactly; the batched slices against K5; returns
    (max |difference| of K5, of K5-b)."""
    import torch
    from repro_torch import kernels

    bn = xs.shape[2]
    got = kernels.bsr_spmm(*ops, xs[0], bn=bn)
    torch.cuda.synchronize()
    want = kernels.bsr_spmm_plain(*ops, xs[0])
    check(got.shape == want.shape and torch.equal(got, want),
          f"bsr_spmm {label}: kernel != plain version")
    got_b = kernels.bsr_spmm_batched(*ops, xs, bn=bn)
    torch.cuda.synchronize()
    want_b = kernels.bsr_spmm_batched_plain(*ops, xs)
    check(got_b.shape == want_b.shape and torch.equal(got_b, want_b),
          f"bsr_spmm_batched {label} B = {xs.shape[0]}: kernel != plain "
          "version")
    for b in range(xs.shape[0]):
        check(torch.equal(got_b[b], got if b == 0 else kernels.bsr_spmm(
            *ops, xs[b], bn=bn)), f"bsr_spmm_batched {label}: slice {b} != "
            "bsr_spmm")
    return (float((got - want).abs().max()) if got.numel() else 0.0,
            float((got_b - want_b).abs().max()) if got_b.numel() else 0.0)


def bsr_kernel_phase(data, dev):
    """K5 and K5-b against their plain versions, bit for bit, on real and
    integer values: the full-width gate and down matrices of the bsr path
    on a 128-column slice of x (B = 1 and B = 8), and the edge cases."""
    import torch

    keep = next(k for k, path in FFN_KEEPS.items() if path == "bsr")
    gen = data["gen"]
    errs, n = [0.0, 0.0], 0
    cases = []
    for name in ("gate", "down"):
        m = getattr(data["ffns"][keep], name)
        mi, _ = data["ints"][keep, name]
        k_dim = m.shape[1]
        cases.append((f"{name} keep {keep}, real", bsr_ops(m), torch.randn(
            (FFN_BATCH, k_dim, BSR_SLICE), generator=gen, device=dev)))
        cases.append((f"{name} keep {keep}, integer", bsr_ops(mi), int_values(
            (FFN_BATCH, k_dim, BSR_SLICE), gen, dev)))
    for label, ops, n_cols in bsr_edge_cases(dev):
        k_dim = EDGE_K
        for kind, xs in (("real", torch.randn((FFN_BATCH, k_dim, n_cols),
                                              generator=gen, device=dev)),
                         ("integer", int_values((FFN_BATCH, k_dim, n_cols),
                                                gen, dev))):
            cases.append((f"{label}, {kind}", ops, xs))
    for label, ops, xs in cases:
        for batch in (1, FFN_BATCH):
            e = compare_bsr(ops, xs[:batch], label)
            errs = [max(a, b) for a, b in zip(errs, e)]
            n += 1
    for name, err in zip(("bsr_spmm", "bsr_spmm_batched"), errs):
        print(f"kernel {name}: {n} comparisons with the plain version "
              f"(B = 1 and {FFN_BATCH}), max |diff| {err}", flush=True)


def ffn_path(data):
    """Drive SparseFFN as a user serves with it, at full width: one prefill
    [T, D] and one batch [B, T, D] per keep_density, with the counts set to
    0 just before and read just after; each call's launches must be three
    K5 (prefill) or three K5-b (batch) on the bsr path and none on the
    dense path."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    out, launches = {}, {}
    for keep, sp in data["ffns"].items():
        for shape, x in data["acts"].items():
            before = kernels.launch_counts()
            out[keep, shape] = sp(x)
            after = kernels.launch_counts()
            launches[keep, shape] = {k: v - before[k] for k, v in after.items()
                                     if v > before[k]}
    counts = kernels.launch_counts()
    print(f"sparse FFN path: {FFN_ARCH} prefill {PREFILL_TOKENS} tokens and "
          f"a batch of {FFN_BATCH} x {FFN_BATCH_TOKENS} at keep_density "
          f"{sorted(FFN_KEEPS)}; launches "
          f"{json.dumps({f'{k} {s}': v for (k, s), v in launches.items()})}",
          flush=True)
    for (keep, shape), got in launches.items():
        name = "bsr_spmm" if shape == "prefill" else "bsr_spmm_batched"
        want = {name: 3} if FFN_KEEPS[keep] == "bsr" else {}
        check(got == want, f"sparse FFN keep {keep} {shape}: launches {got}, "
              f"expected {want}")
    for name in ("bsr_spmm", "bsr_spmm_batched"):
        check(counts[name] > 0, f"{name} was not launched on the FFN path")
    return out, counts


def pruned_params64(data, keep, dev):
    """The pruned FFN params in f64 on the card (``ffn_table``'s
    orientation), for the oracle."""
    import torch

    return {name: {"w": torch.from_numpy(data["pruned"][keep, name]).to(
        dev, torch.float64).T} for name in FFN_MATRICES}


def check_ffn_path(data, out, dev):
    """Every FFN output of the path is finite, of its input's shape, and
    within FFN_TOL normwise of ``ffn`` on the pruned weights in f64."""
    from repro_torch.models import ffn

    errs = {}
    for keep in FFN_KEEPS:
        p64 = pruned_params64(data, keep, dev)
        for shape, x in data["acts"].items():
            got = out[keep, shape]
            label = f"sparse FFN keep {keep} {shape}"
            check(got.shape == x.shape and got.isfinite().all(),
                  f"{label}: shape {tuple(got.shape)} or non-finite values")
            errs[keep, shape] = rel_err(got, ffn(p64, x.double()))
            check(errs[keep, shape] <= FFN_TOL, f"{label}: normwise error "
                  f"{errs[keep, shape]} against the f64 pruned FFN")
        del p64
    print("sparse FFN path: every output within "
          f"{FFN_TOL} of the f64 pruned-dense FFN; errors "
          f"{json.dumps({f'{k} {s}': v for (k, s), v in errs.items()})}",
          flush=True)
    return errs


def check_ffn_matmuls(data, dev):
    """Each SparseMatmul on its own, prefill width and batched: on integer
    weights and activations every output equals the f64 product of the
    pruned weight exactly; on real ones it is within FFN_TOL normwise."""
    import torch

    gen = data["gen"]
    errs = {}
    for keep, path in FFN_KEEPS.items():
        for name in FFN_MATRICES:
            m = getattr(data["ffns"][keep], name)
            mi, w_int = data["ints"][keep, name]
            k_dim = m.shape[1]
            label = f"{FFN_ARCH} {name} keep {keep} ({path})"
            w64 = torch.from_numpy(data["pruned"][keep, name]).to(
                dev, torch.float64)
            for shape in ((k_dim, PREFILL_TOKENS),
                          (FFN_BATCH, k_dim, FFN_BATCH_TOKENS)):
                run = m if len(shape) == 2 else m.batched
                x = torch.randn(shape, generator=gen, device=dev)
                errs[keep, name, len(shape)] = e = rel_err(
                    run(x), w64 @ x.double())
                check(e <= FFN_TOL, f"{label} {shape}: normwise error {e}")
            w64 = torch.from_numpy(w_int).to(dev, torch.float64)
            for shape in ((k_dim, PREFILL_TOKENS),
                          (FFN_BATCH, k_dim, FFN_BATCH_TOKENS)):
                run = mi if len(shape) == 2 else mi.batched
                x = int_values(shape, gen, dev)
                check(torch.equal(run(x).double(), w64 @ x.double()),
                      f"{label} {shape}: integer values differ from the f64 "
                      "product")
            del w64
    print(f"sparse FFN matmuls: {len(errs)} real-valued products within "
          f"{FFN_TOL} normwise (largest {max(errs.values())}), every "
          "integer-valued one equal to the f64 product", flush=True)
    return errs


def ffn_operands(sp, inp):
    """(name, SparseMatmul, operand) of the three matmuls that ``sp(inp)``
    runs, on the operands it gives them: x^T and h = silu(gate) * up,
    [D, T] and [F, T] for a prefill, [B, D, T] and [B, F, T] for a
    batch."""
    import torch

    xt = (inp.transpose(1, 2) if inp.dim() == 3 else inp.T).contiguous()
    h = torch.nn.functional.silu(matmul(sp.gate, xt)) * matmul(sp.up, xt)
    return list(zip(FFN_MATRICES, (sp.gate, sp.up, sp.down), (xt, xt, h)))


def matmul(m, a):
    """``m`` on ``a [K, N]``, or batched on ``a [B, K, N]``, as SparseFFN
    calls it."""
    return m.batched(a) if a.dim() == 3 else m(a)


def ffn_timing_phase(data, reps):
    """Per keep_density: conversion s, the FFN forward (prefill and batch,
    median of ``reps``, ending in a synchronize), its device span and idle
    share by CUDA events, each matmul's device time (CUDA events: K5 / K5-b
    on the bsr path, the f32 matmul on the dense path), the flop savings
    and the relative error against the unpruned FFN."""
    from repro_torch.models import ffn

    cfg, params = data["cfg"], data["params"]
    x, xs = data["acts"]["prefill"], data["acts"]["batched"]
    unpruned = {"prefill": ffn(params, x), "batched": ffn(params, xs)}
    dense_flops = 3 * 2 * cfg.d_model * cfg.d_ff
    lines = {}
    for keep, sp in data["ffns"].items():
        line = {"arch": FFN_ARCH, "keep_density": keep,
                "path": sp.gate.path, "density": sp.gate.density,
                "conversion_s": data["conversion_s"][keep]}
        for shape, inp in (("prefill", x), ("batched", xs)):
            forward = statistics.median(execute_ms(lambda: sp(inp), reps))
            span = event_ms(lambda: sp(inp), reps, per_call=True)
            y = sp(inp)
            mats = ffn_operands(sp, inp)
            line[shape] = {
                "shape": list(inp.shape),
                "forward_ms_median": forward,
                "device_span_ms": span,
                "device_idle_share": max(0.0, 1 - span / forward),
                "rel_err_vs_unpruned": float(
                    (y - unpruned[shape]).norm() / unpruned[shape].norm()),
                "matmul_device_ms": {
                    name: event_ms(lambda: matmul(m, a), reps)
                    for name, m, a in mats}}
            del mats
        line["flop_savings"] = dense_flops / sp.flops_per_token
        lines[keep] = line
        print(json.dumps(line), flush=True)
    return lines


def bsr_work(m, x):
    """(multiply-adds, bytes) one K5 launch needs on ``x [K, N]`` (or
    ``[B, K, N]``): the kept blocks, their indices and the counts read
    once, x read once and the output written once; bm * bk multiply-adds
    per kept block, column and activation set."""
    batch = x.shape[0] if x.dim() == 3 else 1
    kept = int(m.block_nnz.sum())
    bm, bk = m.blocks.shape[2:]
    n = x.shape[-1]
    nbytes = (kept * (bm * bk + 1) * 4 + m.block_nnz.numel() * 4
              + x.numel() * 4 + batch * m.shape[0] * n * 4)
    return batch * kept * bm * bk * n, nbytes


def bsr_kernel_report(data, counts, dev, reps):
    """The rows of K5 and K5-b.  Each kernel is held against its plain
    version, bit for bit, on the operands the FFN path gives it on the bsr
    path: gate's x^T and down's h, [D, T] and [F, T] for K5 (the prefill),
    [B, D, T] and [B, F, T] for K5-b (the batch); the row's max_abs_err is
    the larger of the two.  Each is timed on gate's operand, the plain
    version once; ``exact_order_bound_ms`` is the bound with two
    instructions a product (``__fmul_rn`` and ``__fadd_rn``, the order
    that the kernel and its plain version share), ``at.layout`` the
    launch's shape.  The library call is ``torch.matmul`` of the pruned dense
    weight (f32, full precision); the K5-b row also times the BSR-tensor
    product ``w.to_sparse_bsr((8, 8)) @ x`` once per activation set (at the
    prefill's N = 2048 that product asks for more than the card's memory
    beside the FFN).  The port never calls either."""
    import torch
    from repro_torch import kernels

    keep = next(k for k, path in FFN_KEEPS.items() if path == "bsr")
    sp = data["ffns"][keep]
    m = sp.gate
    w = torch.from_numpy(data["pruned"][keep, "gate"]).to(dev)
    w_bsr = w.to_sparse_bsr((FFN_BLOCK, FFN_BLOCK))
    rows = []
    for kind, shape in (("bsr", "prefill"), ("bsr_b", "batched")):
        info = KERNELS[kind]
        fn, plain = ((kernels.bsr_spmm, kernels.bsr_spmm_plain)
                     if kind == "bsr" else (kernels.bsr_spmm_batched,
                                            kernels.bsr_spmm_batched_plain))
        operands = {name: (bsr_ops(mat), a) for name, mat, a
                    in ffn_operands(sp, data["acts"][shape])
                    if name in ("gate", "down")}
        err = 0.0
        for name, (ops, a) in operands.items():
            got, want = fn(*ops, a), plain(*ops, a)
            check(torch.equal(got, want), f"{info['name']} on {name}'s "
                  f"{shape} operand {list(a.shape)}: kernel != plain version")
            err = max(err, float((got - want).abs().max()))
            del got, want
        ops, x = operands["gate"]
        del operands
        want = fn(*ops, x).double()
        check(rel_err(w @ x, want) <= FFN_TOL,
              f"{info['name']}: torch.matmul disagrees")
        lib_bsr_ms = None
        if x.dim() == 3:
            check(rel_err(torch.stack([w_bsr @ xb for xb in x]), want)
                  <= FFN_TOL, f"{info['name']}: the BSR-tensor product "
                  "disagrees")
            lib_bsr_ms = event_ms(lambda: [w_bsr @ xb for xb in x], reps)
        ms = event_ms(lambda: fn(*ops, x), reps)
        plain_ms = event_ms(lambda: plain(*ops, x), reps=1, warmup=0)
        products, nbytes = bsr_work(m, x)
        b_ms, by = bound_ms(products, nbytes)
        n_rb, _, bm, bk = m.blocks.shape
        rows.append(dict(
            info, launches=counts[info["name"]], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            exact_order_bound_ms=bound_ms(2 * products, nbytes)[0],
            library_ms=event_ms(lambda: w @ x, reps),
            library_bsr_tensor_ms=lib_bsr_ms,
            at=dict(arch=FFN_ARCH, matrix="gate", keep_density=keep,
                    shape=list(m.shape), x=list(x.shape),
                    kept_blocks=int(m.block_nnz.sum()),
                    max_nb=m.blocks.shape[1], multiply_adds=products,
                    bytes=nbytes, compared_on=["gate", "down"],
                    layout=kernels.bsr_layout(
                        n_rb, bm, bk, x.shape[-1],
                        x.shape[0] if x.dim() == 3 else 1))))
        del want, x
        torch.cuda.synchronize()
    return rows


# -- 13. the dense model stack with its FFNs on the SpGEMM stream ------------

MODEL_ARCH = "granite-20b"
MODEL_LAYERS = 2        # 52 in the config: n_rep 2, one shared pattern each
MODEL_KEEP = 0.1        # keep_density of sparsify_ffn_params
MODEL_STREAM_LIMIT = 2 ** 26   # products per plan (a 4-token prefill: 60.4M)
SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 8
SERVE_CACHE = 64
PREFILL_LEN = 4         # the prefill's [1, 4] prompt: N = 4 plans
MODEL_TOL = 1e-4        # normwise, sparse against the dense oracle
STREAM_TOL = 1e-5       # normwise, K1 against the torch stream (C5)


def model_setup(dev, seed):
    """granite-20b at full width, cut to ``MODEL_LAYERS`` layers, f32 weights
    from ``seed`` through the port's ``init_model`` on the card; its FFNs
    converted by ``sparsify_ffn_params`` (keep ``MODEL_KEEP``, one pattern
    per matrix shared by both reps) and the dense oracle on the pruned
    weights by ``densify_ffn_params``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import densify_ffn_params, init_model, \
        sparsify_ffn_params

    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=MODEL_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sparse, overlay = sparsify_ffn_params(cfg, params, keep_density=MODEL_KEEP,
                                          stream_limit=MODEL_STREAM_LIMIT)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dense = densify_ffn_params(cfg, sparse, overlay)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n_params = sum(t.numel() for t in tree_leaves(sparse))
    nnz = {name: getattr(overlay["l0"], name).w_csc.nnz
           for name in FFN_MATRICES}
    print(f"model: {MODEL_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV head, d_head "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{cfg.n_layers} layers; init {t1 - t0:.2f} s, sparsify (keep "
          f"{MODEL_KEEP}) {t2 - t1:.2f} s, densify {t3 - t2:.2f} s; "
          f"{n_params} sparse-model parameters; kept values per matrix "
          f"{json.dumps(nnz)}", flush=True)
    return dict(cfg=cfg, sparse=sparse, dense=dense, overlay=overlay,
                gen=gen, setup_s=dict(init=t1 - t0, sparsify=t2 - t1,
                                      densify=t3 - t2))


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def model_plans(data, n, backend="torch"):
    """Build (and time) each overlay matrix's plan for ``n`` tokens on
    ``backend`` before the first call that needs it: the symbolic phase
    (``_spgemm_plan``: the LRU's plan and its host stream) and, on the
    torch backend, the lift of the stream's forward replay to the card."""
    import torch
    from repro_torch.core import device_stream

    out = {}
    for name in FFN_MATRICES:
        m = getattr(data["overlay"]["l0"], name)
        t0 = time.perf_counter()
        plan = m._spgemm_plan(n, backend)[0]
        t1 = time.perf_counter()
        if backend == "torch":
            device_stream(plan)
            torch.cuda.synchronize()
        out[name] = dict(products=plan.stream.n_products,
                         plan_ms=(t1 - t0) * 1e3,
                         lift_ms=(time.perf_counter() - t1) * 1e3,
                         host_mb=plan.stream_nbytes / 2 ** 20,
                         device_mb=plan.device_stream_nbytes / 2 ** 20)
    print(f"model plans: N = {n} on backend {backend!r}: "
          f"{json.dumps(out)}", flush=True)
    return out


def serve_schedule():
    """Tick by tick, each slot's feed index (the count of its tokens
    already cached: its ``cur_len``) and whether the slot is live: slot b is
    admitted at tick b and takes ``SERVE_PROMPT`` prompt tokens, then its
    own greedy tokens, until ``SERVE_NEW`` are generated."""
    feeds = SERVE_PROMPT + SERVE_NEW - 1
    ticks = SERVE_SLOTS - 1 + feeds
    t = np.arange(ticks)[:, None] - np.arange(SERVE_SLOTS)[None, :]
    live = (t >= 0) & (t < feeds)
    return np.clip(t, 0, feeds - 1), live


def model_serve(data, dev, seed):
    """Serve: ``SERVE_SLOTS`` requests of ``SERVE_PROMPT`` tokens from
    ``seed``, admitted one a tick, through ``decode_step(...,
    sparse_ffn=overlay)`` with an f32 cache and a per-slot ``cur_len``,
    each decoding ``SERVE_NEW`` greedy tokens, with the counts set to 0
    just before and read just after (the torch stream runs no kernel of
    ours).  At every tick the dense oracle (``decode_step`` on the
    densified weights, fed the same tokens) must agree within
    ``MODEL_TOL`` normwise on every live slot's logits; every tick after
    the first (which builds the plans) makes 0 host syncs."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import decode_step, init_cache

    cfg = data["cfg"]
    gen = torch.Generator().manual_seed(seed)
    seq = torch.zeros((SERVE_SLOTS, SERVE_PROMPT + SERVE_NEW),
                      dtype=torch.long)
    seq[:, :SERVE_PROMPT] = torch.randint(
        0, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT), generator=gen)
    seq = seq.to(dev)
    feed, live = serve_schedule()
    feed_d = torch.from_numpy(feed).to(dev)
    # a slot's greedy token is written after its feed SERVE_PROMPT - 1 on
    write_d = torch.from_numpy(live & (feed >= SERVE_PROMPT - 1)).to(dev)
    cache_s = init_cache(cfg, SERVE_SLOTS, SERVE_CACHE, dtype=torch.float32,
                         device=dev)
    cache_d = init_cache(cfg, SERVE_SLOTS, SERVE_CACHE, dtype=torch.float32,
                         device=dev)
    dense_next = torch.zeros((SERVE_SLOTS, len(feed)), dtype=torch.long,
                             device=dev)
    slots = torch.arange(SERVE_SLOTS, device=dev)
    errs, syncs, tick_ms = [], [], []

    def tick(t):
        cur = feed_d[t]
        token = seq[slots, cur][:, None]
        logits, new_cache = decode_step(data["sparse"], cfg, token, cache_s,
                                        cur.to(torch.int32),
                                        sparse_ffn=data["overlay"])
        nxt = logits[:, 0, :cfg.vocab].argmax(-1)
        pos = (cur + 1).clamp(max=seq.shape[1] - 1)[:, None]
        seq.scatter_(1, pos, torch.where(write_d[t][:, None], nxt[:, None],
                                         seq.gather(1, pos)))
        return logits, new_cache, token, cur

    kernels.reset_launch_counts()
    for t in range(len(feed)):
        t0 = time.perf_counter()
        if t == 0:
            logits, cache_s, token, cur = tick(t)
        else:
            out = []
            syncs.append(host_syncs(lambda: out.append(tick(t))))
            logits, cache_s, token, cur = out[0]
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        want, cache_d = decode_step(data["dense"], cfg, token, cache_d,
                                    cur.to(torch.int32))
        dense_next[:, t] = want[:, 0, :cfg.vocab].argmax(-1)
        for b in np.nonzero(live[t])[0]:
            errs.append(rel_err(logits[b, 0, :cfg.vocab],
                                want[b, 0, :cfg.vocab].double()))
    counts = kernels.launch_counts()
    generated = seq[:, SERVE_PROMPT:].cpu().tolist()
    # the dense oracle's greedy token at each live slot's feed
    dense_gen = [[int(dense_next[b, t]) for t in range(len(feed))
                  if live[t, b] and feed[t, b] >= SERVE_PROMPT - 1]
                 for b in range(SERVE_SLOTS)]
    print(f"model serve: {SERVE_SLOTS} requests of {SERVE_PROMPT} prompt "
          f"tokens, admitted one a tick, {SERVE_NEW} greedy tokens each, "
          f"{len(feed)} decode steps at B = {SERVE_SLOTS}; first step "
          f"(plans built) {tick_ms[0]:.1f} ms, later steps median "
          f"{statistics.median(tick_ms[1:]):.2f} ms (host clock, one "
          f"synchronize each); normwise error of the logits against the "
          f"dense oracle max {max(errs):.3g} over {len(errs)} slot-steps; "
          f"host syncs per warm step {sorted(set(syncs))}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    print(f"model serve: greedy tokens (sparse) {json.dumps(generated)}",
          flush=True)
    print(f"model serve: greedy tokens (dense oracle) "
          f"{json.dumps(dense_gen)}; equal: {generated == dense_gen}",
          flush=True)
    check(max(errs) <= MODEL_TOL, f"model serve: sparse decode off the dense "
          f"oracle by {max(errs):.3g} normwise (limit {MODEL_TOL})")
    check(syncs and set(syncs) == {0}, f"model serve: host syncs per warm "
          f"decode step {syncs}, expected 0")
    check(not any(counts.values()), f"model serve: kernels launched on the "
          f"torch stream's path: {counts}")
    return dict(cache=cache_s, seq=seq, cur=feed_d[-1], errs=errs,
                syncs=syncs, tick_ms=tick_ms, generated=generated,
                dense_gen=dense_gen)


def model_prefill_and_loop(data, served, dev, seed):
    """Prefill ``[1, PREFILL_LEN]`` through ``prefill(...,
    sparse_ffn=overlay)`` (the N = 4 plans, built and timed first) against
    the dense oracle; then one step of ``decode_step_loop(...,
    sparse_host=True)`` (the host stream, its N = 1 host plans built and
    timed first) against ``decode_step`` on the served caches; each within
    ``MODEL_TOL`` normwise."""
    import torch
    from repro_torch.models import decode_step, decode_step_loop, prefill

    cfg = data["cfg"]
    gen = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (1, PREFILL_LEN),
                           generator=gen).to(dev)
    plans = model_plans(data, PREFILL_LEN)
    t0 = time.perf_counter()
    got = prefill(data["sparse"], cfg, prompt, sparse_ffn=data["overlay"])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    want = prefill(data["dense"], cfg, prompt)
    err_prefill = rel_err(got, want.double())
    check(got.shape == (1, PREFILL_LEN, cfg.d_model)
          and bool(torch.isfinite(got).all()), "model prefill: output")
    check(err_prefill <= MODEL_TOL, f"model prefill: {err_prefill:.3g} "
          f"normwise off the dense oracle (limit {MODEL_TOL})")

    host_plans = model_plans(data, 1, backend="host")
    token = served["seq"][torch.arange(SERVE_SLOTS, device=dev),
                          served["cur"]][:, None]
    cur = served["cur"].to(torch.int32)
    t0 = time.perf_counter()
    loop, _ = decode_step_loop(data["sparse"], cfg, token, served["cache"],
                               cur, sparse_ffn=data["overlay"],
                               sparse_host=True)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    step, _ = decode_step(data["sparse"], cfg, token, served["cache"], cur,
                          sparse_ffn=data["overlay"])
    err_loop = rel_err(loop, step.double())
    check(err_loop <= MODEL_TOL, f"model host loop: {err_loop:.3g} normwise "
          f"off decode_step (limit {MODEL_TOL})")
    print(f"model prefill: [1, {PREFILL_LEN}] in {prefill_ms:.1f} ms "
          f"(plans built before), normwise error against the dense oracle "
          f"{err_prefill:.3g}; host loop: one decode_step_loop "
          f"(sparse_host=True) at B = {SERVE_SLOTS} in {loop_ms:.1f} ms, "
          f"normwise error against decode_step {err_loop:.3g}", flush=True)
    return dict(plans_n4=plans, host_plans=host_plans, prefill_ms=prefill_ms,
                err_prefill=err_prefill, loop_ms=loop_ms, err_loop=err_loop)


def model_k1_phase(data, dev, reps):
    """K1 against the torch stream on each overlay matrix's N = 1 plan:
    ``stream_apply(..., engine="fused")`` equal to the default engine bit
    for bit on integer-valued weights and activations, within
    ``STREAM_TOL`` normwise on the real ones (rep 0's values and a normal
    activation); K1's count must rise.  Then both engines' device time per
    call (CUDA events, queued) on the real operands, with K1's byte
    bound."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import fused_stream

    gen = data["gen"]
    rows = {}
    before = kernels.launch_counts()["fused_stream"]
    for name in FFN_MATRICES:
        m = getattr(data["overlay"]["l0"], name)
        plan = m._spgemm_plan(1)[0]
        k = m.shape[1]
        w_int = int_values((m.w_csc.nnz,), gen, dev)
        x_int = int_values((k,), gen, dev)
        t0 = time.perf_counter()
        k1_int = plan.stream_apply(w_int, x_int, engine="fused")
        torch.cuda.synchronize()
        views_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(k1_int, plan.stream_apply(w_int, x_int)),
              f"model K1 {name}: K1 differs from the torch stream on "
              "integer values")
        w = m.w_values
        x = torch.randn((k,), generator=gen, device=dev)
        k1 = plan.stream_apply(w, x, engine="fused")
        ts = plan.stream_apply(w, x)
        err = rel_err(k1, ts.double())
        check(err <= STREAM_TOL, f"model K1 {name}: {err:.3g} normwise off "
              f"the torch stream (limit {STREAM_TOL})")
        view = fused_stream(plan).forward
        _, nbytes = k1_work(view, w, x)
        rows[name] = dict(
            products=view.n_products, views_ms=views_ms, err=err,
            max_abs_err=float((k1 - ts).abs().max()),
            torch_stream_ms=event_ms(lambda: plan.stream_apply(w, x), reps),
            k1_ms=event_ms(lambda: plan.stream_apply(w, x, engine="fused"),
                           reps),
            k1_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
    launched = kernels.launch_counts()["fused_stream"] - before
    check(launched > 0, "model K1: fused_stream was not launched")
    print(f"model K1 vs torch stream (N = 1 plans, one call, device ms "
          f"queued): {json.dumps(rows)}; K1 launches {launched}", flush=True)
    return rows


def model_timing(data, served, dev, reps):
    """Sparse and dense decode-step time (host clock ending in a
    synchronize, median of ``reps``) at B = ``SERVE_SLOTS`` on the served
    caches, and the device time and idle share of one sparse step
    (``torch.profiler``)."""
    import torch
    from repro_torch.models import decode_step

    cfg = data["cfg"]
    token = served["seq"][torch.arange(SERVE_SLOTS, device=dev),
                          served["cur"]][:, None]
    cur = served["cur"].to(torch.int32)

    def step(params, overlay):
        return lambda: decode_step(params, cfg, token, served["cache"], cur,
                                   sparse_ffn=overlay)

    sparse = step(data["sparse"], data["overlay"])
    dense = step(data["dense"], None)
    sparse_ms = statistics.median(execute_ms(sparse, reps))
    dense_ms = statistics.median(execute_ms(dense, reps))
    prof = device_profile(sparse, n=1)
    device_ms = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
    out = dict(sparse_step_ms=sparse_ms, dense_step_ms=dense_ms,
               sparse_device_ms=device_ms,
               sparse_idle=idle_share(device_ms, sparse_ms),
               top_device_ops={k: round(v, 4) for k, v in top})
    print(f"model timing: decode step at B = {SERVE_SLOTS} (median of "
          f"{reps}): {json.dumps(out)}", flush=True)
    return out


# -- 14. the MoE family: qwen3-moe-30b-a3b at full width --------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 2          # 48 in the config: n_rep 2
MOE_TOL = 1e-5          # normwise, moe_ffn against its f64 oracle
MOE_DECODE = (4, 1)     # moe_ffn's decode-size input [4, 1, D]: no drop
MOE_PREFILL = 4096      # a [1, 4096] prefill: 32 groups of 128, cap 16
MOE_SERVE_CF = 16.0     # the reference's decode-test capacity factor
MOE_SERVE_SLOTS, MOE_SERVE_STEPS = 4, 16
MOE_DISPATCH_TOKENS = 256
SERVE_TOL = 1e-4        # normwise, decode against prefill at a position


def moe_setup(dev, seed):
    """qwen3-moe-30b-a3b at full width (128 experts, top-8, d_ff_expert
    768), cut to ``MOE_LAYERS`` layers, f32 weights from ``seed`` through
    ``init_model`` on the card."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    m = cfg.moe
    print(f"moe model: {MOE_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_head "
          f"{cfg.d_head}, {m.n_experts} experts, top-{m.top_k}, d_ff_expert "
          f"{m.d_ff_expert}, vocab {cfg.vocab}), {cfg.n_layers} layers; "
          f"init {time.perf_counter() - t0:.2f} s; {n_bytes / 1e9:.3f} GB "
          "of f32 weights", flush=True)
    return dict(cfg=cfg, params=params, gen=gen, n_bytes=n_bytes)


def moe_oracle(p, cfg, x):
    """moe_ffn in f64 on the card, pair by pair: the port's own top-k and
    gates (f32 routing), the keep mask by the reference's capacity rule
    recomputed on the host (per group, each expert keeps its first ``cap``
    pairs in token order), and each expert's FFN on its kept tokens.
    Returns (y [T, D] f64, number of dropped pairs)."""
    import torch
    from repro_torch.models import moe

    m = cfg.moe
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    gates, idx = moe._top_k(moe._route(p["moe"], xf), m.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    g = moe._n_groups(t)
    cap = moe._capacity(t // g, cfg)
    e_h = idx.cpu().numpy()
    keep = np.zeros(e_h.shape, bool)
    for grp in range(g):
        lo, hi = grp * (t // g), (grp + 1) * (t // g)
        seen = np.zeros(m.n_experts, np.int64)
        for tok in range(lo, hi):
            for j in range(m.top_k):
                e = e_h[tok, j]
                keep[tok, j] = seen[e] < cap
                seen[e] += 1
    x64 = xf.double()
    y = torch.zeros_like(x64)
    w = gates.double() * torch.from_numpy(keep).to(x.device)
    for e in range(m.n_experts):
        toks, js = np.nonzero((e_h == e) & keep)
        if not len(toks):
            continue
        toks_d = torch.from_numpy(toks).to(x.device)
        xe = x64[toks_d]
        h = xe @ p["moe"]["gate"][e].double()
        u = xe @ p["moe"]["up"][e].double()
        ye = (torch.nn.functional.silu(h) * u) @ p["moe"]["down"][e].double()
        y.index_add_(0, toks_d, ye * w[toks_d, torch.from_numpy(js).to(
            x.device)][:, None])
    return y, int((~keep).sum())


def moe_ffn_phase(data, dev):
    """``moe_ffn`` on layer 0's params at the decode size and on a
    [1, 4096] prefill (32 groups, cap 16: pairs drop) against its f64
    oracle within ``MOE_TOL`` normwise; two runs equal bit for bit."""
    import torch
    from repro_torch.models import moe_ffn
    from repro_torch.models.blocks import _rep

    cfg, gen = data["cfg"], data["gen"]
    p = {"moe": _rep(data["params"]["blocks"]["l0"]["moe"], 0)}
    out = {}
    for label, shape in (("decode", MOE_DECODE), ("prefill",
                                                  (1, MOE_PREFILL))):
        x = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev)
        t0 = time.perf_counter()
        got = moe_ffn(p["moe"], cfg, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        again = moe_ffn(p["moe"], cfg, x)
        t0 = time.perf_counter()
        want, drops = moe_oracle(p, cfg, x)
        oracle_s = time.perf_counter() - t0
        err = rel_err(got.reshape(-1, cfg.d_model), want)
        out[label] = dict(tokens=int(np.prod(shape)), dropped_pairs=drops,
                          normwise_err=err, bit_stable=torch.equal(got,
                                                                   again),
                          first_call_ms=ms, oracle_s=oracle_s)
        check(bool(torch.isfinite(got).all()), f"moe_ffn {label}: output")
        check(err <= MOE_TOL, f"moe_ffn {label}: {err:.3g} normwise off the "
              f"f64 oracle (limit {MOE_TOL})")
        check(torch.equal(got, again), f"moe_ffn {label}: two runs differ")
    check(out["decode"]["dropped_pairs"] == 0
          and out["prefill"]["dropped_pairs"] > 0,
          f"moe_ffn: drops {out}")
    print(f"moe_ffn vs f64 oracle (layer 0): {json.dumps(out)}", flush=True)
    return out


def well_scaled(cfg, params):
    """``params`` with every stacked ``fan_in`` leaf rescaled to std
    1/sqrt(d_in), its input width, where ``init_model`` (the reference's
    rule) draws it with std 1/sqrt(n_rep) (0.71 at n_rep 2): at full width
    those weights put attention scores near 1e3, so the softmax is an
    argmax whose last-place rounding moves a logit, and two correct
    summation orders (decode and prefill) then differ by far more than
    their arithmetic does.  The other leaves are shared, not copied."""
    from repro_torch.models import model_tables
    from repro_torch.models.params import Leaf

    def walk(t, p):
        if isinstance(t, Leaf):
            if t.init == "fan_in" and t.axes[0] == "layers" \
                    and len(t.shape) >= 3:
                return p * (t.shape[0] / t.shape[-2]) ** 0.5
            return p
        return {k: walk(t[k], p[k]) for k in p}

    return walk(model_tables(cfg), params)


def moe_serve_walk(params, cfg, tok, dev):
    """Teacher-forced decode of ``tok`` [B, S] at slots starting b ticks
    late, from an f32 cache, against ``prefill``'s logits: the normwise
    error per (slot, position), the host syncs of every warm step, the
    greedy tokens, and the last step's cache and inputs."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.layers import lm_logits

    b, s = tok.shape
    full = lm_logits(params["unembed"], cfg, prefill(params, cfg, tok))[
        ..., :cfg.vocab]
    cache = init_cache(cfg, b, s, dtype=torch.float32, device=dev)
    start = torch.arange(b, device=dev)
    slots = torch.arange(b, device=dev)
    errs = np.zeros((b, s))
    syncs, greedy = [], [[] for _ in range(b)]
    for t in range(s + b - 1):
        cur = (t - start).clamp(min=0, max=s - 1)
        token = tok[slots, cur][:, None]
        res = []
        n = host_syncs(lambda: res.append(decode_step(
            params, cfg, token, cache, cur.to(torch.int32))))
        if t:
            syncs.append(n)
        logits, cache = res[0]
        nxt = logits[:, 0, :cfg.vocab].argmax(-1).cpu().tolist()
        for i in range(b):
            if 0 <= t - i < s:
                errs[i, t - i] = rel_err(logits[i, 0, :cfg.vocab],
                                         full[i, t - i].double())
                greedy[i].append(nxt[i])
    return dict(errs=errs, syncs=syncs, greedy=greedy, cache=cache,
                token=token, cur=cur)


def moe_serve(data, dev, seed):
    """Serve at capacity factor 16 (no pair drops, so decode can equal
    prefill): ``MOE_SERVE_SLOTS`` slots, slot b starting b ticks late
    (per-slot ``cur_len``), ``MOE_SERVE_STEPS`` teacher-forced steps each
    from an f32 cache, 0 host syncs per warm step.  On the weights as
    ``init_model`` draws them the error against ``prefill`` is printed by
    position; on the same weights :func:`well_scaled` every live slot's
    logits must lie within ``SERVE_TOL`` normwise of ``prefill``'s at that
    position.  The greedy tokens are printed."""
    import dataclasses

    import torch

    cfg = dataclasses.replace(data["cfg"], moe=dataclasses.replace(
        data["cfg"].moe, capacity_factor=MOE_SERVE_CF))
    gen = torch.Generator().manual_seed(seed + 2)
    tok = torch.randint(0, cfg.vocab, (MOE_SERVE_SLOTS, MOE_SERVE_STEPS),
                        generator=gen).to(dev)
    t0 = time.perf_counter()
    drawn = moe_serve_walk(data["params"], cfg, tok, dev)
    scaled_params = well_scaled(cfg, data["params"])
    scaled = moe_serve_walk(scaled_params, cfg, tok, dev)
    walk_s = time.perf_counter() - t0
    syncs = drawn["syncs"] + scaled["syncs"]
    err, err_drawn = scaled["errs"].max(), drawn["errs"].max()
    print(f"moe serve: {MOE_SERVE_SLOTS} slots, slot b starting b ticks "
          f"late, {MOE_SERVE_STEPS} teacher-forced steps each (capacity "
          f"factor {MOE_SERVE_CF}), twice in {walk_s:.1f} s; normwise error "
          f"of the logits against prefill's: well-scaled weights max "
          f"{err:.3g}, weights as drawn max {err_drawn:.3g}; host syncs per "
          f"warm step {sorted(set(syncs))}", flush=True)
    print(f"moe serve: error by position, as drawn (max over slots) "
          f"{json.dumps([float(f'{e:.3g}') for e in drawn['errs'].max(0)])}"
          f"; well-scaled {json.dumps([float(f'{e:.3g}') for e in scaled['errs'].max(0)])}",
          flush=True)
    print(f"moe serve: greedy tokens (well-scaled) "
          f"{json.dumps(scaled['greedy'])}", flush=True)
    check(err <= SERVE_TOL, f"moe serve: decode off prefill by {err:.3g} "
          f"normwise on well-scaled weights (limit {SERVE_TOL})")
    check(syncs and set(syncs) == {0}, f"moe serve: host syncs per warm "
          f"decode step {sorted(set(syncs))}, expected 0")
    return dict(cfg=cfg, cache=scaled["cache"], token=scaled["token"],
                cur=scaled["cur"], max_err=err, max_err_drawn=err_drawn,
                syncs=syncs)


def moe_dispatch_phase(data, dev, seed):
    """``moe_dispatch_spgemm`` on layer 0's router top-8 for a
    [1, ``MOE_DISPATCH_TOKENS``] prompt's embeddings, with the counts set
    to 0 just before: K2 must launch; the [E, D] result within ``MOE_TOL``
    normwise of the f64 R^T X, and exact on integer x in {-2..2} and gates
    in {1, 2, 3}; the plan's and the execute's times."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import plan_cache_clear, plan_spgemm
    from repro_torch.models import moe, moe_dispatch_spgemm
    from repro_torch.models.blocks import _rep
    from repro_torch.sparse.format import csc_to_dense

    cfg, params = data["cfg"], data["params"]
    m = cfg.moe
    gen = torch.Generator().manual_seed(seed + 3)
    prompt = torch.randint(0, cfg.vocab, (MOE_DISPATCH_TOKENS,),
                           generator=gen).to(dev)
    x = params["embed"]["embedding"][prompt]
    layer0 = _rep(params["blocks"]["l0"]["moe"], 0)
    gates, idx = moe._top_k(moe._route(layer0, x), m.top_k)
    r = torch.zeros((x.shape[0], m.n_experts), dtype=torch.float64,
                    device=dev).scatter_(1, idx, gates.double())
    plan_cache_clear()
    kernels.reset_launch_counts()
    got = moe_dispatch_spgemm(x, idx, gates, m.n_experts)
    counts = kernels.launch_counts()
    err = rel_err(got, r.T @ x.double())
    xi = int_values(tuple(x.shape), torch.Generator(device=dev).manual_seed(
        seed + 4), dev)
    gi = torch.randint(1, 4, tuple(gates.shape), generator=gen).float().to(
        dev)
    ri = torch.zeros_like(r).scatter_(1, idx, gi.double())
    exact = torch.equal(moe_dispatch_spgemm(xi, idx, gi, m.n_experts)
                        .double(), ri.T @ xi.double())
    xt, rc, _ = moe.dispatch_operands(x, idx, gates, m.n_experts)
    t0 = time.perf_counter()
    plan = plan_spgemm(xt, rc, device=dev)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    exec_ms = statistics.median(execute_ms(lambda: plan.execute(xt, rc), 10))
    again = csc_to_dense(plan.execute(xt, rc)).T
    launched = {k: v for k, v in counts.items() if v}
    out = dict(x=list(x.shape), r=[x.shape[0], m.n_experts],
               r_entries=int(idx.numel()), products=int(idx.numel())
               * cfg.d_model, normwise_err=err, integer_exact=exact,
               launches=launched, plan_ms=plan_ms, execute_ms=exec_ms,
               groups={k: int(v) for k, v in plan_kinds(plan).items()},
               bit_stable=torch.equal(again, got))
    print(f"moe dispatch as SpGEMM: {json.dumps(out)}", flush=True)
    check(counts["spa_spgemm"] > 0, f"moe dispatch: K2 did not launch "
          f"{counts}")
    check(err <= MOE_TOL, f"moe dispatch: {err:.3g} normwise off f64 "
          f"(limit {MOE_TOL})")
    check(exact, "moe dispatch: not exact on integer values")
    check(torch.equal(again, got), "moe dispatch: two runs differ")
    return out


def plan_kinds(plan) -> dict:
    """How many groups of each kind a cuda plan holds."""
    kinds = {}
    for g in plan.layout.groups if plan.layout else ():
        kinds[g.kind] = kinds.get(g.kind, 0) + 1
    return kinds


def moe_timing(data, served, dev, reps):
    """The decode step at B = 4 (host clock ending in a synchronize,
    median of ``reps``), its device time and idle share
    (``torch.profiler``), beside its byte floor (every weight read once:
    the capacity dispatch computes all E x cap slots, so every expert is
    read); the [1, 4096] prefill and ``moe_ffn``'s share of it."""
    import torch
    from repro_torch.models import decode_step, moe_ffn, prefill
    from repro_torch.models.blocks import _rep

    cfg, params = served["cfg"], data["params"]

    def step():
        return decode_step(params, cfg, served["token"], served["cache"],
                           served["cur"].to(torch.int32))

    step_ms = statistics.median(execute_ms(step, reps))
    prof = device_profile(step, n=3)
    device_ms = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
    floor = (data["n_bytes"] - params["embed"]["embedding"].numel() * 4) \
        / PEAK_BYTES_PER_S * 1e3
    gen = torch.Generator().manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (1, MOE_PREFILL), generator=gen).to(dev)
    base = data["cfg"]
    prefill_ms = statistics.median(execute_ms(
        lambda: prefill(params, base, tok), 3))
    x = torch.randn((1, MOE_PREFILL, cfg.d_model), device=dev)
    p0 = _rep(params["blocks"]["l0"]["moe"], 0)
    moe_ms = statistics.median(execute_ms(lambda: moe_ffn(p0, base, x), 3))
    out = dict(decode_step_ms=step_ms, decode_device_ms=device_ms,
               decode_idle=idle_share(device_ms, step_ms),
               decode_byte_floor_ms=floor,
               top_device_ops={k: round(v, 4) for k, v in top},
               prefill_4096_ms=prefill_ms, moe_ffn_4096_ms=moe_ms,
               moe_share_of_prefill=MOE_LAYERS * moe_ms / prefill_ms)
    print(f"moe timing: {json.dumps(out)}", flush=True)
    return out


# -- 15. the SSM and hybrid families: falcon-mamba-7b and zamba2-2.7b -------

SSM_MODELS = {"falcon-mamba-7b": 2,   # 64 layers in the config
              "zamba2-2.7b": 6}       # 54: one super-block (6 mamba + shared)
SSM_B, SSM_S = 2, 128
SCAN_TOL = 1e-5         # normwise, the chunked scan against f64 sequential


def ssm_setup(arch, dev, seed):
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    cfg = dataclasses.replace(get_config(arch), n_layers=SSM_MODELS[arch])
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    s = cfg.ssm
    print(f"ssm model: {arch} at full width (d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner}, d_state {s.d_state}, Mamba{s.version}"
          + (f", dt_rank {cfg.dt_rank_actual}" if s.version == 1 else
             f", {cfg.d_inner // s.head_dim} heads of {s.head_dim}; shared "
             f"block {cfg.n_heads} heads of d_head {cfg.d_head}, d_ff "
             f"{cfg.d_ff}") + f", chunk {s.chunk}, vocab {cfg.vocab}), "
          f"{cfg.n_layers} layers; init {time.perf_counter() - t0:.2f} s; "
          f"{n_bytes / 1e9:.3f} GB of f32 weights", flush=True)
    return dict(cfg=cfg, params=params, arch=arch, n_bytes=n_bytes)


def ssm_scan_check(data, tok):
    """The port's chunked scan on layer 0's real (a, u) of the prefill
    (captured at ``_scan_chunks``) against a sequential f64 recurrence on
    the card."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.blocks import _rep
    from repro_torch.models.layers import embed, rms_norm

    cfg, params = data["cfg"], data["params"]
    p0 = _rep(params["blocks"]["l0"], 0)
    x = rms_norm(p0["ln"], embed(params["embed"], tok), cfg.norm_eps)
    chunks = []
    real = ssm._scan_chunks

    def spy(a, u, h0):
        chunks.append((a.contiguous(), u.contiguous()))
        return real(a, u, h0)

    ssm._scan_chunks = spy       # a failure ends the run: no restore needed
    ssm.mamba_forward(p0["mamba"], cfg, x)
    ssm._scan_chunks = real
    a = torch.cat([c[0] for c in chunks], dim=1)
    u = torch.cat([c[1] for c in chunks], dim=1)
    del chunks
    h0 = torch.zeros_like(a[:, 0])

    def build(ch):
        return ch[0], ch[1], lambda h_all: h_all

    got, _ = ssm._chunked_ssm_apply(build, (a, u), h0, cfg.ssm.chunk,
                                    a.shape[1])
    h = h0.double()
    err_num = err_den = 0.0
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + u[:, t].double()
        err_num += float(((got[:, t].double() - h) ** 2).sum())
        err_den += float((h ** 2).sum())
    return (err_num / err_den) ** 0.5, list(a.shape)


def ssm_decode_walk(params, cfg, tok, dev):
    """``tok.shape[1]`` teacher-forced decode steps from an empty f32 state
    and cache against ``prefill``'s logits: the normwise error per step
    (max over slots), the host syncs of every warm step, whether the middle
    step equals a second run bit for bit, and that step's cache and
    inputs."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.layers import lm_logits

    b, s = tok.shape
    full = lm_logits(params["unembed"], cfg, prefill(params, cfg, tok))[
        ..., :cfg.vocab]
    cache = init_cache(cfg, b, s, dtype=torch.float32, device=dev)
    errs, syncs = [], []
    for t in range(s):
        cur = torch.full((b,), t, dtype=torch.int32, device=dev)
        res = []
        n = host_syncs(lambda: res.append(decode_step(
            params, cfg, tok[:, t:t + 1], cache, cur)))
        if t:
            syncs.append(n)
        logits, new_cache = res[0]
        if t == s // 2:
            again, _ = decode_step(params, cfg, tok[:, t:t + 1], cache, cur)
            mid = dict(stable=torch.equal(again, logits), cache=cache,
                       cur=cur, token=tok[:, t:t + 1])
        cache = new_cache
        errs.append(max(rel_err(logits[i, 0, :cfg.vocab],
                                full[i, t].double()) for i in range(b)))
    return dict(errs=np.array(errs), syncs=syncs, mid=mid)


def ssm_phase(arch, dev, seed, reps):
    """One SSM or hybrid model at full width: prefill [2, 128] (several scan
    chunks) and 128 teacher-forced decode steps from an empty f32 state
    and cache.  On the weights as ``init_model`` draws them the error
    against the prefill's logits is printed; on the same weights
    :func:`well_scaled` each step must lie within ``SERVE_TOL`` normwise of
    the prefill's logits at that position.  0 host syncs per warm step;
    prefill and a decode step each equal to a second run bit for bit; the
    chunked scan on layer 0's real (a, u) against a sequential f64
    recurrence; the decode step's, the prefill's and the device times."""
    import torch
    from repro_torch.models import decode_step, prefill

    t_phase = time.perf_counter()
    data = ssm_setup(arch, dev, seed)
    cfg, params = data["cfg"], data["params"]
    gen = torch.Generator().manual_seed(seed + 6)
    tok = torch.randint(0, cfg.vocab, (SSM_B, SSM_S), generator=gen).to(dev)
    t0 = time.perf_counter()
    h = prefill(params, cfg, tok)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_stable = torch.equal(h, prefill(params, cfg, tok))
    del h
    drawn = ssm_decode_walk(params, cfg, tok, dev)
    scaled = ssm_decode_walk(well_scaled(cfg, params), cfg, tok, dev)
    errs = scaled["errs"]
    syncs = drawn["syncs"] + scaled["syncs"]
    step_stable = drawn["mid"]["stable"] and scaled["mid"]["stable"]
    scan_err, scan_shape = ssm_scan_check(data, tok)
    mid = drawn["mid"]

    def step():
        return decode_step(params, cfg, mid["token"], mid["cache"],
                           mid["cur"])

    step_ms = statistics.median(execute_ms(step, reps))
    prof = device_profile(step, n=3)
    device_ms = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
    prefill_med = statistics.median(execute_ms(
        lambda: prefill(params, cfg, tok), 3))
    out = dict(arch=arch, layers=cfg.n_layers, max_err=float(errs.max()),
               worst_step=int(np.argmax(errs)),
               max_err_drawn=float(drawn["errs"].max()),
               worst_step_drawn=int(np.argmax(drawn["errs"])),
               syncs=sorted(set(syncs)), prefill_bit_stable=prefill_stable,
               step_bit_stable=step_stable, scan_err=scan_err,
               scan_shape=scan_shape, decode_step_ms=step_ms,
               decode_device_ms=device_ms,
               decode_idle=idle_share(device_ms, step_ms),
               decode_byte_floor_ms=(data["n_bytes"] - params["embed"][
                   "embedding"].numel() * 4) / PEAK_BYTES_PER_S * 1e3,
               top_device_ops={k: round(v, 4) for k, v in top},
               prefill_first_ms=prefill_ms, prefill_ms=prefill_med,
               phase_s=time.perf_counter() - t_phase)
    print(f"ssm {arch}: {json.dumps(out)}", flush=True)
    print(f"ssm {arch}: error by step every 8th, as drawn "
          f"{json.dumps([float(f'{e:.3g}') for e in drawn['errs'][::8]])}; "
          f"well-scaled {json.dumps([float(f'{e:.3g}') for e in errs[::8]])}",
          flush=True)
    check(errs.max() <= SERVE_TOL, f"ssm {arch}: decode off prefill by "
          f"{errs.max():.3g} normwise at step {out['worst_step']} on "
          f"well-scaled weights (limit {SERVE_TOL})")
    check(syncs and set(syncs) == {0}, f"ssm {arch}: host syncs per warm "
          f"decode step {sorted(set(syncs))}, expected 0")
    check(prefill_stable and step_stable, f"ssm {arch}: two runs differ")
    check(scan_err <= SCAN_TOL, f"ssm {arch}: chunked scan {scan_err:.3g} "
          f"normwise off the f64 recurrence (limit {SCAN_TOL})")
    return out


# -- 16. the cross-attention families through the serving engine ------------

VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 5          # 100 in the config: one super-block (4 + 1 cross)
ENCDEC_ARCH = "seamless-m4t-large-v2"   # full depth: 24 encoder, 24 decoder
CROSS_KEEP = 0.1        # keep_density of seamless's spgemm FFNs
XGATE = 0.5             # every xgate of the VLM: its init, 0, is a no-op
ENG_SLOTS, ENG_PROMPT, ENG_FORCED, ENG_NEW = 4, 8, 8, 8
ENG_CACHE = 32
ENCDEC_PREFILL = 8      # seamless's prefill [4, 8] with its 4096 frames
XGATE_MOVE = 1e-3       # the logits must move at least this when xgate is 0
RAW_GAP = 1e-3          # encdec on raw frames must differ from prefill more


def engine_run(eng, prompts, max_new):
    """Serve ``prompts`` through ``eng``, request b submitted before tick b
    (the slots start staggered).  Per tick: the live slots as (slot,
    position, request id), read after admission (``_admit`` is idempotent,
    and ``step`` admits again), the host copy of its logits (what the
    engine's ``_decode`` returned), its host syncs and host ms.  Returns the ticks and, per slot, the sequence (prompt and
    generated tokens) of the one request it served."""
    ticks, pending, logits, decode = [], list(prompts), [], eng._decode
    eng._decode = lambda toks: logits.append(decode(toks)) or logits[-1]
    while pending or eng.queue or any(eng.slots):
        if pending:
            eng.submit(pending.pop(0), max_new_tokens=max_new)
        eng._admit()
        live = [(b, int(eng.cur_len[b]), r.rid)
                for b, r in enumerate(eng.slots) if r is not None]
        t0 = time.perf_counter()
        n = host_syncs(eng.step)
        ticks.append(dict(live=live, logits=logits[-1], syncs=n,
                          ms=(time.perf_counter() - t0) * 1e3))
    slot_of = {rid: b for t in ticks for b, _, rid in t["live"]}
    check(sorted(slot_of.values()) == list(range(len(prompts))),
          f"engine run: requests to slots {slot_of}, expected one each")
    seqs = {slot_of[rid]: r.prompt + r.generated
            for rid, r in eng.finished.items()}
    return ticks, [seqs[b] for b in range(len(prompts))]


def ticks_against_prefill(params, cfg, aux, ticks, seqs, dev):
    """Each live slot's logits at each tick against ``prefill``'s at its
    position (normwise, in f64), as a [slot, position] array; every slot
    must have been live at every position."""
    import torch
    from repro_torch.models import prefill
    from repro_torch.models.layers import lm_logits

    n_pos = max(pos for t in ticks for _, pos, _ in t["live"]) + 1
    tok = torch.tensor([s[:n_pos] for s in seqs], device=dev)
    full = lm_logits(params["unembed"], cfg, prefill(params, cfg, tok, aux))[
        ..., :cfg.vocab].double().cpu()
    errs = np.full((len(seqs), n_pos), np.nan)
    for t in ticks:
        for b, pos, _ in t["live"]:
            errs[b, pos] = rel_err(torch.from_numpy(t["logits"][b]),
                                   full[b, pos])
    check(not np.isnan(errs).any(), "engine run: a slot skipped a position")
    return errs


def ticks_against_ticks(got, want):
    """Tick by tick, each live slot's logits against another run's of the
    same schedule (normwise); the runs must see the same live slots."""
    import torch

    check(len(got) == len(want) and all(
        g["live"] == w["live"] for g, w in zip(got, want)),
        "engine runs: the two schedules differ")
    return [rel_err(torch.from_numpy(g["logits"][b]),
                    torch.from_numpy(w["logits"][b]).double())
            for g, w in zip(got, want) for b, _, _ in g["live"]]


def engine_prompts(cfg, seed, n):
    """``ENG_SLOTS`` prompts of ``n`` tokens from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (ENG_SLOTS, n),
                         generator=gen).tolist()


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def step_timing(params, cfg, eng, dev, reps, sparse_ffn=None):
    """One ``decode_step`` at B = ``ENG_SLOTS`` on the engine's cache (host
    clock ending in a synchronize, median of ``reps``), its device time and
    idle share (``torch.profiler``) and top device ops."""
    import torch
    from repro_torch.models import decode_step

    token = torch.ones((ENG_SLOTS, 1), dtype=torch.long, device=dev)
    cur = torch.full((ENG_SLOTS,), ENG_CACHE - 2, dtype=torch.int32,
                     device=dev)

    def step():
        return decode_step(params, cfg, token, eng.cache, cur,
                           sparse_ffn=sparse_ffn)

    ms = statistics.median(execute_ms(step, reps))
    prof = device_profile(step, n=3)
    device_ms = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:5]
    return dict(step_ms=ms, device_ms=device_ms,
                idle=idle_share(device_ms, ms),
                top_device_ops={k: round(v, 4) for k, v in top})


def vlm_phase(dev, seed, reps):
    """llama-3.2-vision-90b at full width, one super-block (4 ``attn_ffn``
    layers and one ``attn_ffn_cross``), f32 weights from ``seed`` through
    ``init_model`` on the card with every ``xgate`` at ``XGATE``; patch
    embeddings [4, 1601, 8192] from ``seed``.  ``ServeEngine(aux=...)``
    with ``ENG_SLOTS`` slots, each request ``ENG_PROMPT`` + ``ENG_FORCED``
    prompt tokens (the second half teacher-forced steps) and ``ENG_NEW``
    greedy ones, staggered; one host sync a tick; on the weights rescaled
    by :func:`well_scaled` every live slot's logits within ``SERVE_TOL``
    normwise of ``prefill(tokens, aux)`` at that position, on the weights
    as drawn the error by position printed.  The logits must move when
    ``xgate`` is zeroed.  The decode step's times beside its byte floor."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, prefill
    from repro_torch.models.layers import lm_logits
    from repro_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    for sub in params["blocks"].values():
        if "xgate" in sub:
            sub["xgate"].fill_(XGATE)
    aux = torch.randn((ENG_SLOTS, cfg.n_image_tokens, cfg.d_model),
                      generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = tree_bytes(params)
    print(f"vlm model: {VLM_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_head "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_image_tokens} image tokens), {cfg.n_layers} layers (a "
          f"cross layer every {cfg.cross_attn_every}); init {init_s:.2f} s; "
          f"{n_bytes / 1e9:.3f} GB of f32 weights; xgate {XGATE}",
          flush=True)
    prompts = engine_prompts(cfg, seed + 7, ENG_PROMPT + ENG_FORCED)
    scaled = well_scaled(cfg, params)
    runs = {}
    for name, p in (("scaled", scaled), ("drawn", params)):
        eng = ServeEngine(cfg, p, max_batch=ENG_SLOTS, cache_len=ENG_CACHE,
                          aux=aux)
        ticks, seqs = engine_run(eng, prompts, ENG_NEW)
        runs[name] = dict(ticks=ticks, seqs=seqs, eng=eng, errs=(
            ticks_against_prefill(p, cfg, aux, ticks, seqs, dev)))
    syncs = sorted({t["syncs"] for r in runs.values() for t in r["ticks"]})
    err, err_drawn = runs["scaled"]["errs"].max(), runs["drawn"]["errs"].max()

    tok = torch.tensor(runs["scaled"]["seqs"], device=dev)[:, :ENG_PROMPT]
    with_gate = lm_logits(scaled["unembed"], cfg,
                          prefill(scaled, cfg, tok, aux))
    blocks = {k: (dict(v, xgate=torch.zeros_like(v["xgate"]))
                  if "xgate" in v else v) for k, v in scaled["blocks"].items()}
    no_gate = lm_logits(scaled["unembed"], cfg, prefill(
        dict(scaled, blocks=blocks), cfg, tok, aux))
    move = rel_err(no_gate[..., :cfg.vocab], with_gate[..., :cfg.vocab]
                   .double())
    del with_gate, no_gate

    eng = runs["scaled"]["eng"]
    timing = step_timing(scaled, cfg, eng, dev, reps)
    floor_bytes = n_bytes - params["embed"]["embedding"].numel() * 4 \
        + tree_bytes(eng.cache)
    out = dict(arch=VLM_ARCH, layers=cfg.n_layers, max_err=float(err),
               max_err_drawn=float(err_drawn), syncs_per_tick=syncs,
               ticks=len(runs["scaled"]["ticks"]),
               tick_ms_median=statistics.median(
                   t["ms"] for t in runs["scaled"]["ticks"]),
               xgate_zero_move=move, **timing,
               byte_floor_gb=floor_bytes / 1e9,
               byte_floor_ms=floor_bytes / PEAK_BYTES_PER_S * 1e3,
               phase_s=time.perf_counter() - t_phase)
    print(f"vlm serve: {json.dumps(out)}", flush=True)
    for name in ("drawn", "scaled"):
        print(f"vlm serve: error by position ({name}, max over slots) "
              f"{json.dumps([float(f'{e:.3g}') for e in runs[name]['errs'].max(0)])}",
              flush=True)
    print(f"vlm serve: greedy tokens (well-scaled) "
          f"{json.dumps([s[ENG_PROMPT + ENG_FORCED:] for s in runs['scaled']['seqs']])}",
          flush=True)
    check(err <= SERVE_TOL, f"vlm serve: engine off prefill by {err:.3g} "
          f"normwise on well-scaled weights (limit {SERVE_TOL})")
    check(syncs == [1], f"vlm serve: host syncs per tick {syncs}, expected 1")
    check(move >= XGATE_MOVE, f"vlm: zeroing xgate moved the logits by "
          f"{move:.3g} normwise (at least {XGATE_MOVE} expected)")
    return out


def encdec_phase(dev, seed, reps):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers), f32 weights from ``seed`` through ``init_model`` on the
    card, frames [4, 4096, 1024] from ``seed``.  ``prefill(tokens,
    frames)`` at [4, ``ENCDEC_PREFILL``]; the encoder's time over the
    frames.  Serving (``ENG_SLOTS`` staggered slots, each ``ENG_PROMPT`` +
    ``ENG_FORCED`` prompt tokens and ``ENG_NEW`` greedy ones) on the
    weights rescaled by :func:`well_scaled` (a constant per leaf: the same
    pruning pattern as the weights as drawn), the memory
    ``_memory_from_aux(params, cfg, frames)``: the engine with its FFNs on
    the spgemm path (``sparsify_ffn_params``, keep ``CROSS_KEEP``) against
    the same engine on the densified weights, each tick within
    ``MODEL_TOL`` normwise, with the counts set to 0 just before the
    sparse run and all 0 after it (the torch stream); the dense engine
    within ``SERVE_TOL`` of ``prefill`` at every position; an engine on the
    raw frames (the reference's contract, C11) off it by more than
    ``RAW_GAP``; on the weights as drawn the dense engine's error against
    prefill printed.  One host sync a warm tick.  K1 against the torch
    stream on the one-token plans (:func:`model_k1_phase`).  Plan,
    decode-step and encoder times beside the byte floor."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import densify_ffn_params, init_model, prefill, \
        sparsify_ffn_params
    from repro_torch.models.lm import _memory_from_aux
    from repro_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model(cfg, gen, device=dev)
    frames = torch.randn((ENG_SLOTS, cfg.n_audio_frames, cfg.d_model),
                         generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = tree_bytes(params)
    prompt_tok = torch.tensor(engine_prompts(cfg, seed + 8, ENCDEC_PREFILL),
                              device=dev)
    t0 = time.perf_counter()
    h = prefill(params, cfg, prompt_tok, frames)
    torch.cuda.synchronize()
    prefill_first_ms = (time.perf_counter() - t0) * 1e3
    check(h.shape == (ENG_SLOTS, ENCDEC_PREFILL, cfg.d_model)
          and bool(torch.isfinite(h).all()), "encdec prefill: output")
    del h
    prefill_ms = statistics.median(execute_ms(
        lambda: prefill(params, cfg, prompt_tok, frames), 3))
    encoder_ms = statistics.median(execute_ms(
        lambda: _memory_from_aux(params, cfg, frames), 3))
    prompts = engine_prompts(cfg, seed + 9, ENG_PROMPT + ENG_FORCED)
    eng_a = ServeEngine(cfg, params, max_batch=ENG_SLOTS, cache_len=ENG_CACHE,
                        aux=_memory_from_aux(params, cfg, frames))
    ticks_a, seqs_a = engine_run(eng_a, prompts, ENG_NEW)
    errs_a = ticks_against_prefill(params, cfg, frames, ticks_a, seqs_a, dev)
    del eng_a

    scaled = well_scaled(cfg, params)
    del params
    t0 = time.perf_counter()
    sparse, overlay = sparsify_ffn_params(cfg, scaled,
                                          keep_density=CROSS_KEEP)
    torch.cuda.synchronize()
    sparsify_s = time.perf_counter() - t0
    dense = densify_ffn_params(cfg, sparse, overlay)
    del scaled
    nnz = {name: getattr(overlay["l0"], name).w_csc.nnz
           for name in FFN_MATRICES}
    print(f"encdec model: {ENCDEC_ARCH} at full width and depth (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_head {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_audio_frames} frames), "
          f"{cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder "
          f"layers; init {init_s:.2f} s; {n_bytes / 1e9:.3f} GB of f32 "
          f"weights; sparsify (keep {CROSS_KEEP}) {sparsify_s:.2f} s, kept "
          f"values per matrix {json.dumps(nnz)}", flush=True)
    data = dict(overlay=overlay, gen=gen)
    plans = model_plans(data, 1)

    memory = _memory_from_aux(dense, cfg, frames)
    kernels.reset_launch_counts()
    eng_s = ServeEngine(cfg, sparse, max_batch=ENG_SLOTS,
                        cache_len=ENG_CACHE, aux=memory, sparse_ffn=overlay)
    ticks_s, seqs_s = engine_run(eng_s, prompts, ENG_NEW)
    counts = kernels.launch_counts()
    eng_d = ServeEngine(cfg, dense, max_batch=ENG_SLOTS, cache_len=ENG_CACHE,
                        aux=memory)
    ticks_d, seqs_d = engine_run(eng_d, prompts, ENG_NEW)
    errs_sd = ticks_against_ticks(ticks_s, ticks_d)
    errs_d = ticks_against_prefill(dense, cfg, frames, ticks_d, seqs_d, dev)
    eng_r = ServeEngine(cfg, dense, max_batch=ENG_SLOTS, cache_len=ENG_CACHE,
                        aux=frames)
    ticks_r, seqs_r = engine_run(eng_r, prompts, ENG_NEW)
    errs_r = ticks_against_prefill(dense, cfg, frames, ticks_r, seqs_r, dev)
    del eng_r, memory
    syncs = sorted({t["syncs"] for run in (ticks_a, ticks_d, ticks_r)
                    for t in run} | {t["syncs"] for t in ticks_s[1:]})

    k1_before = kernels.launch_counts()["fused_stream"]
    k1 = model_k1_phase(data, dev, reps)
    k1_launches = kernels.launch_counts()["fused_stream"] - k1_before

    sparse_t = step_timing(sparse, cfg, eng_s, dev, reps, overlay)
    dense_t = step_timing(dense, cfg, eng_d, dev, reps)
    read = dict(blocks=tree_bytes(dense["blocks"]),
                unembed=tree_bytes(dense["unembed"]),
                final_norm=tree_bytes(dense["final_norm"]),
                cache=tree_bytes(eng_d.cache))
    cross_kv = sum(tree_bytes({k: c[k] for k in ("xk", "xv")})
                   for c in eng_d.cache.values())
    floor_bytes = sum(read.values())
    out = dict(arch=ENCDEC_ARCH, encoder_layers=cfg.n_encoder_layers,
               decoder_layers=cfg.n_layers,
               prefill_first_ms=prefill_first_ms, prefill_ms=prefill_ms,
               encoder_ms=encoder_ms, sparsify_s=sparsify_s,
               sparse_vs_dense_max_err=max(errs_sd),
               greedy_equal=seqs_s == seqs_d,
               engine_vs_prefill_max_err=float(errs_d.max()),
               engine_vs_prefill_max_err_drawn=float(errs_a.max()),
               raw_frames_vs_prefill_min_err=float(errs_r.min()),
               raw_frames_vs_prefill_max_err=float(errs_r.max()),
               syncs_per_warm_tick=syncs, first_sparse_tick_syncs=ticks_s[0][
                   "syncs"], ticks=len(ticks_s),
               sparse_tick_ms_median=statistics.median(
                   t["ms"] for t in ticks_s[1:]),
               dense_tick_ms_median=statistics.median(
                   t["ms"] for t in ticks_d),
               launches={k: v for k, v in counts.items() if v},
               k1_launches=k1_launches,
               sparse_step=sparse_t, dense_step=dense_t,
               byte_floor_gb=floor_bytes / 1e9,
               cross_kv_gb=cross_kv / 1e9,
               byte_floor_ms=floor_bytes / PEAK_BYTES_PER_S * 1e3,
               phase_s=time.perf_counter() - t_phase)
    print(f"encdec serve: {json.dumps(out)}", flush=True)
    print(f"encdec serve: greedy tokens (sparse) "
          f"{json.dumps([s[ENG_PROMPT + ENG_FORCED:] for s in seqs_s])}; "
          f"(dense) "
          f"{json.dumps([s[ENG_PROMPT + ENG_FORCED:] for s in seqs_d])}",
          flush=True)
    for name, e in (("well-scaled, encoded memory", errs_d),
                    ("as drawn, encoded memory", errs_a),
                    ("well-scaled, raw frames", errs_r)):
        print(f"encdec serve: error against prefill by position (max over "
              f"slots), {name}: "
              f"{json.dumps([float(f'{x:.3g}') for x in e.max(0)])}",
              flush=True)
    check(max(errs_sd) <= MODEL_TOL, f"encdec serve: sparse engine off the "
          f"dense one by {max(errs_sd):.3g} normwise (limit {MODEL_TOL})")
    check(not any(counts.values()), f"encdec serve: kernels launched on the "
          f"torch stream's path: {counts}")
    check(errs_d.max() <= SERVE_TOL, f"encdec serve: engine off prefill by "
          f"{errs_d.max():.3g} normwise on well-scaled weights (limit "
          f"{SERVE_TOL})")
    check(errs_r.min() > RAW_GAP, f"encdec serve: the engine on raw frames "
          f"came within {errs_r.min():.3g} of prefill (C11: the reference's "
          "engine installs the raw frames, prefill encodes them)")
    check(syncs == [1], f"encdec serve: host syncs per warm tick {syncs}, "
          "expected 1")
    check(k1_launches > 0, "encdec: K1 did not launch")
    return dict(out, plans=plans, k1=k1)


# -- 17. training: qwen2-0.5b at full width and depth ------------------------

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SEQ, TRAIN_BATCH = 512, 8   # 4096 tokens a step
TRAIN_STEPS = 20
TRAIN_WARMUP = 5
TRAIN_LR = 1e-3
GRAD_LAYERS = 2                   # (a): 2 of 24 layers, card against CPU
GRAD_BATCH, GRAD_SEQ = 2, 64
TRAIN_TOL = 1e-5                  # normwise, card against the CPU
ACCUM_TOL = 1e-3                  # relative, accum_steps=2 (bf16) vs 1
DRILL_AT, DRILL_TO = 3, 6         # (d): checkpoint at 3, resume to 6
SFFN_KEEP = 0.5                   # (f): layer 0's FFN on the spgemm path
SFFN_TOKENS = 16                  # x [16, 896]: 34.9M products a matrix,
                                  # past the default guard: MODEL_STREAM_LIMIT
SFFN_STEPS = 10
SFFN_LR = 1e-3                    # build_sparse_ffn_train_step's default


def train_cfg(**kw):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), **kw)


def clone_tree(tree):
    import torch
    from repro_torch.training.tree import tree_map

    return tree_map(torch.clone, tree)


def tree_bits_differ(a, b) -> list:
    """The key paths at which two state trees differ bit for bit."""
    import torch
    from repro_torch.training.tree import tree_paths

    pa, pb = tree_paths(a), tree_paths(b)
    out = [k for k in pa if k not in pb]

    def raw(t):
        return bits(t) if t.dtype == torch.float32 else t

    return out + [k for k in pa if k in pb
                  and not torch.equal(raw(pa[k]), raw(pb[k]))]


def train_grad_phase(dev, seed):
    """(a) The gradient of ``train_loss`` on a [2, 64] batch at 2 of the 24
    layers, full width, well-scaled weights from ``seed``: the card against
    the same model run by the port on the host's CPU, the loss and each
    leaf within ``TRAIN_TOL`` normwise.  Returns the CPU params (phase
    (f) converts layer 0's FFN) and the errors."""
    import torch
    from repro_torch.models import init_model, train_loss
    from repro_torch.training import DataConfig, synth_batch
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import tree_map, tree_paths

    cfg = train_cfg(n_layers=GRAD_LAYERS)
    params = well_scaled(cfg, init_model(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(
        DataConfig(cfg.vocab, GRAD_SEQ, GRAD_BATCH, seed), 0).items()}

    def grads(p, b):
        return value_and_grad(lambda q, bb: train_loss(q, cfg, bb), p, b)

    t0 = time.perf_counter()
    loss_c, g_c = grads(params, batch)
    cpu_s = time.perf_counter() - t0
    dparams = tree_map(lambda t: t.to(dev), params)
    grads(dparams, {k: v.to(dev) for k, v in batch.items()})   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_d, g_d = grads(dparams, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    want = tree_paths(g_c)
    errs = {k: rel_err(g.cpu(), want[k].double())
            for k, g in tree_paths(g_d).items()}
    loss_err = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    worst = max(errs, key=errs.get)
    out = dict(layers=GRAD_LAYERS, batch=[GRAD_BATCH, GRAD_SEQ],
               loss_card=float(loss_d), loss_cpu=float(loss_c),
               loss_rel_err=loss_err, worst_leaf=worst,
               worst_err=errs[worst], cpu_s=cpu_s, card_s=card_s,
               errs={k: float(f"{v:.3g}") for k, v in errs.items()})
    print(f"train (a) gradient, card against CPU: {json.dumps(out)}",
          flush=True)
    check(loss_err <= TRAIN_TOL, f"train (a): loss {loss_err:.3g} off the "
          f"CPU's (limit {TRAIN_TOL})")
    bad = {k: v for k, v in errs.items() if v > TRAIN_TOL}
    check(not bad, f"train (a): gradient leaves off the CPU's beyond "
          f"{TRAIN_TOL}: {bad}")
    return params, out


def train_run_phase(dev, seed):
    """(b) ``TRAIN_STEPS`` ``Trainer`` steps at full width and depth on
    ``SyntheticLoader``'s stream, ``remat="full"``: losses finite and
    falling; the median step time beside the bound of 8·N·tokens (the
    forward, the backward's two products a weight, and the remat's second
    forward; N the weights of the matrix products, the embedding table a
    gather) at the card's f32 peak; tokens/s; one step's device time
    (``torch.profiler``) and its idle share of the median step; the peak
    memory under "full" and, over two steps, under "none".  Returns the initial state and the run's
    settings for the phases after it."""
    import dataclasses

    import torch
    from repro_torch.training import DataConfig, SyntheticLoader, \
        TrainConfig, Trainer, init_train_state

    cfg = train_cfg()
    tc = TrainConfig(total_steps=TRAIN_STEPS, peak_lr=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP, checkpoint_every=0,
                     log_every=10 ** 9)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    init = init_train_state(cfg, tc, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(init["params"]))
    n_matmul = n_params - init["params"]["embed"]["embedding"].numel()
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(init)) / 1e9
    dcfg = DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed)
    tokens = TRAIN_SEQ * TRAIN_BATCH

    def peak_of(run):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        return out, peak / 1e9, (peak - base) / 1e9

    trainer = Trainer(cfg, tc, SyntheticLoader(dcfg, device=dev),
                      clone_tree(init))
    log, peak_full, step_full = peak_of(lambda: trainer.run(TRAIN_STEPS))
    losses = [m["loss"] for m in log]
    step_ms = statistics.median(m["sec"] for m in log[1:]) * 1e3
    prof = device_profile(lambda: trainer.run(1), n=1)
    device_ms = sum(prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:6]
    del trainer
    none = Trainer(dataclasses.replace(cfg, remat="none"), tc,
                   SyntheticLoader(dcfg, device=dev), clone_tree(init))
    none_log, peak_none, step_none = peak_of(lambda: none.run(2))
    del none
    gc.collect()
    torch.cuda.empty_cache()
    flops = 8 * n_matmul * tokens
    out = dict(
        model=dict(layers=cfg.n_layers, d_model=cfg.d_model,
                   heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                   d_head=cfg.d_head, d_ff=cfg.d_ff, vocab=cfg.vocab,
                   params=n_params, matmul_params=n_matmul),
        init_s=init_s, state_gb=state_gb, tokens_per_step=tokens,
        losses=[float(f"{x:.5g}") for x in losses],
        first_step_ms=log[0]["sec"] * 1e3, median_step_ms=step_ms,
        tokens_per_s=tokens / step_ms * 1e3,
        bound_ms=flops / PEAK_F32_PER_S * 1e3, bound_flops=flops,
        device_ms=device_ms, idle=idle_share(device_ms, step_ms),
        top_device_ops={k: round(v, 3) for k, v in top},
        peak_gb_full=peak_full, step_gb_full=step_full,
        peak_gb_none=peak_none, step_gb_none=step_none,
        none_step_ms=[m["sec"] * 1e3 for m in none_log],
        none_losses=[m["loss"] for m in none_log])
    print(f"train (b) {TRAIN_STEPS} Trainer steps: {json.dumps(out)}",
          flush=True)
    check(all(np.isfinite(losses)), f"train (b): a loss is not finite: "
          f"{losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    check(last < first, f"train (b): the loss did not fall ({first:.5g} "
          f"-> {last:.5g})")
    check(none_log[0]["loss"] == losses[0], "train (b): remat 'none' "
          f"changed the first loss ({none_log[0]['loss']} vs {losses[0]})")
    check(peak_full < peak_none, f"train (b): remat 'full' peaks at "
          f"{peak_full:.2f} GB, not below 'none''s {peak_none:.2f} GB")
    return dict(init=init, cfg=cfg, tc=tc, dcfg=dcfg,
                first_loss=losses[0]), out


def train_settings_phase(run, dev):
    """(e) ``accum_steps=2`` with a bf16 buffer: its first loss within
    ``ACCUM_TOL`` of ``accum_steps=1``'s; 8-bit moments: three steps with
    finite losses and params."""
    import dataclasses

    import torch
    from repro_torch.training import AdamWConfig, SyntheticLoader, \
        adamw_init, build_train_step

    cfg, tc, init = run["cfg"], run["tc"], run["init"]
    loader = SyntheticLoader(run["dcfg"], device=dev)
    batch = next(loader)
    accum = build_train_step(cfg, dataclasses.replace(
        tc, accum_steps=2, accum_dtype="bfloat16"))
    t0 = time.perf_counter()
    _, m = accum(clone_tree(init), batch, 0)
    loss2 = float(m["loss"])
    accum_s = time.perf_counter() - t0
    rel = abs(loss2 - run["first_loss"]) / abs(run["first_loss"])
    qcfg = dataclasses.replace(tc, opt=AdamWConfig(quantize_moments=True))
    params = clone_tree(init["params"])
    state = {"params": params, "opt": adamw_init(params, qcfg.opt)}
    step = build_train_step(cfg, qcfg)
    loader = SyntheticLoader(run["dcfg"], device=dev)
    q_losses = []
    t0 = time.perf_counter()
    for i in range(3):
        state, m = step(state, next(loader), i)
        q_losses.append(float(m["loss"]))
    quant_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(state["params"]))
    moments_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(state["opt"])) / 1e9
    del state, params
    out = dict(accum2_bf16_loss=loss2, accum1_loss=run["first_loss"],
               accum_rel=rel, accum_s=accum_s, quant_losses=q_losses,
               quant_s=quant_s, quant_moments_gb=moments_gb)
    print(f"train (e) other settings: {json.dumps(out)}", flush=True)
    check(rel <= ACCUM_TOL, f"train (e): accum_steps=2 (bf16) first loss "
          f"{rel:.3g} off accum_steps=1's (limit {ACCUM_TOL})")
    check(all(np.isfinite(q_losses)) and finite, "train (e): 8-bit moments "
          f"gave a non-finite loss or param: {q_losses}")
    return out


def train_drill_phase(run, dev):
    """(c) and (d): trainer A runs ``DRILL_AT`` steps from the initial
    state, checkpoints (timed, its size read) and runs on to ``DRILL_TO``;
    trainer B runs ``DRILL_AT`` steps from the same state; trainer C
    resumes from A's checkpoint (``try_resume``, timed) into B's template.
    C's state equals B's bit for bit (two runs of ``DRILL_AT`` steps, the
    checkpoint's round trip exact); C runs on to ``DRILL_TO`` and equals A,
    bit for bit, params and moments, with the same losses."""
    import dataclasses

    import torch
    from repro_torch.training import SyntheticLoader, Trainer

    cfg, tc, dcfg = run["cfg"], run["tc"], run["dcfg"]
    ckdir = tempfile.mkdtemp(prefix="chip-smoke-train-ckpt-")
    atexit.register(shutil.rmtree, ckdir, True)
    tck = dataclasses.replace(tc, checkpoint_dir=ckdir)
    a = Trainer(cfg, tck, SyntheticLoader(dcfg, device=dev),
                clone_tree(run["init"]))
    a.run(DRILL_AT)
    t0 = time.perf_counter()
    a.checkpoint()
    snap_s = time.perf_counter() - t0
    a.wait_checkpoint()
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(ckdir) for f in files)
    a.run(DRILL_TO - DRILL_AT)
    b = Trainer(cfg, tc, SyntheticLoader(dcfg, device=dev), run.pop("init"))
    b.run(DRILL_AT)
    c = Trainer(cfg, tck, SyntheticLoader(dcfg, device=dev), b.state)
    t0 = time.perf_counter()
    resumed = c.try_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(resumed and c.step_idx == DRILL_AT and c.loader.step == DRILL_AT,
          f"train (d): try_resume gave {resumed}, step {c.step_idx}, data "
          f"step {c.loader.step}")
    stable = tree_bits_differ(c.state, b.state)
    del b
    c.run(DRILL_TO - DRILL_AT)
    drill = tree_bits_differ(c.state, a.state)
    la = [m["loss"] for m in a.metrics_log[DRILL_AT:]]
    lc = [m["loss"] for m in c.metrics_log]
    out = dict(checkpoint_step=DRILL_AT, checkpoint_gb=ckpt_bytes / 1e9,
               snapshot_s=snap_s, checkpoint_s=ckpt_s, restore_s=restore_s,
               losses_uninterrupted=la, losses_resumed=lc,
               leaves_differing_two_runs=stable,
               leaves_differing_resumed=drill)
    print(f"train (c, d) bit-stability and the resume drill: "
          f"{json.dumps(out)}", flush=True)
    check(not stable, f"train (c): two runs of {DRILL_AT} steps differ at "
          f"{stable}")
    check(not drill and la == lc, f"train (d): the resumed run differs "
          f"from the uninterrupted one at {drill} (losses {la} vs {lc})")
    del a, c
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_sparse_ffn_phase(params, dev, seed, reps):
    """(f) Layer 0's FFN of (a)'s well-scaled weights through
    ``SparseFFN.from_params(keep_density=0.5, path="spgemm",
    stream_limit=MODEL_STREAM_LIMIT)``: 10
    ``build_sparse_ffn_train_step`` steps on x, y [16, 896] from ``seed``,
    with the counts set to 0 just before the warm steps: the loss below 0.7x
    the first, every warm step 0 host syncs and no plan built, and no
    kernel of ours launched (the torch stream).  Then on the same plans, K1
    (``engine="fused"``) forward and both gradient views against the torch
    stream, bit for bit on integer values and within ``STREAM_TOL``
    normwise on real ones, its count rising; per matrix, K1's and the
    torch stream's forward+gradient time (CUDA events) beside K1's byte
    bound on the three views, and the step's time."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import fused_stream, plan_cache_info
    from repro_torch.models import SparseFFN
    from repro_torch.training.train_loop import build_sparse_ffn_train_step

    p = {name: {"w": params["blocks"]["l0"]["ffn"][name]["w"][0]}
         for name in FFN_MATRICES}
    t0 = time.perf_counter()
    sp = SparseFFN.from_params(p, keep_density=SFFN_KEEP, path="spgemm",
                               stream_limit=MODEL_STREAM_LIMIT, device=dev)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    nnz = {name: getattr(sp, name).w_csc.nnz for name in FFN_MATRICES}
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = sp.gate.shape[1]
    x = torch.randn((SFFN_TOKENS, d), generator=gen, device=dev)
    y = torch.randn((SFFN_TOKENS, d), generator=gen, device=dev)
    step, state = build_sparse_ffn_train_step(sp, lr=SFFN_LR)
    t0 = time.perf_counter()
    state, m0 = step(state, (x, y))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    misses = plan_cache_info()["misses"]
    kernels.reset_launch_counts()
    losses, syncs = [m0["loss"]], []
    for _ in range(SFFN_STEPS - 1):
        syncs.append(host_syncs(
            lambda: losses.append(step(state, (x, y))[1]["loss"])))
    counts = kernels.launch_counts()
    planned = plan_cache_info()["misses"] - misses
    losses = [float(v) for v in torch.stack(losses).cpu()]
    step_ms = statistics.median(execute_ms(lambda: step(state, (x, y)),
                                           reps))
    check(all(np.isfinite(losses)) and losses[-1] < 0.7 * losses[0],
          f"train (f): the sparse FFN's loss did not fall below 0.7x: "
          f"{losses}")
    check(syncs == [0] * (SFFN_STEPS - 1), f"train (f): host syncs per warm "
          f"step {syncs}")
    check(planned == 0, f"train (f): {planned} plans built in warm steps")
    check(not any(counts.values()), f"train (f): kernels launched on the "
          f"torch stream's path: {counts}")

    before = kernels.launch_counts()["fused_stream"]
    rows = {}
    for name in FFN_MATRICES:
        m = getattr(sp, name)
        plan = m._spgemm_plan(SFFN_TOKENS)[0]
        n_x = m.shape[1] * SFFN_TOKENS

        def fwd_grad(w, xv, g, engine):
            wr, xr = w.detach().requires_grad_(), xv.detach().requires_grad_()
            c = plan.stream_apply(wr, xr, engine=engine)
            return (c.detach(),) + torch.autograd.grad(c, (wr, xr), g)

        ints = (int_values((m.w_csc.nnz,), gen, dev),
                int_values((n_x,), gen, dev),
                int_values((plan.stream.nnz,), gen, dev))
        k1 = fwd_grad(*ints, "fused")
        ts = fwd_grad(*ints, None)
        check(all(torch.equal(u, v) for u, v in zip(k1, ts)),
              f"train (f) {name}: K1 differs from the torch stream on "
              "integer values (forward or a gradient)")
        real = (state["params"][name],
                torch.randn((n_x,), generator=gen, device=dev),
                torch.randn((plan.stream.nnz,), generator=gen, device=dev))
        k1 = fwd_grad(*real, "fused")
        ts = fwd_grad(*real, None)
        errs = [rel_err(u, v.double()) for u, v in zip(k1, ts)]
        check(max(errs) <= STREAM_TOL, f"train (f) {name}: K1 {errs} "
              f"normwise off the torch stream (limit {STREAM_TOL})")
        fs = fused_stream(plan)
        w, xv, g = real
        nbytes = (k1_work(fs.forward, w, xv)[1]
                  + k1_work(fs.grad_a, g, xv)[1]
                  + k1_work(fs.grad_b, g, w)[1])
        rows[name] = dict(
            nnz=nnz[name], products=fs.forward.n_products,
            errs=[float(f"{e:.3g}") for e in errs],
            max_abs_err=max(float((u - v).abs().max())
                            for u, v in zip(k1, ts)),
            k1_fwd_grad_ms=event_ms(lambda: fwd_grad(*real, "fused"), reps),
            torch_stream_fwd_grad_ms=event_ms(
                lambda: fwd_grad(*real, None), reps),
            k1_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
    launched = kernels.launch_counts()["fused_stream"] - before
    check(launched > 0, "train (f): K1 was not launched")
    out = dict(keep=SFFN_KEEP, tokens=SFFN_TOKENS, convert_s=convert_s,
               first_step_s=first_s, losses=losses, warm_syncs=syncs,
               step_ms=step_ms, k1_launches=launched, matrices=rows)
    print(f"train (f) sparse FFN: {json.dumps(out)}", flush=True)
    return out


def timed(phase, *args):
    """``phase(*args)``, with a line saying how long it took."""
    import torch

    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {phase.__name__}: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
          "card", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    # a profile directory of this run's own, pinned before anything consults
    # a profile: no profile of the user's cache leaks into the phases, and
    # phase 7b's calibration writes nowhere else
    profiles = tempfile.mkdtemp(prefix="chip-smoke-profiles-")
    atexit.register(shutil.rmtree, profiles, True)
    os.environ["REPRO_PROFILE_DIR"] = profiles
    os.environ.pop("REPRO_PROFILE_FILE", None)
    os.environ.pop("REPRO_AUTO_CALIBRATE", None)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"FAIL: {src}/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch import kernels
    from repro_torch.core import plan_cache_clear, plan_spgemm
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"nvcc build and load of {len(_build.sources())} sources: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    mats = {name: integer_matrix(name, args.seed) for name in MATRICES}
    expected = {name: scipy_product(mats[name], mats[name])
                for name in MATRICES}
    stacks = {name: batched_stacks(name, mats[name], args.seed)
              for name in MATRICES}
    print(f"synthesized {len(MATRICES)} Table-1 matrices and scipy A@A in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.zeros(1, device=dev)   # CUDA context up before plan times
    torch.cuda.synchronize()
    plans, plan_ms = {}, {}
    for name in MATRICES:
        for method in METHODS:
            t0 = time.perf_counter()
            plans[name, method] = plan_spgemm(
                mats[name], mats[name],
                *(() if method is None else (method,)), device=dev)
            torch.cuda.synchronize()
            plan_ms[name, method] = (time.perf_counter() - t0) * 1e3

    fplans = fused_plans(mats, dev)

    errs, edge_tiers = timed(kernel_phase, plans, mats, dev, args.seed)
    k1_err = timed(fused_kernel_phase, fplans, mats, dev, args.seed)
    timed(fused_batch_phase, fplans, mats, dev, args.seed)
    b_errs, b_edge_tiers = timed(batched_kernel_phase, plans, fplans, mats,
                                 stacks, dev, args.seed)
    counts = timed(main_path, mats, expected)
    fused_counts = timed(fused_path, mats, expected)
    timed(backward_phase, mats, dev, args.seed)
    tplans = timed(torch_plans, mats, fplans, dev)
    timed(torch_stream_path, mats, expected, tplans)
    timed(torch_stream_checks, mats, tplans, fplans, dev, args.seed)
    timed(segment_order_probe, dev, args.seed)
    timed(torch_backward_phase, mats, tplans, dev, args.seed)
    grad_counts = timed(grad_view_path, fplans, mats, dev, args.seed)
    timed(grad_view_kernel_phase, fplans, mats, dev, args.seed)
    b_results, b_launches, b_counts = timed(batched_path, stacks)
    b_syncs = timed(check_batched_path, b_results, b_launches, stacks,
                    fplans, dev)
    del b_results
    t_results, _ = timed(tiled_path, mats, stacks)
    timed(check_tiled_path, t_results, mats, expected, stacks, dev,
          args.seed)
    del t_results
    timed(calibration_phase, mats, expected, dev, card)
    biggest, naive_ms, libs = timed(timing_phase, plans, mats, plan_ms, dev,
                                    args.reps)
    k1_biggest = timed(fused_timing_phase, fplans, mats, dev, args.reps,
                       naive_ms, libs)
    timed(batched_timing_phase, stacks, fplans, dev, args.reps, b_syncs)
    timed(torch_timing_phase, tplans, fplans, mats, dev, args.reps)
    timed(segment_path_timing, tplans, fplans, mats, dev, args.reps)
    timed(tiled_timing_phase, mats, dev, args.reps)
    rows = [timed(k1_report, k1_biggest, fused_counts["fused_stream"],
                  k1_err, libs, fplans, tplans, mats, args.reps)]
    rows += timed(kernel_report, biggest, plans, mats, counts, errs,
                  edge_tiers, args.seed, args.reps)
    rows += timed(batched_kernel_report, biggest, k1_biggest, plans, tplans,
                  stacks, b_counts, grad_counts, b_errs, b_edge_tiers, dev,
                  args.seed, args.reps)

    # the FFN phases hold granite-20b's FFN at full width: the earlier
    # phases' plans and operands go first
    del plans, fplans, tplans, mats, expected, stacks, biggest, k1_biggest
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"freed the earlier phases: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
          "card", flush=True)
    ffn_data = timed(ffn_setup, dev, args.seed)
    timed(bsr_kernel_phase, ffn_data, dev)
    ffn_out, ffn_counts = timed(ffn_path, ffn_data)
    timed(check_ffn_path, ffn_data, ffn_out, dev)
    del ffn_out
    timed(check_ffn_matmuls, ffn_data, dev)
    timed(ffn_timing_phase, ffn_data, args.reps)
    rows += timed(bsr_kernel_report, ffn_data, ffn_counts, dev, args.reps)

    # the model phases hold granite-20b at full width: the FFN phases' data
    # goes first
    del ffn_data
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    t_model = time.perf_counter()
    model = timed(model_setup, dev, args.seed)
    model_plans(model, 1)
    served = timed(model_serve, model, dev, args.seed)
    timed(model_prefill_and_loop, model, served, dev, args.seed)
    k1_before = kernels.launch_counts()["fused_stream"]
    timed(model_k1_phase, model, dev, args.reps)
    k1_model = kernels.launch_counts()["fused_stream"] - k1_before
    timed(model_timing, model, served, dev, args.reps)
    print(f"model phases: {time.perf_counter() - t_model:.1f} s; card: "
          f"{card}", flush=True)

    # phase 14 holds qwen3-moe-30b-a3b at full width: phase 13's model goes
    # first
    del model, served
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    t_moe = time.perf_counter()
    moe = timed(moe_setup, dev, args.seed)
    timed(moe_ffn_phase, moe, dev)
    moe_served = timed(moe_serve, moe, dev, args.seed)
    dispatch = timed(moe_dispatch_phase, moe, dev, args.seed)
    timed(moe_timing, moe, moe_served, dev, args.reps)
    for row in rows:
        if row["name"] == KERNELS["spa"]["name"]:
            row["launches_by_path"] = dict(
                main=row["launches"],
                moe_dispatch=dispatch["launches"]["spa_spgemm"])
    print(f"moe phases: {time.perf_counter() - t_moe:.1f} s; card: {card}",
          flush=True)
    del moe, moe_served
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 15: the SSM and hybrid models, one at a time
    t_ssm = time.perf_counter()
    for arch in SSM_MODELS:
        timed(ssm_phase, arch, dev, args.seed, args.reps)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"ssm phases: {time.perf_counter() - t_ssm:.1f} s; card: {card}",
          flush=True)

    # phase 16: the cross-attention families through the serving engine,
    # one model at a time
    t_cross = time.perf_counter()
    timed(vlm_phase, dev, args.seed, args.reps)
    gc.collect()
    torch.cuda.empty_cache()
    encdec = timed(encdec_phase, dev, args.seed, args.reps)
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"cross phases: {time.perf_counter() - t_cross:.1f} s; card: "
          f"{card}", flush=True)

    # phase 17: training, qwen2-0.5b at full width and depth
    t_train = time.perf_counter()
    grad_params, _ = timed(train_grad_phase, dev, args.seed)
    run, _ = timed(train_run_phase, dev, args.seed)
    timed(train_settings_phase, run, dev)
    timed(train_drill_phase, run, dev)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    sffn = timed(train_sparse_ffn_phase, grad_params, dev, args.seed,
                 args.reps)
    del grad_params
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    for row in rows:
        if row["name"] == KERNELS["fused"]["name"]:
            row["launches_by_path"] = dict(
                main=row["launches"], model_k1=k1_model,
                encdec_k1=encdec["k1_launches"],
                train_k1=sffn["k1_launches"])
    print(f"train phases: {time.perf_counter() - t_train:.1f} s; card: "
          f"{card}", flush=True)
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, build "
          "included", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
