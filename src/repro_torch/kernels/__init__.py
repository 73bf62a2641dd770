"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

- fused_stream.py K1 fused product-stream replay: a thread per short output
                  slot (a tile of value sets in each), a warp per long one
                  (more than LONG_SLOT products) and value set
- spa.py          K2 SPA SpGEMM: a CTA per 8 C columns x 512 rows
- spars.py        K3 SPARS lock-step SpGEMM: K2's slice kernel in lock-step
                  (csrc/slice_kernel.cuh holds the body both share)
- hash_spgemm.py  K4 HASH lock-step SpGEMM: two warps per lane, its table
                  in shared memory (or, for h >= 32768, in device memory)
- bsr_spmm.py     K5 padded-BSR x dense: a CTA a group of 16 block-rows,
                  x staged in shared memory chunk by chunk, an 8-row
                  register tile a lane; and the host converter
                  bsr_from_dense
- ref.py          plain-torch oracles for the tests
- ops.py          group-level wrappers + spgemm_cuda
- _build.py       nvcc build of csrc/ and the ctypes binding

Each kernel has an unbatched wrapper and a ``*_batched`` one (K1-b … K5-b:
B same-pattern value sets in one launch, the batch a grid axis of the
kernel).  Each wrapper launches its kernel for CUDA tensors (or raises),
runs its plain PyTorch version for CPU tensors, and counts its launches in
``n_launches``.  Nothing is compiled when this package is imported.
"""

from repro_torch.kernels.bsr_spmm import (
    bsr_from_dense,
    bsr_layout,
    bsr_spmm,
    bsr_spmm_batched,
    bsr_spmm_batched_plain,
    bsr_spmm_plain,
)
from repro_torch.kernels.fused_stream import (
    fused_stream,
    fused_stream_batched,
    fused_stream_batched_plain,
    fused_stream_plain,
)
from repro_torch.kernels.hash_spgemm import (
    hash_spgemm,
    hash_spgemm_batched,
    hash_spgemm_batched_plain,
    hash_spgemm_plain,
)
from repro_torch.kernels.ops import spgemm_cuda
from repro_torch.kernels.spa import (
    spa_spgemm,
    spa_spgemm_batched,
    spa_spgemm_batched_plain,
    spa_spgemm_plain,
)
from repro_torch.kernels.spars import (
    spars_spgemm,
    spars_spgemm_batched,
    spars_spgemm_batched_plain,
    spars_spgemm_plain,
)

#: every kernel wrapper of this package (each carries ``n_launches``)
KERNELS = (fused_stream, spa_spgemm, spars_spgemm, hash_spgemm, bsr_spmm,
           fused_stream_batched, spa_spgemm_batched, spars_spgemm_batched,
           hash_spgemm_batched, bsr_spmm_batched)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.n_launches = 0
        for tier in getattr(k, "n_launches_by_tier", ()):
            k.n_launches_by_tier[tier] = 0


def launch_counts() -> dict:
    return {k.__name__: k.n_launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "bsr_from_dense",
    "bsr_layout",
    "bsr_spmm",
    "bsr_spmm_batched",
    "bsr_spmm_batched_plain",
    "bsr_spmm_plain",
    "fused_stream",
    "fused_stream_batched",
    "fused_stream_batched_plain",
    "fused_stream_plain",
    "hash_spgemm",
    "hash_spgemm_batched",
    "hash_spgemm_batched_plain",
    "hash_spgemm_plain",
    "launch_counts",
    "reset_launch_counts",
    "spa_spgemm",
    "spa_spgemm_batched",
    "spa_spgemm_batched_plain",
    "spa_spgemm_plain",
    "spars_spgemm",
    "spars_spgemm_batched",
    "spars_spgemm_batched_plain",
    "spars_spgemm_plain",
    "spgemm_cuda",
]
