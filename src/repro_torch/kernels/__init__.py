"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

- fused_stream.py K1 fused product-stream replay: one thread per output slot
- spa.py          K2 SPA SpGEMM: one warp per C column
- spars.py        K3 SPARS lock-step SpGEMM: one thread per lane
- hash_spgemm.py  K4 HASH lock-step SpGEMM: one thread per lane and table
- ref.py          plain-torch oracles for the tests
- ops.py          group-level wrappers + spgemm_cuda
- _build.py       nvcc build of csrc/ and the ctypes binding

Each wrapper launches its kernel for CUDA tensors (or raises), runs its plain
PyTorch version for CPU tensors, and counts its launches in ``n_launches``.
Nothing is compiled when this package is imported.
"""

from repro_torch.kernels.fused_stream import fused_stream, \
    fused_stream_plain
from repro_torch.kernels.hash_spgemm import hash_spgemm, hash_spgemm_plain
from repro_torch.kernels.ops import spgemm_cuda
from repro_torch.kernels.spa import spa_spgemm, spa_spgemm_plain
from repro_torch.kernels.spars import spars_spgemm, spars_spgemm_plain

#: every kernel wrapper of this package (each carries ``n_launches``)
KERNELS = (fused_stream, spa_spgemm, spars_spgemm, hash_spgemm)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.n_launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.n_launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "fused_stream",
    "fused_stream_plain",
    "hash_spgemm",
    "hash_spgemm_plain",
    "launch_counts",
    "reset_launch_counts",
    "spa_spgemm",
    "spa_spgemm_plain",
    "spars_spgemm",
    "spars_spgemm_plain",
    "spgemm_cuda",
]
