"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and bind them with ctypes.

The sources have a plain C interface (no PyTorch headers), so each compiles
in seconds.  At first use every ``csrc/*.cu`` is compiled to an object for
``sm_90a`` (one ``nvcc`` process per source, all started together), the
objects are linked into one shared library, and the library is loaded with
``ctypes``.  The library is cached under ``build/repro_torch_kernels/<key>/``
at the root of the checkout, keyed by a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so a second process reuses
it.  A missing ``nvcc`` or a failed build raises.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (pointers and the stream as void*, sizes
# int); each takes the batch, the extent of its grid's second axis (1 for
# the unbatched wrappers)
_A_B = (_P, _P, _P, _I, _I, _P, _P, _P, _I, _I)  # a_* n_a za, b_* n_b zb
SIGNATURES = {
    # A and B operands, m, batch, out, stream
    "repro_spa_launch": _A_B + (_I, _I, _P, _P),
    # A and B operands, steps, block_cols, m, batch, acc, flags, stream
    "repro_spars_launch": _A_B + (_P, _I, _I, _I, _P, _P, _P),
    # A and B operands, steps, block_cols, h, batch, tier, lanes, sets,
    # keys, vals, ws_keys, ws_vals, stream
    "repro_hash_launch": _A_B + (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P),
    # idx_x, idx_y, seg_ptr, long_slots, n_long, x, y, n_x, n_y, n_out,
    # batch, out, stream
    "repro_fused_stream_launch": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                                  _P, _P),
    # block_idx, block_nnz, blocks, n_rb, max_nb, bm, bk, x, k_dim, n,
    # batch, out, stream
    "repro_bsr_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P),
    # K5's launch shape (no launch): n_rb, bm, bk, n, batch, aligned, out
    "repro_bsr_layout": (_I, _I, _I, _I, _I, _I, _P),
}

_LOCK = threading.Lock()
_LIB = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$NVCC``, then ``PATH``, then ``$CUDA_HOME/bin``."""
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($NVCC, PATH, $CUDA_HOME/bin): the CUDA kernels "
        "cannot be built")


def _key() -> str:
    h = hashlib.sha256()
    for f in NVCC_FLAGS:
        h.update(f.encode() + b"\0")
    for src in sorted(CSRC.glob("*.cu*")):   # sources and their headers
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library; return its path."""
    out_dir = BUILD_ROOT / _key()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    compiler = nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, p in procs:
            log = p.communicate()[0]
            if p.returncode:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = [compiler, *NVCC_FLAGS, "-shared",
                *(str(obj) for _, obj, _ in procs), "-o",
                str(Path(tmp) / lib_path.name)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(
                f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}{res.stderr}")
        # atomic publish: concurrent builders of one key never see a
        # half-written library
        os.replace(Path(tmp) / lib_path.name, lib_path)
    return lib_path


def library():
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch reported a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")
