"""Builds of one kernel source of ``src/repro_torch/csrc/`` beside each
other, for the shapes benchmarks (``torch_spa_shapes.py``,
``torch_hash_shapes.py``, ``torch_bsr_shapes.py``).

A source is a dict of file name -> text: the kernel's ``.cu`` first, then
the headers it includes.  :func:`with_constants` replaces ``constexpr int``
constants, :func:`ablated` replaces exact pieces of text, :func:`build_all`
compiles each source into its own shared library (one ``nvcc`` process a
build, all started together) and binds the library's C entry points, and
:func:`using` makes the kernel wrappers launch through one of them.  Time
the builds with ``chip_smoke.event_ms``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")


def read_sources(path: str) -> dict:
    """The kernel source at ``path`` and the local headers it includes
    (``#include "name"``, from its folder), by file name, the source
    first."""
    folder = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        text = f.read()
    files = {os.path.basename(path): text}
    for name in re.findall(r'#include "([^"]+)"', text):
        with open(os.path.join(folder, name)) as f:
            files[name] = f.read()
    return files


def with_constants(files: dict, assignments: str) -> dict:
    """``files`` with each ``NAME=VALUE`` of the comma-separated
    ``assignments`` replacing ``constexpr int NAME`` in the one file that
    defines it."""
    files = dict(files)
    for item in assignments.split(","):
        name, value = item.split("=")
        hits = 0
        for fname, text in files.items():
            files[fname], n = re.subn(r"constexpr int %s = -?\d+;" % name,
                                      f"constexpr int {name} = {value};",
                                      text)
            hits += n
        if hits != 1:
            raise SystemExit(f"no single constant {name} in {sorted(files)}")
    return files


def ablated(files: dict, replacements, label: str) -> dict:
    """``files`` with each ``(old, new)`` of ``replacements`` applied where
    ``old`` occurs, which must be exactly once in all the files."""
    files = dict(files)
    for old, new in replacements:
        where = [f for f, text in files.items() if old in text]
        if len(where) != 1 or files[where[0]].count(old) != 1:
            raise SystemExit(f"ablation {label}: {old!r} not found once")
        files[where[0]] = files[where[0]].replace(old, new)
    return files


def build_all(sources: dict, subdir: str) -> dict:
    """Compile each build's source (its headers beside it) into its own
    shared library under ``build/<subdir>/<build>/``, all at once; print
    one JSON line a build with its registers and spills (``-Xptxas -v``);
    return build -> the loaded library, its entry points bound as
    ``repro_torch.kernels._build`` binds them."""
    from repro_torch.kernels import _build

    procs = {}
    for name, files in sources.items():
        out = os.path.join(ROOT, "build", subdir, name)
        os.makedirs(out, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(out, fname), "w") as f:
                f.write(text)
        lib = os.path.join(out, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             os.path.join(out, next(iter(files))), "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"build": name, "ptxas": re.findall(
            r"Compiling entry function '(\w+)'|(Used \d+ registers)|"
            r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes "
            r"spill loads)", log)}), flush=True)
        lib = ctypes.CDLL(path)
        for entry, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        if hasattr(lib, "repro_error_string"):
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(lib):
    """The kernel wrappers launch through ``lib`` inside the block."""
    from repro_torch.kernels import _build

    saved, _build._LIB = _build._LIB, lib
    try:
        yield
    finally:
        _build._LIB = saved
