"""Fault-tolerant checkpointing: atomic, async, checksummed.

The port of the JAX package's ``repro/training/checkpoint.py``, on the
reference's on-disk format, so that a checkpoint either package writes
restores in the other: ``<dir>/step_<N>/`` holds one ``leaf_<i>.npy`` per
tree leaf (numbered in the sorted order of their ``/``-joined key paths)
and ``manifest.json`` ``{key -> {file, shape, dtype, crc32}}``.  Writes go
to a ``.tmp`` directory first and are ``os.replace``'d into place, so
readers never observe a partial checkpoint; the checksum catches torn
files; ``keep=`` drops the oldest.

A bf16 leaf is stored as its two bytes an element, a ``V2`` void array
with manifest dtype ``"bfloat16"``, as the reference's ``ml_dtypes``
array is saved; the crc32 is over the same bytes.  Restore places each
leaf on its template leaf's device and dtype; the reference's
``shardings=`` (its elastic re-shard across devices) is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.training.tree import tree_map, tree_paths


def _to_numpy(leaf: torch.Tensor) -> tuple:
    """(host array, manifest dtype) of a tensor."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None,
                    keep: int = 3) -> str:
    """Blocking atomic save. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(tree_paths(tree).items())):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": _crc(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


class AsyncCheckpointer:
    """Snapshot to the host on the caller thread, write on a background
    thread.  The snapshot is a copy: the train step updates the state in
    place while the thread writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree, extra=None):
        self.wait()
        host = tree_map(lambda x: x.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra, self.keep)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            if best is None or int(m.group(1)) > best[0]:
                best = (int(m.group(1)), os.path.join(directory, name))
    return best[1] if best else None


def restore_checkpoint(path: str, template, verify: bool = True):
    """Load into ``template``'s structure, each leaf on its template
    leaf's device and dtype.  Returns (tree, step, extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]

    def load(key, like):
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        meta = leaves[key]
        arr = np.load(os.path.join(path, meta["file"]))
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"checksum mismatch in {path}:{key}")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"expected {tuple(like.shape)}")
        return _from_numpy(arr, meta["dtype"]).to(device=like.device,
                                                  dtype=like.dtype)

    # tree_map visits the template's leaves in the order tree_paths lists
    keys = iter(tree_paths(template))
    tree = tree_map(lambda like: load(next(keys), like), template)
    return tree, manifest["step"], manifest.get("extra", {})


def _gc(directory: str, keep: int):
    ckpts = sorted(
        (name for name in os.listdir(directory)
         if re.fullmatch(r"step_\d+", name)))
    for name in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
