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
leaf on its template leaf's device and dtype, or with ``shardings=`` (a
tree of ``distributed.sharding.NamedSharding``) on the device its mesh
holds: the reference's elastic re-shard, on the one device a process
drives.  A sharding's spec must fit its leaf's rank and divide its
dimensions, as ``jax.device_put`` demands; a mesh with no devices (the
production mesh) or over several distinct devices is refused, since one
process holds no global array across cards.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, mesh_axis_sizes
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


def _sharding_devices(template, shardings) -> dict:
    """``{key: device}`` of each leaf under its sharding in ``shardings``
    (the template's structure), after checking each spec against its
    leaf's rank and dimensions and each mesh's devices."""
    specs = tree_paths(shardings) if isinstance(shardings, dict) \
        else {"": shardings}
    leaves = tree_paths(template)
    if specs.keys() != leaves.keys():
        raise ValueError(
            "shardings do not have the template's structure: "
            f"{sorted(set(specs) ^ set(leaves))[:8]}")
    out = {}
    for key, like in leaves.items():
        sh = specs[key]
        if not isinstance(sh, NamedSharding):
            raise ValueError(f"sharding of {key} is {sh!r}, not a "
                             "NamedSharding")
        mesh, spec = sh.mesh, tuple(sh.spec)
        if len(spec) > like.ndim:
            raise ValueError(f"sharding {spec} of {key} has {len(spec)} "
                             f"entries for a leaf of rank {like.ndim}")
        sizes = mesh_axis_sizes(mesh)
        for dim, part in zip(like.shape, spec):
            axes = () if part is None else \
                part if isinstance(part, tuple) else (part,)
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"sharding {spec} of {key}: dimension "
                                 f"{dim} does not divide over {axes} "
                                 f"({n} positions)")
        if mesh.devices is None:
            raise ValueError(f"sharding of {key} is on {mesh!r}, which "
                             "holds no devices (a mesh that is sized, "
                             "never run)")
        devices = set(mesh.devices)
        if len(devices) != 1:
            raise ValueError(f"sharding of {key} spans {len(devices)} "
                             "devices; one process restores onto one")
        out[key] = mesh.devices[0]
    return out


def restore_checkpoint(path: str, template, shardings=None,
                       verify: bool = True):
    """Load into ``template``'s structure, each leaf on its template
    leaf's device and dtype, or on its sharding's device when
    ``shardings`` (the same structure) is given.  Returns (tree, step,
    extra)."""
    placed = None if shardings is None \
        else _sharding_devices(template, shardings)
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
        device = like.device if placed is None else placed[key]
        return _from_numpy(arr, meta["dtype"]).to(device=device,
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
