"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device with no card present raises.

    ``"cpu"`` is accepted only when asked for: it runs every kernel's plain
    PyTorch version (the CPU tests do this).  ``"meta"``, also only when
    asked for, gives tensors with a shape and a dtype and no storage: the
    launch dry run (``repro_torch.launch.dryrun``) traces a step on them.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; 'cuda', 'cpu' or "
                         "'meta'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain versions on the host")
    return dev
