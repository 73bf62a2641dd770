"""PyTorch/CUDA port of the SpGEMM system (the JAX package ``repro`` is the
reference it is held against).

Entry point: ``repro_torch.core.spgemm(a, b)`` — C = A·B on an NVIDIA card
through hand-written CUDA kernels for SPA, SPARS and HASH (``kernels/``,
``csrc/``); ``backend="torch"`` runs the product stream in PyTorch ops and
``backend="host"`` the numpy oracles.  This package imports ``torch`` and
never ``jax`` or ``repro``.
"""
