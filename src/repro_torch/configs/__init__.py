"""Architecture registry of the port: the configs ported so far (--arch <id>).

The JAX package's registry (``repro/configs``) holds ten; the port adds
each with the slice whose path runs it.  granite-20b's FFN widths size the
sparse FFN serving policy (``models.sparse_ffn``).
"""

from repro_torch.configs.granite_20b import CONFIG as GRANITE

ARCHS = {c.name: c for c in (GRANITE,)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return ARCHS[name]
