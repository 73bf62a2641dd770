"""Launch of the port: the production and host meshes (``mesh``), the
cells' input specs (``specs``) and the dry run that sizes every
(architecture x shape) cell for a 16x16 or 2x16x16 mesh (``dryrun``:
``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
decode_32k``)."""
