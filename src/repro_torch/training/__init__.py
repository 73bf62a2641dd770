"""Training substrate: optimizer, schedules, data, checkpointing, loop.

The port of the JAX package's ``repro/training``; its ``opt_state_specs``
(a ``PartitionSpec`` tree) comes with the mesh."""

from repro_torch.training.checkpoint import (
    AsyncCheckpointer, latest_checkpoint, restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import DataConfig, SyntheticLoader, synth_batch
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_init, adamw_update,
)
from repro_torch.training.schedule import constant, warmup_cosine
from repro_torch.training.train_loop import (
    TrainConfig, Trainer, build_train_step, init_train_state,
)

__all__ = [
    "AsyncCheckpointer", "latest_checkpoint", "restore_checkpoint",
    "save_checkpoint", "DataConfig", "SyntheticLoader", "synth_batch",
    "AdamWConfig", "adamw_init", "adamw_update",
    "constant", "warmup_cosine", "TrainConfig", "Trainer",
    "build_train_step", "init_train_state",
]
