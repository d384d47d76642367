"""Checkpoints in the JAX package's npz + json format, readable by both."""
from repro_torch.checkpoint.checkpoint import (latest_flat_step, latest_step,
                                               restore_flat, restore_pytree,
                                               save_flat, save_pytree)

__all__ = ["save_pytree", "restore_pytree", "latest_step",
           "save_flat", "restore_flat", "latest_flat_step"]
