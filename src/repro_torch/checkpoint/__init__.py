"""Checkpoint substrate: the serving checkpoint and the LM's flat-path
checkpoint, both shared with the JAX package."""

from .gbdt import load_gbdt, model_from_numpy, save_gbdt
from .npz import (latest_step, load_checkpoint, params_from_numpy,
                  restore_checkpoint, save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "load_gbdt", "model_from_numpy",
           "params_from_numpy", "restore_checkpoint", "save_checkpoint",
           "save_gbdt"]
