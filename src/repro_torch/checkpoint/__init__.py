"""Checkpoint substrate: the serving checkpoint shared with the JAX package."""

from .gbdt import load_gbdt, model_from_numpy, save_gbdt

__all__ = ["load_gbdt", "model_from_numpy", "save_gbdt"]
