"""Data substrate: synthetic tabular datasets (a numpy-only copy of the
JAX package's) and the LM token pipeline."""

from .tabular import (DATASET_NAMES, ar1_series, friedman1,
                      gaussian_classification, make_dataset)
from .tokens import TokenPipeline

__all__ = ["DATASET_NAMES", "ar1_series", "friedman1",
           "gaussian_classification", "make_dataset", "TokenPipeline"]
