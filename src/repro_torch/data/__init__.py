"""Synthetic tabular datasets (a numpy-only copy of the JAX package's)."""

from .tabular import (DATASET_NAMES, ar1_series, friedman1,
                      gaussian_classification, make_dataset)

__all__ = ["DATASET_NAMES", "ar1_series", "friedman1",
           "gaussian_classification", "make_dataset"]
