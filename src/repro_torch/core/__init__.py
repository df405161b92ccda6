"""Core library: binning, split proposal and the quantile sketches, tree
growth, the trainer and the model, the batched inference engine, and the
Theorem 1 rank-error machinery."""

from . import (binning, boosting, predict, proposal, rank_error, sketch,
               tree)

__all__ = ["binning", "boosting", "predict", "proposal", "rank_error",
           "sketch", "tree"]
