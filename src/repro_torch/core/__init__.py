"""Core library: binning, split proposal and the quantile sketches, tree
growth, the trainer and the model, the distributed trainer, the batched
inference engine, and the Theorem 1 rank-error machinery."""

from . import (binning, boosting, distributed, predict, proposal,
               rank_error, sketch, tree)

__all__ = ["binning", "boosting", "distributed", "predict", "proposal",
           "rank_error", "sketch", "tree"]
