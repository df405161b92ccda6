"""Core library: the forest, its binning, the batched inference engine
and the model.  Tree growth and the trainers arrive with the training
slice."""

from . import binning, boosting, predict, tree

__all__ = ["binning", "boosting", "predict", "tree"]
