"""Inference observability: the serving loop's latency record."""

from .predict import PredictReport

__all__ = ["PredictReport"]
