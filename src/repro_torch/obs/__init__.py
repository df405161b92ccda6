"""Observability: the serving loop's latency record and per-round
training telemetry (``TrainReport``, see :mod:`repro_torch.obs.report`)."""

from .predict import PredictReport
from .report import (TrainReport, collective_bytes_per_round,
                     mean_train_loss, round_report)

__all__ = [
    "PredictReport",
    "TrainReport",
    "collective_bytes_per_round",
    "mean_train_loss",
    "round_report",
]
