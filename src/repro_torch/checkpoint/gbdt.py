"""GBDT model checkpointing for serving, and carrying a model across.

A model round-trips through one .npz file with the JAX package's schema
(``repro.checkpoint.GBDTModel/v1``) and keys: the stacked Forest arrays,
the candidate grid, the base score, and the :class:`GBDTConfig` as a
JSON string.  Either package loads the other's file.  Writes are atomic
(tmp + rename), and a reloaded model predicts bit-identically.

:func:`model_from_numpy` is the one way parameters enter the port: from
a checkpoint (:func:`load_gbdt`), from a synthetic forest, or straight
from the JAX package's arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from ..core import boosting, tree as tree_lib

_SCHEMA = "repro.checkpoint.GBDTModel/v1"
_FOREST_KEYS = ("feature", "split_bin", "threshold", "leaf_value")
_DTYPES = {"feature": np.int32, "split_bin": np.int32,
           "threshold": np.float32, "leaf_value": np.float32}


def model_from_numpy(arrays, config, base_score: float,
                     device="cuda") -> boosting.GBDTModel:
    """Build a model on ``device`` from numpy parameters.

    Args:
      arrays: mapping with ``forest/feature``, ``forest/split_bin``,
        ``forest/threshold``, ``forest/leaf_value`` and ``candidates``
        (the JAX package's ``GBDTModel`` fields, as in its checkpoint).
      config: the config as a dict (or a :class:`GBDTConfig`).
      base_score: the model's base margin.
      device: where the model lives; 'cuda' raises if there is no GPU.
    """
    device = boosting.device_of(device)
    if isinstance(config, dict):
        config = boosting.GBDTConfig(**config)
    forest = {}
    for key in _FOREST_KEYS:
        a = np.asarray(arrays[f"forest/{key}"])
        if a.dtype != _DTYPES[key]:
            raise TypeError(f"forest/{key} must be {np.dtype(_DTYPES[key])}, "
                            f"got {a.dtype}")
        forest[key] = a
    cands = np.asarray(arrays["candidates"], np.float32)
    if cands.ndim != 3:
        raise ValueError(f"candidates must be (rounds, f, k), got shape "
                         f"{cands.shape}")
    n_inner = 2 ** config.max_depth - 1
    if (forest["feature"].shape[1:] != (n_inner,)
            or forest["leaf_value"].shape[1:] != (n_inner + 1,)):
        raise ValueError(f"forest shapes {forest['feature'].shape} / "
                         f"{forest['leaf_value'].shape} do not fit "
                         f"max_depth={config.max_depth}")
    n_features = cands.shape[1]
    if forest["feature"].size and not (
            -1 <= forest["feature"].min()
            and forest["feature"].max() < n_features):
        raise ValueError(f"forest/feature ids must lie in [-1, "
                         f"{n_features})")
    return boosting.GBDTModel(
        config=config,
        forest=tree_lib.Forest(**{k: torch.tensor(v, device=device)
                                  for k, v in forest.items()}),
        base_score=float(base_score),
        candidates=torch.tensor(cands, device=device))


def save_gbdt(path: str, model: boosting.GBDTModel) -> str:
    """Serialize a model to one .npz file (atomic write)."""
    payload = {
        "schema": np.array(_SCHEMA),
        "config_json": np.array(json.dumps(dataclasses.asdict(model.config))),
        "base_score": np.float64(model.base_score),
        "candidates": model.candidates.cpu().numpy(),
    }
    for key in _FOREST_KEYS:
        payload[f"forest/{key}"] = getattr(model.forest, key).cpu().numpy()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def load_gbdt(path: str, device="cuda") -> boosting.GBDTModel:
    """Restore a model saved by either package's ``save_gbdt``."""
    with np.load(path) as data:
        schema = str(data["schema"])
        if schema != _SCHEMA:
            raise ValueError(
                f"unexpected checkpoint schema {schema!r} (want {_SCHEMA!r})")
        return model_from_numpy(
            {k: data[k] for k in data.files},
            json.loads(str(data["config_json"])),
            float(data["base_score"]), device)
