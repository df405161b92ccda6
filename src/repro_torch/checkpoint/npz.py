"""Flat-path npz checkpoints of the LM, shared with the JAX package.

The JAX package's ``checkpoint/npz.py`` writes a params pytree as one
``.npz`` per step: keys are paths such as ``layers/attn/wq/w``, the layer
axis is stacked first, weights are (d_in, d_out).  The port's module
names follow the same paths (``layers.3.attn.wq.w``), so a file written
by either package loads into the other; a moe model's router and experts
are ``layers/moe/router/w``, ``layers/moe/{wi,wg,wo}`` and
``layers/moe/shared/...``.  bf16 arrays, which numpy stores as raw
2-byte voids, are read back as bf16.  Writes are atomic (tmp + rename).

A decode state crosses the same way (``kv/k``, ``kv/v``, layer axis
first): :func:`decode_state_from_numpy` and :func:`decode_state_to_numpy`.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..kernels.ops import device_of
from ..models.model import DecoderLM, init_params

_SEP = "/"


def flat_key(name: str) -> tuple[str, int | None]:
    """The JAX path and layer index of a parameter name:
    ``layers.3.attn.wq.w`` -> (``layers/attn/wq/w``, 3)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return _SEP.join(["layers", *parts[2:]]), int(parts[1])
    return _SEP.join(parts), None


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if (arr.dtype.kind == "V" and arr.dtype.itemsize == 2) or \
            arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if not arr.flags.writeable:     # torch wants memory it may write
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


def params_from_numpy(cfg, flat, *, device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> DecoderLM:
    """The port's model from the JAX package's flat-path arrays.

    Args:
      cfg: the model's ArchConfig.
      flat: mapping of JAX paths (``embed/table``, ``layers/attn/wq/w``,
        ...) to numpy arrays, layer axis first; an open ``np.load`` file
        serves, each key read once.
      device: where the model lives (``"cuda"`` raises without a GPU).
      dtype: storage dtype of matmul weights, biases and the table, as in
        :func:`init_params`; RMSNorm scales stay float32.

    Raises KeyError on a missing or unexpected path, ValueError on a
    shape that does not match the config.
    """
    device = device_of(device)
    model = init_params(cfg, device="meta", dtype=dtype)
    by_key: dict[str, list] = {}
    for name, p in model.named_parameters():
        key, layer = flat_key(name)
        by_key.setdefault(key, []).append((name, layer, p))
    missing = sorted(set(by_key) - set(flat))
    extra = sorted(set(flat) - set(by_key))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing {missing}, unexpected {extra}")
    state = {}
    for key, params in by_key.items():
        arr = _from_numpy(flat[key])
        want = tuple(params[0][2].shape)
        if params[0][1] is not None:
            want = (len(params),) + want
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, the config "
                             f"wants {want}")
        for name, layer, p in params:
            t = arr if layer is None else arr[layer]
            state[name] = t.to(device=device, dtype=p.dtype, copy=True)
        del arr
    model.load_state_dict(state, strict=True, assign=True)
    return model


def load_checkpoint(path: str, cfg, *, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> DecoderLM:
    """Load a checkpoint written by either package's ``save_checkpoint``."""
    with np.load(path) as data:
        return params_from_numpy(cfg, data, device=device, dtype=dtype)


def to_numpy(model: DecoderLM) -> dict[str, np.ndarray]:
    """The model's parameters as JAX flat-path float32 arrays, layer axis
    first (a bf16 weight widens to float32 exactly)."""
    grouped: dict[str, list] = {}
    for name, p in model.named_parameters():
        key, _ = flat_key(name)
        grouped.setdefault(key, []).append(
            p.detach().to("cpu", torch.float32).numpy())
    return {key: (np.stack(arrs) if key.startswith("layers" + _SEP)
                  else arrs[0]) for key, arrs in grouped.items()}


def save_checkpoint(ckpt_dir: str, step: int, model: DecoderLM) -> str:
    """Write ``step_<step>.npz`` with the JAX package's keys and layout,
    float32, which its ``restore_checkpoint`` reads into an
    ``init_params`` target."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **to_numpy(model))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def decode_state_from_numpy(cfg, flat, *, device="cuda") -> dict:
    """The port's decode state from the JAX package's flattened one.

    ``flat`` maps ``kv/k`` and ``kv/v`` to (n_layers, B, L, Hkv, Dh)
    arrays, kept in their dtype (bf16 in the JAX package).  Raises
    KeyError on a missing or unexpected path, ValueError on a shape that
    does not match the config.
    """
    device = device_of(device)
    keys = {"kv/k": "k", "kv/v": "v"}
    if set(flat) != set(keys):
        raise KeyError(f"{cfg.name}: decode state keys {sorted(flat)}, "
                       f"want {sorted(keys)}")
    kv = {}
    for key, name in keys.items():
        arr = _from_numpy(flat[key])
        if arr.dim() != 5 or arr.shape[0] != cfg.n_layers or \
                tuple(arr.shape[3:]) != (cfg.n_kv_heads, cfg.head_dim):
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, the config "
                             f"wants ({cfg.n_layers}, B, L, "
                             f"{cfg.n_kv_heads}, {cfg.head_dim})")
        kv[name] = arr.to(device=device, copy=True)
    if kv["k"].shape != kv["v"].shape:
        raise ValueError(f"kv/k {tuple(kv['k'].shape)} and kv/v "
                         f"{tuple(kv['v'].shape)} differ")
    return {"kv": kv}


def decode_state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """A decode state as the JAX package's flat paths, float32 (a bf16
    cache widens exactly)."""
    return {f"kv/{name}": t.detach().to("cpu", torch.float32).numpy()
            for name, t in state["kv"].items()}
