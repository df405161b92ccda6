"""Flat-path npz checkpoints of the LM, shared with the JAX package.

The JAX package's ``checkpoint/npz.py`` writes a params pytree as one
``.npz`` per step: keys are paths such as ``layers/attn/wq/w``, stacked
layer axes first, weights are (d_in, d_out).  The port's module names
follow the same paths (``layers.3.attn.wq.w``), so a file written by
either package loads into the other.  The stacks: ``layers`` (one axis;
a moe model's router and experts are ``layers/moe/router/w``,
``layers/moe/{wi,wg,wo}`` and ``layers/moe/shared/...``), the audio
family's ``enc_layers``, ``dec_layers`` and ``cross_layers`` (one axis
each), ``slstm`` (one axis, the group), ``mlstm`` and ``mamba`` (two: the
group, then the layer in it); ``shared_attn``, ``patch_proj``,
``frame_proj`` and ``ln_enc`` are not stacked.  bf16 arrays, which numpy
stores as raw 2-byte voids, are read back as bf16.  Writes are atomic
(tmp + rename).  A training checkpoint adds the AdamW state under the
JAX launcher's keys (:func:`save_checkpoint` with ``opt_state``,
:func:`restore_checkpoint`, :func:`latest_step`), so a run of either
package resumes the other's.

A decode state crosses the same way (:func:`decode_state_from_numpy`,
:func:`decode_state_to_numpy`): ``kv/k``, ``kv/v``, ``cross_k``,
``cross_v``, ``mamba``, ``mlstm`` and the sLSTM tuple's ``slstm/#0`` ...
``slstm/#3`` (the JAX package's key for a tuple index), leading axes as
the JAX package stacks them.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from ..kernels.ops import device_of
from ..models.model import DecoderLM, init_decode_state, init_params

_SEP = "/"
# the stacked axes in front of each stack's parameters
_STACKED = {"layers": 1, "enc_layers": 1, "dec_layers": 1,
            "cross_layers": 1, "slstm": 1, "mlstm": 2, "mamba": 2}


def flat_key(name: str) -> tuple[str, tuple[int, ...] | None]:
    """The JAX path and stack index of a parameter name:
    ``layers.3.attn.wq.w`` -> (``layers/attn/wq/w``, (3,)),
    ``mlstm.1.2.up.w`` -> (``mlstm/up/w``, (1, 2)), ``shared_attn.ln1.scale``
    -> (``shared_attn/ln1/scale``, None)."""
    parts = name.split(".")
    n = _STACKED.get(parts[0], 0)
    if not n:
        return _SEP.join(parts), None
    return (_SEP.join([parts[0], *parts[1 + n:]]),
            tuple(int(i) for i in parts[1:1 + n]))


def _stack_shape(indices) -> tuple[int, ...]:
    """The stacked axes' sizes that ``indices`` (each a tuple) fill."""
    return tuple(max(i[a] for i in indices) + 1
                 for a in range(len(indices[0])))


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
        key, index = flat_key(name)
        by_key.setdefault(key, []).append((name, index, p))
    missing = sorted(set(by_key) - set(flat))
    extra = sorted(set(flat) - set(by_key))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing {missing}, unexpected {extra}")
    state = {}
    for key, params in by_key.items():
        arr = _from_numpy(flat[key])
        want = tuple(params[0][2].shape)
        if params[0][1] is not None:
            want = _stack_shape([i for _, i, _ in params]) + want
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, the config "
                             f"wants {want}")
        for name, index, p in params:
            t = arr if index is None else arr[index]
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
    """The model's parameters as JAX flat-path float32 arrays, stacked axes
    first (a bf16 weight widens to float32 exactly)."""
    return _stacked(model.named_parameters())


def _stacked(named) -> dict[str, np.ndarray]:
    """(parameter name, tensor) pairs -> JAX flat-path float32 arrays,
    stacked axes first."""
    grouped: dict[str, list] = {}
    for name, p in named:
        key, index = flat_key(name)
        grouped.setdefault(key, []).append(
            (index, p.detach().to("cpu", torch.float32).numpy()))
    out = {}
    for key, arrs in grouped.items():
        if arrs[0][0] is None:
            out[key] = arrs[0][1]
            continue
        stacked = np.empty(_stack_shape([i for i, _ in arrs])
                           + arrs[0][1].shape, np.float32)
        for index, arr in arrs:
            stacked[index] = arr
        out[key] = stacked
    return out


def save_checkpoint(ckpt_dir: str, step: int, model: DecoderLM,
                    opt_state: dict | None = None) -> str:
    """Write ``step_<step>.npz`` with the JAX package's keys and layout,
    float32, which its ``restore_checkpoint`` reads into an
    ``init_params`` target; with ``opt_state`` (``optim.adamw_init``'s) a
    training checkpoint, the JAX launcher's ``{"params", "opt": {"m", "v",
    "step"}}`` (keys ``params/...``, ``opt/m/...``, ``opt/v/...`` and
    ``opt/step``, int32)."""
    flat = to_numpy(model)
    if opt_state is not None:
        flat = {f"params{_SEP}{k}": a for k, a in flat.items()}
        for part in ("m", "v"):
            flat.update({f"opt{_SEP}{part}{_SEP}{k}": a for k, a in
                         _stacked(opt_state[part].items()).items()})
        flat[f"opt{_SEP}step"] = np.asarray(int(opt_state["step"]), np.int32)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


@torch.no_grad()
def _load_into(named, flat, prefix: str) -> None:
    """Copy the arrays at ``prefix`` + each parameter's JAX path into the
    (name, tensor) pairs, in place, in each tensor's dtype."""
    arrays: dict[str, torch.Tensor] = {}
    for name, t in named:
        key, index = flat_key(name)
        key = prefix + key
        if key not in arrays:
            if key not in flat:
                raise KeyError(f"checkpoint missing {key!r}")
            arrays[key] = _from_numpy(flat[key])
        arr = arrays[key] if index is None else arrays[key][index]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(arr.shape)} vs target {tuple(t.shape)}")
        t.copy_(arr)


def restore_checkpoint(path: str, model: DecoderLM, opt_state: dict):
    """Read a training checkpoint written by either package (``params/...``
    and ``opt/...``, as the JAX launcher writes it) into ``model`` and
    ``opt_state`` IN PLACE -> (model, opt_state).  (A params checkpoint
    loads with :func:`load_checkpoint`.)  Raises KeyError on a missing
    path, ValueError on a shape that does not match.
    """
    with np.load(path) as data:
        _load_into(model.named_parameters(), data, f"params{_SEP}")
        for part in ("m", "v"):
            _load_into(opt_state[part].items(), data,
                       f"opt{_SEP}{part}{_SEP}")
        step = int(data[f"opt{_SEP}step"])
    opt_state["step"] = torch.tensor(step, dtype=torch.int32,
                                     device=opt_state["step"].device)
    return model, opt_state


def latest_step(ckpt_dir: str) -> int | None:
    """The largest ``step`` of the ``step_<step>.npz`` files in
    ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _map_state(state, fn, path: str = ""):
    """``state`` with each tensor replaced by ``fn(its JAX flat path,
    it)``: dict keys join with ``/``, a tuple's index is ``#i``."""
    if isinstance(state, dict):
        return {k: _map_state(v, fn, f"{path}{_SEP}{k}" if path else k)
                for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_map_state(t, fn, f"{path}{_SEP}#{i}")
                     for i, t in enumerate(state))
    return fn(path, state)


def flat_state(state: dict) -> dict:
    """A decode state's tensors by their JAX flat paths (``kv/k``,
    ``mamba``, ``slstm/#3``, ...)."""
    out = {}
    _map_state(state, out.__setitem__)
    return out


def decode_state_from_numpy(cfg, flat, *, device="cuda") -> dict:
    """The port's decode state from the JAX package's flattened one.

    ``flat`` maps the state's flat paths (``kv/k`` and ``kv/v``, with
    ``mamba`` in the hybrid family and ``cross_k`` and ``cross_v`` in the
    audio family; ``mlstm`` and ``slstm/#0`` ...
    ``slstm/#3`` in the ssm family) to arrays shaped as
    :func:`init_decode_state` lays them out, kept in their dtype (bf16
    caches and float32 recurrent states in the JAX package).  Raises
    KeyError on a missing or unexpected path, ValueError on a shape that
    does not match the config.
    """
    device = device_of(device)
    anchor = "mlstm" if cfg.family == "ssm" else "kv/k"
    if anchor not in flat:
        raise KeyError(f"{cfg.name}: decode state keys {sorted(flat)}, no "
                       f"{anchor!r}")
    lead = 2 if cfg.family == "ssm" else 1          # the batch's axis
    batch = flat[anchor].shape[lead]
    length = 0 if cfg.family == "ssm" else flat[anchor].shape[2]
    frames = flat["cross_k"].shape[2] if "cross_k" in flat else None
    state = init_decode_state(cfg, batch, length, device="meta",
                              frames=frames)
    want = flat_state(state)
    if set(flat) != set(want):
        raise KeyError(f"{cfg.name}: decode state keys {sorted(flat)}, "
                       f"want {sorted(want)}")
    got = {}
    for key, t in want.items():
        arr = _from_numpy(flat[key])
        if arr.shape != t.shape:
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, the config "
                             f"wants {tuple(t.shape)}")
        got[key] = arr.to(device=device, copy=True)
    return _map_state(state, lambda key, _: got[key])


def decode_state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """A decode state as the JAX package's flat paths, float32 (a bf16
    cache widens exactly)."""
    return {key: t.detach().to("cpu", torch.float32).numpy()
            for key, t in flat_state(state).items()}
