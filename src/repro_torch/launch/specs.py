"""Input/state stand-ins on the meta device, and their spec tuples.

A port of the JAX package's ``launch/specs.py``.  ``input_specs`` gives
meta tensors, in the JAX package's shapes and dtypes, for every model
input of an (arch x input-shape) combination: no allocation, which is
what lets the dry-run (``launch/dryrun.py``) count a step of any size on
any machine.  ``decode_state_specs`` is ``models.init_decode_state`` on
the meta device.  The shardings are spec tuples
(``launch/shardings.py``), the decode state's in the state's own nesting.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, InputShape
from ..models import layers, model, ssm
from .mesh import batch_axes
from .shardings import maybe


def _batch_axis(mesh, b: int):
    axes = batch_axes(mesh)
    return maybe(tuple(axes) if len(axes) > 1 else axes[0], b, mesh)


def decode_window(cfg: ArchConfig, shape: InputShape) -> int:
    """Sliding window for the decode path (long_500k on quadratic archs)."""
    if shape.name == "long_500k" and not cfg.is_recurrent:
        return cfg.long_context_window
    return cfg.sliding_window


def cache_len(cfg: ArchConfig, shape: InputShape) -> int:
    w = decode_window(cfg, shape)
    return min(shape.seq_len, w) if w > 0 else shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta tensors for the step function's data arguments."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, shape.seq_len), torch.int32)}
        if cfg.family == "vlm":
            out["patches"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                   layers.COMPUTE_DTYPE)
        if cfg.family == "audio":
            out["frames"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                  layers.COMPUTE_DTYPE)
        return out
    # decode: one new token against a seq_len-sized cache/state
    return {"tokens": _meta((b, 1), torch.int32),
            "pos": _meta((b,), torch.int32)}


def input_shardings(specs: dict, mesh) -> dict:
    return {k: (_batch_axis(mesh, v.shape[0]), *([None] * (v.ndim - 1)))
            for k, v in specs.items()}


def decode_state_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The decode state (``models.init_decode_state``) on the meta
    device."""
    return model.init_decode_state(cfg, shape.global_batch,
                                   cache_len(cfg, shape), device="meta")


def decode_state_shardings(cfg: ArchConfig, shape: InputShape,
                           mesh) -> dict:
    """Spec tuples of the decode state, nested as the state is."""
    b = shape.global_batch
    ba = _batch_axis(mesh, b)
    mm = maybe("model", cfg.n_kv_heads, mesh)
    # few-kv-head archs (MQA/GQA<16): shard the head_dim instead so the
    # 32k cache still divides across the tensor-parallel axis
    md = None if mm is not None else maybe("model", cfg.head_dim, mesh)

    def kv_spec(rank):
        # (layers?, B, L, Hkv, Dh)
        return (*([None] * (rank - 4)), ba, None, mm, md)

    kv = {"kv": {"k": kv_spec(5), "v": kv_spec(5)}}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return kv
    if fam == "ssm":
        mh = maybe("model", cfg.n_heads, mesh)
        sl = tuple((None, ba, mh) if r == 3 else (None, ba, mh, None)
                   for r in (4, 4, 4, 3))
        return {"mlstm": (None, None, ba, mh, None, None), "slstm": sl}
    if fam == "hybrid":
        _, nh = ssm.mamba2_dims(cfg)
        mh = maybe("model", nh, mesh)
        return {"mamba": (None, None, ba, mh, None, None), **kv}
    if fam == "audio":
        return {**kv, "cross_k": kv_spec(5), "cross_v": kv_spec(5)}
    raise ValueError(fam)
