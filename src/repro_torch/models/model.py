"""The dense decoder LM: init, decoder block, backbone, hidden, forward.

A port of the ``dense`` family of the JAX package's ``models/model.py``
(prefill: the full-sequence forward).  Parameters live in ``nn.Module``s
whose names follow the JAX params pytree, so ``layers.3.attn.wq.w`` here
is ``params["layers"]["attn"]["wq"]["w"][3]`` there (the JAX package
stacks the layer axis first for its ``lax.scan``; the port keeps one
module per layer and runs them in a Python loop).

The config's execution knobs are read at call time: a model built for a
config runs under any config that differs from it only in those knobs
(``attn_impl`` and the JAX compilation knobs, see ``configs/base.py``).
Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import layers
from .attention import Attention
from ..kernels.ops import device_of

# fields of ArchConfig that change how a model runs, not its parameters
EXECUTION_FIELDS = ("name", "attn_impl", "attn_chunk", "causal_skip",
                    "scan_layers", "scan_chunks", "remat", "seq_shard",
                    "train_microbatches", "moe_groups", "moe_dispatch",
                    "long_context_window")

_NOT_PORTED = {
    "vlm": "ROADMAP queue 1 item 8 (the vlm family)",
    "moe": "ROADMAP queue 1 item 9 (the moe family)",
    "ssm": "ROADMAP queue 1 item 10 (the ssm and hybrid families)",
    "hybrid": "ROADMAP queue 1 item 10 (the ssm and hybrid families)",
    "audio": "ROADMAP queue 1 item 11 (the audio family)",
}


def check_family(cfg) -> None:
    if cfg.family == "dense":
        return
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")


class DecoderBlock(nn.Module):
    """Pre-norm ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = layers.RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, **kw)
        self.ln2 = layers.RMSNorm(cfg.d_model, device=device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)

    def forward(self, cfg, x, positions, *, window=0, causal=True):
        x = x + self.attn(cfg, self.ln1(x), positions, causal=causal,
                          window=window)
        return x + self.mlp(self.ln2(x))


class DecoderLM(nn.Module):
    """Embedding, ``cfg.n_layers`` decoder blocks, final RMSNorm, and tied
    logits (or an ``unembed`` linear map when ``cfg.tie_embeddings`` is
    false)."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.ln_f = layers.RMSNorm(cfg.d_model, device=device)
        self.unembed = (None if cfg.tie_embeddings else
                        layers.Linear(cfg.d_model, cfg.vocab_size, **kw))
        self.layers = nn.ModuleList(DecoderBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))

    def _config(self, cfg):
        """``cfg`` (default: the model's own), checked to describe the
        same parameters as the model's."""
        if cfg is None:
            return self.cfg
        same = dataclasses.replace(
            cfg, **{f: getattr(self.cfg, f) for f in EXECUTION_FIELDS})
        if same != self.cfg:
            raise ValueError(f"config {cfg.name!r} does not describe this "
                             f"model's parameters ({self.cfg.name!r})")
        return cfg

    def backbone(self, cfg, x, positions, *, window=0):
        """The layer stack over x (B, S, D) -> (x, aux); aux is 0 for the
        dense family (the JAX package's MoE router loss)."""
        for block in self.layers:
            x = block(cfg, x, positions, window=window)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def hidden(self, batch, *, cfg=None, window=0):
        """Final hidden states after ``ln_f``: (x (B, S, D), aux)."""
        cfg = self._config(cfg)
        tokens = torch.as_tensor(batch["tokens"],
                                 device=self.embed.table.device)
        b, s = tokens.shape
        x = self.embed(tokens)
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, aux = self.backbone(cfg, x, positions, window=window)
        return self.ln_f(x), aux

    def forward(self, batch, *, cfg=None, window=0):
        """``batch["tokens"]`` (B, S) ints -> (logits (B, S, V) in bf16,
        aux)."""
        x, aux = self.hidden(batch, cfg=cfg, window=window)
        logits = (self.embed.unembed(x) if self.unembed is None
                  else self.unembed(x))
        return logits, aux


def init_params(cfg, *, generator: torch.Generator | None = None,
                device="cuda", dtype: torch.dtype = torch.bfloat16
                ) -> DecoderLM:
    """A randomly initialised model, as the JAX ``init_params`` draws it.

    The same tensors, shapes and distributions: ``fan_in ** -0.5`` normal
    weights, a 0.02-normal embedding table, RMSNorm scales of ones and
    zero biases.  The draws come from ``generator`` (a ``torch.Generator``
    on ``device``), so the numbers differ from the JAX package's.  Matmul
    weights, biases and the table are stored in ``dtype`` (bf16 by
    default, see ``layers``); RMSNorm scales in float32.
    ``device="cuda"`` raises without a GPU; ``"meta"`` builds the shapes
    alone and needs no generator.
    """
    device = device_of(device)
    check_family(cfg)
    if generator is None and device.type != "meta":
        raise ValueError("init_params needs a torch.Generator on the "
                         "model's device")
    return DecoderLM(cfg, generator=generator, device=device, dtype=dtype)
