"""The LM: init, decoder block, backbone, hidden, forward, loss, decode.

A port of every family of the JAX package's ``models/model.py``: the
full-sequence forward (prefill) and one decode step against a KV cache
or a recurrent state.  Parameters live in ``nn.Module``s whose names
follow the JAX params pytree, so ``layers.3.attn.wq.w`` here is
``params["layers"]["attn"]["wq"]["w"][3]`` there (the JAX package stacks
the layer axis first for its ``lax.scan``; the port keeps one module per
layer and runs them in a Python loop).
The stacks, by family:

  dense | vlm   ``layers``: decoder blocks [attn + MLP], or [attn + MoE]
  | moe         (``models/moe.py``), whose router losses sum into ``aux``;
                the vlm family also ``patch_proj``, which projects the
                stub vision tower's patch embeddings, put before the text
                (their rows are trimmed after ``ln_f``)
  ssm (xlstm)   groups of (slstm_every - 1) mLSTM and one sLSTM:
                ``mlstm.{g}.{i}`` and ``slstm.{g}`` (``models/ssm.py``)
  hybrid        groups of [the shared attention block, then attn_every
  (zamba2)      Mamba2]: ONE ``shared_attn`` decoder block (the Zamba
                trick: the same parameters at the head of every group)
                and ``mamba.{g}.{i}``
  audio         an encoder-decoder: ``frame_proj`` and a sinusoid over the
  (whisper)     stub frame embeddings, ``enc_layers`` (non-causal decoder
                blocks with RoPE) and ``ln_enc``; then ``dec_layers``
                (causal), each followed by a cross-attention block of
                ``cross_layers`` (``ln``, ``attn``; no RoPE) over the
                encoder's output

The decode state is the JAX package's pytree, each leading axis as the
JAX package stacks it, so a JAX state converts 1:1
(``checkpoint.npz.decode_state_from_numpy``): ``{"kv": {"k", "v"}}``,
each (n_layers, B, L, Hkv, Dh), in the dense, vlm and moe families;
``{"mlstm", "slstm": (c, n, h, m)}`` in the ssm family; ``{"mamba",
"kv"}`` in the hybrid family, with one KV cache a group for the shared
block (n_grp, B, L, H, Dh); in the audio family ``{"kv", "cross_k",
"cross_v"}``, the cross-attention's K/V of the encoded frames (n_layers,
B, F, Hkv, Dh), filled once at prefill (``launch/serve.py``).  Recurrent
states are float32.  A decode step updates the state in place.

The config's execution knobs are read at call time: a model built for a
config runs under any config that differs from it only in those knobs
(``attn_impl``, the MoE layer's ``moe_groups``, ``moe_dispatch``,
``capacity_factor`` and ``router_aux_weight``, ``ssm_chunk`` and
``ssm_compute_dtype``, and the JAX compilation knobs, see
``configs/base.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers, ssm
from .attention import (Attention, attention, attention_decode, groupable,
                        init_kv_cache)
from .moe import MoE
from .sharding import constrain, distribute, unflatten
from ..kernels.ops import device_of

# fields of ArchConfig that change how a model runs, not its parameters
EXECUTION_FIELDS = ("name", "attn_impl", "attn_chunk", "causal_skip",
                    "scan_layers", "scan_chunks", "remat", "seq_shard",
                    "train_microbatches", "moe_groups", "moe_dispatch",
                    "capacity_factor", "router_aux_weight",
                    "long_context_window", "ssm_chunk", "ssm_compute_dtype")

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


class DecoderBlock(nn.Module):
    """Pre-norm ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``, or ``x +
    moe(ln2(x))`` in the moe family."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = layers.RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, **kw)
        self.ln2 = layers.RMSNorm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.moe, self.mlp = MoE(cfg, **kw), None
        else:
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)
            self.moe = None

    def _ffn(self, cfg, x):
        """``x + ffn(ln2(x))`` -> (x, the router loss, or None)."""
        z = self.ln2(x)
        if self.moe is None:
            return x + self.mlp(z), None
        y, aux = self.moe(cfg, z)
        return x + y, aux

    def forward(self, cfg, x, positions, *, window=0, causal=True):
        """x (B, S, D) -> (x, the router loss, or None)."""
        x = x + self.attn(cfg, self.ln1(x), positions, causal=causal,
                          window=window)
        x = constrain(x, "batch", "seq", "embed")
        x, aux = self._ffn(cfg, x)
        return constrain(x, "batch", "seq", "embed"), aux

    def decode(self, cfg, x, cache, pos, *, window=0):
        """One token x (B, 1, D) against this layer's ``cache`` (updated
        in place) -> x."""
        h, _ = attention_decode(self.attn, cfg, self.ln1(x), cache, pos,
                                window=window)
        return self._ffn(cfg, x + h)[0]


class CrossBlock(nn.Module):
    """The audio decoder's cross-attention: ``x + attn(ln(x), kv_x=the
    encoder's output)``, non-causal and without RoPE."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        self.ln = layers.RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, generator=generator, device=device,
                              dtype=dtype)

    def forward(self, cfg, x, positions, enc_out, enc_positions):
        return x + attention(self.attn, cfg, self.ln(x), positions,
                             causal=False, kv_x=enc_out,
                             kv_positions=enc_positions, use_rope=False)

    def decode(self, cfg, x, cross_k, cross_v):
        """One token x (B, 1, D) against the cached K/V of the encoded
        frames, (B, F, Hkv, Dh) each: plain float32 attention, as the JAX
        package writes it in ``jnp``."""
        b = x.shape[0]
        q = unflatten(self.attn.wq(self.ln(x)), cfg.n_heads, cfg.head_dim)
        g = cfg.n_heads // cfg.n_kv_heads
        qg = groupable(cfg, q).transpose(1, 2).reshape(
            b, cfg.n_kv_heads, g, 1, cfg.head_dim)
        # float32 (B, Hkv, F, Dh) laid out for the products, as
        # attention.decode_attend lays the cache out (a DTensor's einsum
        # over a transposed layout fails its view)
        kg, vg = (t.transpose(1, 2).to(
            torch.float32, memory_format=torch.contiguous_format)
            for t in (cross_k, cross_v))
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kg) / (
            cfg.head_dim ** 0.5)
        og = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1), vg)
        o = og.reshape(b, cfg.n_heads, 1, cfg.head_dim).transpose(1, 2)
        return x + self.attn.wo(o.reshape(b, 1, -1).to(x.dtype))


def sinusoidal(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) float32: ``sin`` then ``cos`` of ``pos / 10000^(2i / d)``,
    i < d / 2, as the JAX package's ``_sinusoidal``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _groups(cfg) -> tuple[int, int]:
    """(groups, layers of the group's own kind in a group) of the ssm and
    hybrid stacks: (n_layers // slstm_every, slstm_every - 1) mLSTM, or
    (n_layers // attn_every, attn_every) Mamba2."""
    if cfg.family == "ssm":
        return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


class DecoderLM(nn.Module):
    """Embedding, the family's layer stack, final RMSNorm, and tied logits
    (or an ``unembed`` linear map when ``cfg.tie_embeddings`` is
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
        if cfg.family in ("dense", "vlm", "moe"):
            self.layers = nn.ModuleList(DecoderBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
            if cfg.family == "vlm":
                self.patch_proj = layers.Linear(cfg.d_model, cfg.d_model,
                                                **kw)
            return
        if cfg.family == "audio":
            self.enc_layers = nn.ModuleList(
                DecoderBlock(cfg, **kw) for _ in range(cfg.n_encoder_layers))
            self.dec_layers = nn.ModuleList(DecoderBlock(cfg, **kw)
                                            for _ in range(cfg.n_layers))
            self.cross_layers = nn.ModuleList(CrossBlock(cfg, **kw)
                                              for _ in range(cfg.n_layers))
            self.ln_enc = layers.RMSNorm(cfg.d_model, device=device)
            self.frame_proj = layers.Linear(cfg.d_model, cfg.d_model, **kw)
            return
        n_grp, per = _groups(cfg)
        if cfg.family == "ssm":
            self.mlstm = nn.ModuleList(
                nn.ModuleList(ssm.MLSTM(cfg, **kw) for _ in range(per))
                for _ in range(n_grp))
            self.slstm = nn.ModuleList(ssm.SLSTM(cfg, **kw)
                                       for _ in range(n_grp))
        else:
            self.mamba = nn.ModuleList(
                nn.ModuleList(ssm.Mamba2(cfg, **kw) for _ in range(per))
                for _ in range(n_grp))
            self.shared_attn = DecoderBlock(cfg, **kw)

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

    def encode_audio(self, cfg, frames, *, dtype=layers.COMPUTE_DTYPE):
        """The audio encoder: stub frame embeddings (B, F, D), cast to
        ``dtype`` -> its output (B, F, D)."""
        frames = _on(frames, self.embed.table.device)
        x = self.frame_proj(frames.to(dtype))
        f = x.shape[1]
        x = x + sinusoidal(f, cfg.d_model, x.device).to(x.dtype)[None]
        pos = distribute(torch.arange(f, device=x.device).expand(
            x.shape[0], f), "batch", None)
        for block in self.enc_layers:
            x, _ = _remat(cfg, block, cfg, x, pos, causal=False)
        return self.ln_enc(x)

    def backbone(self, cfg, x, positions, *, window=0, enc_out=None):
        """The layer stack over x (B, S, D) -> (x, aux); aux is the sum of
        the layers' router losses (0 outside the moe family).  The audio
        decoder attends to ``enc_out`` (B, F, D) and, as in the JAX
        package, takes no window.  Each block runs under
        ``torch.utils.checkpoint`` where ``cfg.remat`` is set and the
        activations require a gradient (:func:`_remat`), where the JAX
        package's ``_maybe_remat`` wraps one: each dense, vlm and moe
        block, each audio encoder block and decoder layer (its block and
        cross-attention together), the mLSTM and Mamba2 layers; not the
        sLSTM layer nor zamba2's shared attention block."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "audio":
            b, f = enc_out.shape[:2]
            enc_pos = distribute(torch.arange(f, device=x.device).expand(
                b, f), "batch", None)
            for block, cross in zip(self.dec_layers, self.cross_layers):
                x = _remat(cfg, _audio_layer, cfg, x, positions, enc_out,
                           enc_pos, block, cross)
        elif cfg.family == "ssm":
            for group, sl in zip(self.mlstm, self.slstm):
                for ml in group:
                    x = _residual(x + _remat(cfg, ml, cfg, x)[0])
                x = _residual(x + sl(cfg, x)[0])
        elif cfg.family == "hybrid":
            for group in self.mamba:
                x, _ = self.shared_attn(cfg, x, positions, window=window)
                for mb in group:
                    x = _residual(x + _remat(cfg, mb, cfg, x)[0])
        else:
            for block in self.layers:
                x, a = _remat(cfg, block, cfg, x, positions, window=window)
                if a is not None:
                    aux = aux + a
        return x, aux

    def hidden(self, batch, *, cfg=None, window=0,
               dtype=layers.COMPUTE_DTYPE):
        """Final hidden states after ``ln_f``, the vlm family's patch rows
        trimmed: (x (B, S, D), aux).  Activations in ``dtype``: bf16 as in
        the JAX package, float32 where a check wants no rounding between
        the layers."""
        cfg = self._config(cfg)
        device = self.embed.table.device
        tokens = _on(batch["tokens"], device)
        x = constrain(self.embed(tokens, dtype=dtype), "batch", "seq",
                      "embed")
        n_front = 0
        if cfg.family == "vlm":
            patches = _on(batch["patches"], device)
            patches = self.patch_proj(patches.to(x.dtype))
            x = torch.cat([patches, x], 1)
            n_front = patches.shape[1]
        b, s = x.shape[:2]
        positions = distribute(torch.arange(s, device=x.device).expand(
            b, s), "batch", None)
        enc_out = (self.encode_audio(cfg, batch["frames"], dtype=x.dtype)
                   if cfg.family == "audio" else None)
        x, aux = self.backbone(cfg, x, positions, window=window,
                               enc_out=enc_out)
        return self.ln_f(x)[:, n_front:], aux

    def forward(self, batch, *, cfg=None, window=0,
                dtype=layers.COMPUTE_DTYPE):
        """``batch["tokens"]`` (B, S) ints, with ``"patches"`` (B, P, D) in
        the vlm family and ``"frames"`` (B, F, D) in the audio family ->
        (logits (B, S, V) in ``dtype``, bf16 by default, aux)."""
        x, aux = self.hidden(batch, cfg=cfg, window=window, dtype=dtype)
        return constrain(self.logits(x), "batch", "seq", "vocab"), aux

    def logits(self, x):
        """Tied logits, or the ``unembed`` map: x (..., D) -> (..., V)."""
        return (self.embed.unembed(x) if self.unembed is None
                else self.unembed(x))

    def decode_backbone(self, cfg, x, state, pos, *, window=0):
        """The layer stack over one token x (B, 1, D) at positions ``pos``
        (B,), against ``state`` (updated in place) -> x."""
        if cfg.family == "ssm":
            sl_state = state["slstm"]
            for g, (group, sl) in enumerate(zip(self.mlstm, self.slstm)):
                for i, ml in enumerate(group):
                    y, new = ssm.mlstm_step(ml, cfg, x, state["mlstm"][g, i])
                    state["mlstm"][g, i].copy_(new)
                    x = x + y
                y, new = ssm.slstm_step(sl, cfg, x,
                                        tuple(t[g] for t in sl_state))
                for t, n in zip(sl_state, new):
                    t[g].copy_(n)
                x = x + y
            return x
        kv = state["kv"]
        if cfg.family == "audio":
            for block, cross, k, v, ck, cv in zip(
                    self.dec_layers, self.cross_layers, kv["k"], kv["v"],
                    state["cross_k"], state["cross_v"]):
                x = block.decode(cfg, x, {"k": k, "v": v}, pos,
                                 window=window)
                x = cross.decode(cfg, x, ck, cv)
            return x
        if cfg.family == "hybrid":
            for g, group in enumerate(self.mamba):
                x = self.shared_attn.decode(
                    cfg, x, {"k": kv["k"][g], "v": kv["v"][g]}, pos,
                    window=window)
                for i, mb in enumerate(group):
                    y, new = ssm.mamba2_step(mb, cfg, x, state["mamba"][g, i])
                    state["mamba"][g, i].copy_(new)
                    x = x + y
            return x
        for block, k, v in zip(self.layers, kv["k"], kv["v"]):
            x = block.decode(cfg, x, {"k": k, "v": v}, pos, window=window)
        return x

    def decode_step(self, state, tokens, pos, *, cfg=None, window=0):
        """One decode step: ``tokens`` (B, 1) ints at absolute positions
        ``pos`` (B,) -> (logits (B, 1, V), state).

        ``state`` is :func:`init_decode_state`'s, updated IN PLACE and
        returned.
        """
        cfg = self._config(cfg)
        device = self.embed.table.device
        tokens, pos = _on(tokens, device), _on(pos, device)
        x = self.decode_backbone(cfg, self.embed(tokens), state, pos,
                                 window=window)
        return self.logits(self.ln_f(x)), state


def _residual(x):
    """The residual stream after a recurrent layer, placed as a decoder
    block leaves it (``constrain`` at the block's own sites).  The JAX
    package leaves these layers' outputs to XLA's propagation, which
    reduces the row-parallel product's partial sums over 'model' and
    keeps the batch on the batch axes; DTensor places each op by its own
    inputs alone, and without this pin moves the batch onto 'model' and
    back at every layer (xlstm-125m's step then moves more bytes a device
    on the 2 x 16 x 16 mesh than on 16 x 16)."""
    return constrain(x, "batch", "seq", "embed")


def _on(t, device) -> torch.Tensor:
    """``t`` (an array or a tensor) as a tensor on ``device``; a tensor
    there already (a ``DTensor`` of a sharded batch among them) as it
    is."""
    if isinstance(t, torch.Tensor) and t.device == torch.device(device):
        return t
    return torch.as_tensor(t, device=device)


def _audio_layer(cfg, x, positions, enc_out, enc_pos, block, cross):
    """An audio decoder layer: its block, then its cross-attention."""
    x, _ = block(cfg, x, positions)
    return cross(cfg, x, positions, enc_out, enc_pos)


def _remat(cfg, block, *args, **kw):
    """``block(*args, **kw)``; under ``torch.utils.checkpoint`` (its
    activations made again in the backward, the JAX package's
    ``jax.checkpoint`` of a block) where ``cfg.remat`` is set, grad mode is
    on and the block's input ``args[1]`` requires a gradient."""
    if cfg.remat and torch.is_grad_enabled() and args[1].requires_grad:
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return block(*args, **kw)


def loss_fn(model: DecoderLM, cfg, batch, *, window: int = 0,
            dtype: torch.dtype = layers.COMPUTE_DTYPE):
    """The training loss -> (loss + aux, (xent, aux)), 0-d float32 each.

    The next-token cross-entropy of ``batch["tokens"]`` (the vlm family's
    patches and the audio family's frames as in :meth:`DecoderLM.hidden`)
    against the tied table through :func:`layers.softmax_xent_chunked`, or
    the ``unembed`` logits; ``aux`` the moe family's router loss, with its
    gradient (0 elsewhere).  Activations in ``dtype``: bf16 as in the JAX
    package, float32 where a check wants no rounding between the layers.
    """
    x, aux = model.hidden(batch, cfg=cfg, window=window, dtype=dtype)
    tokens = _on(batch["tokens"], x.device)
    if model.unembed is None:
        loss = layers.softmax_xent_chunked(model.embed.table, x[:, :-1],
                                           tokens[:, 1:])
    else:
        loss = layers.softmax_xent(model.unembed(x)[:, :-1], tokens[:, 1:])
    return loss + aux, (loss, aux)


def init_params(cfg, *, generator: torch.Generator | None = None,
                device="cuda", dtype: torch.dtype = torch.bfloat16
                ) -> DecoderLM:
    """A randomly initialised model, as the JAX ``init_params`` draws it.

    The same tensors, shapes and distributions: ``fan_in ** -0.5`` normal
    weights, a 0.02-normal embedding table, RMSNorm scales of ones and
    zero biases; in the moe family the router and experts of
    ``models/moe.py``, in the ssm and hybrid families the blocks of
    ``models/ssm.py``.  The draws come from ``generator`` (a
    ``torch.Generator`` on ``device``), so the numbers differ from the JAX
    package's.  Matmul weights (the experts' too), biases and the table
    are stored in ``dtype`` (bf16 by default, see ``layers``); RMSNorm
    scales, the router, Mamba2's ``A_log``, ``D`` and ``dt_bias`` and
    sLSTM's ``r`` in float32.
    ``device="cuda"`` raises without a GPU; ``"meta"`` builds the shapes
    alone and needs no generator.
    """
    device = device_of(device)
    check_family(cfg)
    if generator is None and device.type != "meta":
        raise ValueError("init_params needs a torch.Generator on the "
                         "model's device")
    return DecoderLM(cfg, generator=generator, device=device, dtype=dtype)


def init_decode_state(cfg, batch: int, cache_len: int, *, device="cuda",
                      dtype: torch.dtype = layers.COMPUTE_DTYPE,
                      frames: int | None = None) -> dict:
    """The decode state, as the JAX package's ``init_decode_state`` lays
    it out.  KV caches (zeros in ``dtype``, bf16 as in the JAX package):
    ``{"kv": {"k", "v"}}``, each (n_layers, batch, cache_len, Hkv, Dh), in
    the dense, vlm and moe families; in the audio family also
    ``"cross_k"`` and ``"cross_v"``, each (n_layers, batch, frames, Hkv,
    Dh) (``frames`` defaults to ``cfg.n_frontend_tokens``); in the hybrid
    family one cache a group,
    (n_grp, batch, cache_len, H, Dh), beside ``"mamba"`` (n_grp,
    attn_every, batch, nh, N, P).  The ssm family keeps no cache:
    ``"mlstm"`` (n_grp, slstm_every - 1, batch, H, dh, dh + 1) and
    ``"slstm"`` (c, n, h, m), each led by n_grp, m at -1e30.  Recurrent
    states are float32 zeros.  ``device="cuda"`` raises without a GPU."""
    check_family(cfg)
    device = device_of(device)
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.family == "ssm":
        n_grp, n_ml = _groups(cfg)
        sl = ssm.slstm_init_state(cfg, n_grp * batch, device=device)
        return {"mlstm": torch.zeros(
                    (n_grp, n_ml, *ssm.mlstm_state_shape(cfg, batch)), **f32),
                "slstm": tuple(t.view(n_grp, batch, *t.shape[1:])
                               for t in sl)}
    n_kv = (_groups(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers)
    kv = init_kv_cache(cfg, n_kv * batch, cache_len, dtype, device=device)
    state = {"kv": {name: t.view(n_kv, batch, *t.shape[1:])
                    for name, t in kv.items()}}
    if cfg.family == "hybrid":
        state["mamba"] = torch.zeros(
            (*_groups(cfg), *ssm.mamba2_state_shape(cfg, batch)), **f32)
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, frames or cfg.n_frontend_tokens,
                 cfg.n_kv_heads, cfg.head_dim)
        for name in ("cross_k", "cross_v"):
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
    return state
