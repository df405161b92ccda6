"""Step factories of the LM: the train step, the prefill step and the
serve (decode) step.

A port of the JAX package's ``launch/steps.py``.  The train step is one
``models.model.loss_fn`` forward and backward (through the flash
kernel's autograd function, ``kernels.ops.FlashAttention``, wherever a
call reaches the kernel) and one AdamW update of the model's parameters
in place.  The prefill step, which its dry-run lowers for the
``prefill_32k`` shape, is one forward over the whole sequence, through
``ops.flash_attention`` under ``attn_impl="pallas"`` (and under the
default ``xla_chunked`` above 512 x 512 query-key pairs).  The serve step
(``decode_32k``) is one token a row against a KV cache or a recurrent
state, in plain torch.
"""

from __future__ import annotations

import torch

from ..kernels.ops import device_of
from ..models import layers
from ..models.model import init_params, loss_fn
from ..models.sharding import current_mesh
from ..optim import AdamWConfig, adamw_init, adamw_update


def make_train_step(cfg, opt_cfg: AdamWConfig, *, window: int = 0,
                    microbatches: int = 1, grad_shardings=None,
                    dtype: torch.dtype = layers.COMPUTE_DTYPE):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.

    ``model`` a ``DecoderLM`` whose parameters require gradients
    (:func:`init_train_state`), ``opt_state`` its ``adamw_init`` state;
    both are updated IN PLACE and returned.  ``batch`` as
    ``model.loss_fn`` takes it.  ``metrics``: ``loss``, ``xent``, ``aux``
    and ``gnorm``, 0-d float32 tensors on the model's device (no host
    sync).  ``microbatches > 1`` splits the batch along its first axis and
    runs the pieces one after another, adding their gradients in float32
    and dividing by the count, as do the loss and its parts: activation
    memory a piece at a time.  ``dtype``: the activations' (bf16 as in the
    JAX package; float32 for a check without rounding between layers).

    On a mesh (the model's parameters, the state and the batch
    ``DTensor``s, ``launch.shardings.shard_*``; the model's rules
    installed, ``models.sharding.logical_rules``) each gradient leaves the
    backward as a pending sum over the axes its parameter is replicated
    on.  ``grad_shardings`` (parameter name -> DTensor placements, the
    ZeRO-1 placements of the AdamW moments) pins each microbatch's
    gradients there, so that they reduce-scatter before they add, as the
    JAX package pins them (``launch/steps.py:49-51``); without it each is
    reduced to its parameter's placements once, before the update.  The
    AdamW update then runs on the sharded state.
    """
    def grad_of(model, params, batch):
        loss, (xent, aux) = loss_fn(model, cfg, batch, window=window,
                                    dtype=dtype)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: _place(torch.zeros_like(p) if g is None else g,
                           grad_shardings and grad_shardings[n])
                 for (n, p), g in zip(params.items(), grads)}
        return (loss.detach(), xent.detach(), aux.detach()), grads

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if microbatches == 1:
            (loss, xent, aux), grads = grad_of(model, params, batch)
        else:
            grads = None
            loss = xent = aux = 0.0
            for i in range(microbatches):
                piece = {k: _piece(v, i, microbatches)
                         for k, v in batch.items()}
                (l, x, a), gi = grad_of(model, params, piece)
                if grads is None:
                    grads = {n: torch.zeros_like(g, dtype=torch.float32)
                             for n, g in gi.items()}
                for n, g in gi.items():
                    grads[n] += g.float()
                del gi
                loss, xent, aux = loss + l, xent + x, aux + a
            for g in grads.values():
                g /= microbatches
            loss, xent, aux = (t / microbatches for t in (loss, xent, aux))
        grads = {n: _place(g, params[n].placements) if _is_partial(g)
                 else g for n, g in grads.items()}
        _, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                           opt_cfg)
        metrics = {"loss": loss, "xent": xent, "aux": aux, "gnorm": gnorm}
        return model, opt_state, metrics
    return train_step


def _place(g, placements):
    """A gradient redistributed to ``placements`` (None: as it is)."""
    return g if placements is None else g.redistribute(
        placements=placements)


def _is_partial(g) -> bool:
    """Whether ``g`` is a ``DTensor`` that still holds a pending sum."""
    return any(p.is_partial() for p in getattr(g, "placements", ()))


def _piece(a, i: int, n: int):
    """Piece ``i`` of ``n`` of a batch array along its first axis."""
    per = a.shape[0] // n
    return a[i * per:(i + 1) * per]


def init_train_state(cfg, generator: torch.Generator | None,
                     opt_cfg: AdamWConfig, *, device="cuda"):
    """(model, opt_state): a randomly initialised model (``init_params``)
    with float32 parameters that require gradients, as the JAX package
    keeps its params, and the AdamW state.  ``device="meta"`` builds the
    shapes alone."""
    del opt_cfg
    model = init_params(cfg, generator=generator, device=device_of(device),
                        dtype=torch.float32)
    model.requires_grad_(True)
    return model, adamw_init(dict(model.named_parameters()))


def train_state_shapes(cfg, opt_cfg: AdamWConfig):
    """(model, opt_state) on the meta device: the shapes and dtypes of a
    train state, with no allocation."""
    return init_train_state(cfg, None, opt_cfg, device="meta")


def make_prefill_step(cfg, *, window: int = 0,
                      dtype: torch.dtype = layers.COMPUTE_DTYPE):
    """``prefill_step(model, batch) -> logits`` (B, S, V) in ``dtype``
    (the activations', bf16 as in the JAX package).

    ``batch["tokens"]`` is (B, S) ints, with ``batch["patches"]`` (B, P,
    D) in the vlm family and ``batch["frames"]`` (B, F, D) in the audio
    family, passed through to the model; ``model`` a ``DecoderLM`` whose
    parameters ``cfg`` describes.  Runs under ``torch.inference_mode()``
    (``torch.no_grad()`` on a mesh).  On a mesh
    (``launch.shardings.shard_model``, ``shard_batch``, the rules
    installed) the logits are a ``DTensor``, batch and vocabulary split.
    """
    def prefill_step(model, batch):
        with _no_grad():
            logits, _ = model(batch, cfg=cfg, window=window, dtype=dtype)
        return logits
    return prefill_step


def make_serve_step(cfg, *, window: int = 0):
    """``serve_step(model, state, tokens, pos) -> (logits, state)``.

    ``tokens`` (B, 1) ints, ``pos`` (B,) their absolute positions;
    logits (B, 1, V) in bf16.  ``state`` (``models.init_decode_state``)
    is updated in place and returned.  Runs under
    ``torch.inference_mode()`` (``torch.no_grad()`` on a mesh).
    """
    def serve_step(model, state, tokens, pos):
        with _no_grad():
            return model.decode_step(state, tokens, pos, cfg=cfg,
                                     window=window)
    return serve_step


def _no_grad():
    """``torch.inference_mode()``; on a mesh ``torch.no_grad()``: DTensor
    ops do not run on inference tensors (a cast to the dtype a tensor has
    fails its sharding rule there, an in-place write its version
    counter)."""
    return (torch.no_grad() if current_mesh() is not None
            else torch.inference_mode())
