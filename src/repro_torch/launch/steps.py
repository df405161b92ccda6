"""Step factories of the LM: the prefill step and the serve (decode) step.

A port of ``make_prefill_step`` and ``make_serve_step`` of the JAX
package's ``launch/steps.py``.  The prefill step, which its dry-run
lowers for the ``prefill_32k`` shape, is one forward over the whole
sequence, through ``ops.flash_attention`` under ``attn_impl="pallas"``
(and under the default ``xla_chunked`` above 512 x 512 query-key pairs).
The serve step (``decode_32k``) is one token a row against a KV cache
or a recurrent state, in plain torch.  The train step waits for its slice.
"""

from __future__ import annotations

import torch


def make_prefill_step(cfg, *, window: int = 0):
    """``prefill_step(model, batch) -> logits`` (B, S, V) in bf16.

    ``batch["tokens"]`` is (B, S) ints, with ``batch["patches"]`` (B, P,
    D) in the vlm family and ``batch["frames"]`` (B, F, D) in the audio
    family, passed through to the model; ``model`` a ``DecoderLM`` whose
    parameters ``cfg`` describes.  Runs under ``torch.inference_mode()``.
    """
    def prefill_step(model, batch):
        with torch.inference_mode():
            logits, _ = model(batch, cfg=cfg, window=window)
        return logits
    return prefill_step


def make_serve_step(cfg, *, window: int = 0):
    """``serve_step(model, state, tokens, pos) -> (logits, state)``.

    ``tokens`` (B, 1) ints, ``pos`` (B,) their absolute positions;
    logits (B, 1, V) in bf16.  ``state`` (``models.init_decode_state``)
    is updated in place and returned.  Runs under
    ``torch.inference_mode()``.
    """
    def serve_step(model, state, tokens, pos):
        with torch.inference_mode():
            return model.decode_step(state, tokens, pos, cfg=cfg,
                                     window=window)
    return serve_step
