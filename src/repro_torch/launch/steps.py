"""Step factories of the LM: the prefill step.

A port of ``make_prefill_step`` of the JAX package's ``launch/steps.py``,
the step its dry-run lowers for the ``prefill_32k`` shape: one forward
over the whole sequence, through ``ops.flash_attention`` under
``attn_impl="pallas"`` (and under the default ``xla_chunked`` above
512 x 512 query-key pairs).  Train and decode steps wait for their
slices.
"""

from __future__ import annotations

import torch


def make_prefill_step(cfg, *, window: int = 0):
    """``prefill_step(model, batch) -> logits`` (B, S, V) in bf16.

    ``batch["tokens"]`` is (B, S) ints; ``model`` a ``DecoderLM`` whose
    parameters ``cfg`` describes.  Runs under ``torch.inference_mode()``.
    """
    def prefill_step(model, batch):
        with torch.inference_mode():
            logits, _ = model(batch, cfg=cfg, window=window)
        return logits
    return prefill_step
