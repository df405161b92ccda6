"""Model substrate of the port: the dense decoder LM (prefill).

layers    — RMSNorm, linear maps, embedding, MLPs, RoPE
attention — GQA attention with RoPE and causal / window masks
model     — ``init_params``, the decoder block and ``DecoderLM``
"""

from .model import DecoderLM, init_params

__all__ = ["DecoderLM", "init_params"]
