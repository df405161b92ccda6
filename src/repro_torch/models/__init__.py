"""Model substrate of the port: the LM of every family (training,
prefill and decode).

layers    — RMSNorm, linear maps, embedding, MLPs, RoPE, the activations
attention — GQA attention with RoPE and causal / window masks; KV-cache
            decode
moe       — the mixture-of-experts layer (router, dispatch, experts)
ssm       — Mamba2, mLSTM and sLSTM, and their shared chunked core
model     — ``init_params``, ``init_decode_state``, the decoder block,
            ``DecoderLM`` and the training loss ``loss_fn``
sharding  — the logical-axis rules and ``constrain``: the model's
            activations placed on a mesh, and its local regions
"""

from .model import DecoderLM, init_decode_state, init_params

__all__ = ["DecoderLM", "init_decode_state", "init_params"]
