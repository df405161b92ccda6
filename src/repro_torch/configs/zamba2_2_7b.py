"""zamba2-2.7b — Mamba2 backbone + one SHARED attention block.

[arXiv:2411.15242]  54L d_model=2560 (Mamba2, ssm_state=64) + a shared
full-attention block (32H MHA, d_ff=10240 MLP) applied every 6 layers
with shared parameters (the Zamba trick).  Simplification vs release:
per-invocation LoRA deltas on the shared block are omitted (DESIGN.md).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10_240, vocab_size=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6, mlp_type="gelu", seq_shard=True, train_microbatches=2,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=32,
    attn_every=2, mlp_type="gelu",
)
