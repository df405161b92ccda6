"""qwen3-moe-235b-a22b — 128 routed experts, top-8, QK-norm.

[hf:Qwen/Qwen3-30B-A3B family scaled]  94L d_model=4096 64H (GQA kv=4)
d_ff=1536(expert) vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151_936,
    n_experts=128, n_shared_experts=0, top_k=8, d_ff_expert=1536,
    qk_norm=True, mlp_type="swiglu", rope_theta=1e6, head_dim=128,
    seq_shard=True, train_microbatches=4,
)

SMOKE = ArchConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=512,
    n_experts=4, n_shared_experts=0, top_k=2, d_ff_expert=96,
    qk_norm=True, mlp_type="swiglu", head_dim=32,
)
