"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066]  28L d_model=2048 16H (GQA kv=16) d_ff=1408(expert)
vocab=102400.  Simplification vs the release: every layer is MoE (the HF
model keeps layer 0 dense); noted in DESIGN.md.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102_400,
    n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    mlp_type="swiglu", rope_theta=1e4, seq_shard=True, train_microbatches=2,
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab_size=512,
    n_experts=4, n_shared_experts=1, top_k=2, d_ff_expert=96,
    mlp_type="swiglu",
)
