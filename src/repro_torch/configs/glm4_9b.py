"""glm4-9b — RoPE + GQA decoder.

[hf:THUDM/glm-4-9b]  40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13_696, vocab_size=151_552,
    mlp_type="swiglu", rope_theta=1e4, seq_shard=True, train_microbatches=4,
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    mlp_type="swiglu",
)
