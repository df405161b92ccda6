"""qwen2.5-14b — GQA with QKV bias.

[hf:Qwen/Qwen2.5 family]  48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13_824, vocab_size=152_064,
    qkv_bias=True, mlp_type="swiglu", rope_theta=1e6, seq_shard=True, train_microbatches=4,
)

SMOKE = ArchConfig(
    name="qwen2.5-14b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    qkv_bias=True, mlp_type="swiglu",
)
