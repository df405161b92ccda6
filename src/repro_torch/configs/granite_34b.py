"""granite-34b — llama-arch code model, MQA (kv=1).

[arXiv:2405.04324]  88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
d_ff = 4*d_model with a plain GELU MLP (granite code family).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab_size=49_152,
    mlp_type="gelu", rope_theta=1e4, seq_shard=True, train_microbatches=4,
)

SMOKE = ArchConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
    d_ff=1024, vocab_size=512,
    mlp_type="gelu",
)
