"""granite-20b — llama-arch code model, MQA (kv=1).

[arXiv:2405.04324]  52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab_size=49_152,
    mlp_type="gelu", rope_theta=1e4, seq_shard=True, train_microbatches=4,
)

SMOKE = ArchConfig(
    name="granite-20b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
    d_ff=1024, vocab_size=512,
    mlp_type="gelu",
)
