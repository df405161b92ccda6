"""internvl2-1b — InternViT + Qwen2-0.5B-style language decoder.

[arXiv:2404.16821]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The vision tower (InternViT) is a STUB per the brief: input_specs()
provides 256 precomputed patch embeddings per image, prepended to the
text tokens.  QKV bias per Qwen2.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151_655,
    qkv_bias=True, mlp_type="swiglu", rope_theta=1e6,
    frontend="vision_stub", n_frontend_tokens=256,
)

SMOKE = ArchConfig(
    name="internvl2-1b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    qkv_bias=True, mlp_type="swiglu",
    frontend="vision_stub", n_frontend_tokens=16,
)
