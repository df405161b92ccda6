"""whisper-tiny — encoder-decoder ASR backbone, conv frontend STUB.

[arXiv:2212.04356]  4L(enc)+4L(dec) d_model=384 6H d_ff=1536 vocab=51865.
The mel-spectrogram + conv feature extractor is a STUB per the brief:
input_specs() provides 1500 precomputed frame embeddings.
No long_500k shape (enc-dec full attention; skip noted in DESIGN.md).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51_865,
    mlp_type="gelu",
    is_encoder_decoder=True, n_encoder_layers=4,
    frontend="audio_stub", n_frontend_tokens=1500,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    mlp_type="gelu",
    is_encoder_decoder=True, n_encoder_layers=2,
    frontend="audio_stub", n_frontend_tokens=64,
)
