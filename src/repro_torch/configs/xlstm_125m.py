"""xlstm-125m — alternating sLSTM + mLSTM blocks.

[arXiv:2405.04517]  12L d_model=768 4H d_ff=0 vocab=50304.
d_ff=0: xLSTM blocks carry their own up-projections (mLSTM expand=2,
sLSTM proj 4/3).  sLSTM every 4th block (1:3 ratio, cf. xLSTM[7:1]/[1:1]
ablations), the rest mLSTM.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    slstm_every=4, ssm_expand=2, ssm_chunk=256,
)

SMOKE = ArchConfig(
    name="xlstm-125m-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=512,
    slstm_every=2, ssm_expand=2, ssm_chunk=32,
)
