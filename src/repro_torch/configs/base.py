"""Architecture config schema shared by all assigned architectures.

A copy of the JAX package's ``configs/base.py``, field for field, so that
a config means the same thing to both packages.  Every
``configs/<id>.py`` exports ``CONFIG`` (the exact assigned numbers) and
``SMOKE`` (a reduced same-family variant: <=2 layers, d_model<=512,
<=4 experts) used by the CPU tests.

In the port, ``attn_impl`` picks the attention path (see
``models/attention.py``), ``moe_groups`` and ``moe_dispatch`` the MoE
layer's dispatch (``models/moe.py``), and ``remat`` checkpoints the
blocks that the JAX package's ``_maybe_remat`` wraps
(``models/model.py``, ``torch.utils.checkpoint``: their activations are
made again in the backward).  Under a mesh (``models/sharding.py``,
``launch/shardings.py``) ``seq_shard`` splits the sequence over 'model'
in the rules of a train step, ``train_microbatches`` sets the dry-run
train step's microbatches, whose gradients are pinned to the ZeRO-1
placements, and the dry-run sets ``moe_groups`` to the batch devices.
The knobs that only shape a JAX compilation are accepted and have no
effect here: ``causal_skip`` (the CUDA kernel always skips tiles wholly
outside the causal band), ``scan_layers``, ``scan_chunks`` and
``attn_chunk``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0          # 0 = full attention
    # sliding window used automatically for the long_500k shape on
    # otherwise-quadratic archs (see DESIGN.md §Arch-applicability)
    long_context_window: int = 8192

    # --- mlp ---
    mlp_type: str = "swiglu"         # swiglu | gelu

    # --- moe ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "onehot"     # onehot (baseline) | sort (optimized)
    moe_groups: int = 1              # dispatch groups (launcher sets this to
                                     # the data-axis size so per-group
                                     # capacity stays device-local)

    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_compute_dtype: str = "fp32"  # "bf16": intra-chunk matmuls in bf16
                                     # (state/decay stay fp32) — §Perf knob
    attn_every: int = 0              # hybrid: shared attn block every N layers
    slstm_every: int = 0             # xlstm: sLSTM block every N layers

    # --- frontends (stubbed modalities) ---
    frontend: str = ""               # '' | 'vision_stub' | 'audio_stub'
    n_frontend_tokens: int = 0       # patch / frame embeddings fed by input_specs

    # --- enc-dec ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- training ---
    tie_embeddings: bool = True
    remat: bool = True
    seq_shard: bool = False          # Megatron-style sequence parallelism
                                     # (big stacks: saved remat activations
                                     # divide by the model-axis size)
    train_microbatches: int = 1      # gradient accumulation (activation
                                     # peak divides by this)
    attn_impl: str = "xla_chunked"   # xla_chunked | xla_full | pallas
    attn_chunk: int = 1024
    causal_skip: bool = False        # skip fully-masked kv blocks (perf opt)

    # --- cost-measurement knobs (dry-run delta method; see launch/dryrun) ---
    # XLA's cost_analysis counts while-loop bodies ONCE, so scanned layer
    # stacks under-report flops by ~n_layers.  The dry-run compiles small
    # UNROLLED variants (scan_layers=False, scan_chunks=False) to measure
    # exact per-layer costs and extrapolates; the full scanned compile is
    # still used for memory analysis and the multi-pod lowering proof.
    scan_layers: bool = True
    scan_chunks: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def d_head(self) -> int:
        return self.head_dim

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def supports_shape(self, shape_name: str) -> bool:
        """Which assigned input shapes this arch runs (skips per DESIGN.md)."""
        if shape_name == "long_500k":
            # enc-dec full-attention: no meaningful 500k decode (DESIGN.md)
            return not self.is_encoder_decoder
        return True


# The four assigned input shapes.
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
