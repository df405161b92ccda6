"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

traverse         — level-synchronous forest traversal (csrc/traverse.cu)
hist             — level-batched grad/hess histogram (csrc/hist.cu)
split_gain       — best split per (node, feature) (csrc/split_gain.cu)
flash_attention  — blockwise attention, GQA, causal / window masks
                   (csrc/flash_attention.cu), and its backward
                   (csrc/flash_attention_bwd.cu)

Call through :mod:`repro_torch.kernels.ops`; plain versions in
:mod:`repro_torch.kernels.ref`.  Kernels build at first use
(:mod:`repro_torch.kernels._build`), never at import.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
