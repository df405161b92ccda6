"""PyTorch/CUDA port of the ``repro`` GBDT library, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its
module names and holds to it bit for bit where it can.  This slice
serves a trained forest: load a checkpoint of either package (or carry
a model's arrays across with :func:`model_from_numpy`) and predict on
the GPU through the hand-written traversal kernel::

    import repro_torch

    model = repro_torch.load_gbdt("model.npz")            # device="cuda"
    margins = model.predict(x, output="margin", binned=True)

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .checkpoint import load_gbdt, model_from_numpy, save_gbdt
from .core.boosting import GBDTConfig, GBDTModel, accuracy
from .core.predict import forest_predict
from .core.tree import Forest, Tree
from .kernels.ops import TraverseSpec
from .obs import PredictReport

__all__ = [
    "Forest",
    "GBDTConfig",
    "GBDTModel",
    "PredictReport",
    "TraverseSpec",
    "Tree",
    "accuracy",
    "forest_predict",
    "load_gbdt",
    "model_from_numpy",
    "save_gbdt",
]
