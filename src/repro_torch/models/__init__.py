"""Vision models of the port (``repro.models`` for the vit families)."""
from repro_torch.models.param import tree_bytes
from repro_torch.models.vit import (
    PATCH_DIM,
    ViTClassifier,
    abstract_params,
    classify,
    forward,
    init_model_params,
    synth_patches,
)

__all__ = [
    "PATCH_DIM",
    "ViTClassifier",
    "abstract_params",
    "classify",
    "forward",
    "init_model_params",
    "synth_patches",
    "tree_bytes",
]
