"""Port of ``repro.core.quant``: the reparameterization's per-tensor
functions are exported here, as the reference exports them."""
from repro_torch.core.quant.reparam import (
    ReparamFactors,
    apply_to_consumer,
    apply_to_layernorm,
    apply_to_rmsnorm,
    calibrate_per_channel_asym,
    calibrate_per_channel_sym,
    factors_from_minmax,
    reparam_factors,
    transform_activation,
)

__all__ = ["ReparamFactors", "apply_to_consumer", "apply_to_layernorm", "apply_to_rmsnorm",
           "calibrate_per_channel_asym", "calibrate_per_channel_sym", "factors_from_minmax",
           "reparam_factors", "transform_activation"]
