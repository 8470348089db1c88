"""Optimizers, learning-rate schedules and gradient compression of the
port (``repro.optim``)."""
from repro_torch.optim.compress import (
    CompressState,
    compress_grads,
    decompress_sum,
    init_compress_state,
    pod_compress,
    pod_decompress,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear

__all__ = [k for k in dir() if not k.startswith("_")]
