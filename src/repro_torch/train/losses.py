"""Loss functions, ported from ``repro.train.losses``: token cross-entropy
with z-loss, and the uniform loss over a pipeline batch."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross-entropy of logits [..., V] against integer labels [...].
    ``z_loss`` pulls log Z toward 0 (keeps the final logits from drifting,
    which also helps the PTQ final-norm quantizer)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def loss_and_metrics(params, cfg: ModelConfig, batch: dict):
    """Uniform loss over a pipeline batch of tensors; returns (loss,
    {"loss", "xent", "moe_aux", "acc"})."""
    from repro_torch import models

    logits, aux = models.forward(params, cfg, batch)
    labels = batch["labels"]
    if logits.dim() == 3 and logits.shape[1] != labels.shape[1]:
        # frontend families: the frontend positions (prefix) carry no labels
        logits = logits[:, -labels.shape[1]:, :]
    xent = softmax_xent(logits, labels)
    loss = xent
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux, "acc": acc}
