"""Optimizers as (init, update) pairs over parameter trees (nested dicts of
tensors), ported from ``repro.optim.optimizers``.

AdamW for the small and medium archs; Adafactor (factored second moment,
no momentum) for the largest, whose optimizer state must stay small. Each
also gives ``state_specs(param_specs, param_shapes)``, the sharding specs
of its state (``distributed/sharding_rules.py``'s tuples): AdamW's m and v
take their param's spec, Adafactor's factored vectors are replicated. Every
update is functional: new tensors, the old state untouched.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.param import tree_leaves, tree_map, tree_unzip


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple]  # (g, s, p, step)
    state_specs: Callable[[Any, Any], Any]  # (param specs, param shapes) -> state specs


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        lr = schedule(step)
        t = step.to(torch.float32) + 1.0
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            step_ = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step_).to(p.dtype), m, v

        new_p, m, v = tree_unzip(tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_p, {"m": m, "v": v}

    def state_specs(param_specs, param_shapes):
        return {"m": param_specs, "v": param_specs}

    return Optimizer(init=init, update=update, state_specs=state_specs)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018): factored second moment
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(schedule, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def one(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"v": tree_map(one, params)}

    def update(grads, state, params, step):
        lr = schedule(step)
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** (-decay)  # increasing decay schedule

        def upd(p, g, s):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                u = (g * torch.rsqrt(vr[..., None] / denom[..., None])
                     * torch.rsqrt(vc[..., None, :]))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v)
                new_s = {"v": v}
            # update clipping (RMS of the step bounded by clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            newp = p.to(torch.float32) - lr * (u + weight_decay * p.to(torch.float32))
            return newp.to(p.dtype), new_s

        new_p, v = tree_unzip(tree_map(upd, params, grads, state["v"]), 2)
        return new_p, {"v": v}

    def state_specs(param_specs, param_shapes):
        def one(spec, shape):
            if _factored(tuple(getattr(shape, "shape", shape))):
                return {"vr": (), "vc": ()}  # tiny: replicated
            return {"v": spec}

        return {"v": tree_map(one, param_specs, param_shapes)}

    return Optimizer(init=init, update=update, state_specs=state_specs)


def make_optimizer(name: str, schedule, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "adafactor":
        return adafactor(schedule, **kw)
    raise ValueError(name)
