"""Deterministic synthetic data pipeline, ported from
``repro.data.pipeline``: numpy only, so its batches are bit-equal to the
reference's for the same (seed, step, host).

Training runs on synthetic tasks that are (a) deterministic in (seed, step,
host), which fault-tolerant resume needs (restoring at step k regenerates
the batch stream from k), and (b) learnable, so a loss curve shows real
optimization:

  * token LM families: sequences from a fixed random bigram chain (next =
    perm[cur] with p = 0.9, uniform otherwise);
  * vision families: patches whose class is a linear probe of a fixed
    random projection of the mean patch (linearly separable);
  * frontend (audio / VLM) families: stub embeddings drawn around one of
    8 fixed Gaussian means each, beside the tokens.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import PATCH_DIM, frontend_tokens, text_tokens_for


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 batch_override: Optional[int] = None) -> None:
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.global_batch = batch_override or shape.global_batch
        if self.global_batch % num_hosts:
            raise ValueError(f"batch {self.global_batch} over {num_hosts} hosts")
        self.host_batch = self.global_batch // num_hosts
        # fixed task structure (seed-keyed, independent of the step)
        structure_rng = np.random.default_rng(seed)
        v = max(cfg.vocab_size, 2)
        self._perm = structure_rng.permutation(v)
        if cfg.num_classes:
            self._probe = structure_rng.standard_normal(
                (16, cfg.num_classes)).astype(np.float32)
        if cfg.frontend:
            self._fe_means = structure_rng.standard_normal(
                (8, cfg.frontend_dim)).astype(np.float32)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def _bigram_tokens(self, rng, B: int, S: int) -> np.ndarray:
        v = max(self.cfg.vocab_size, 2)
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, B)
        flips = rng.random((B, S)) < 0.1
        noise = rng.integers(0, v, (B, S))
        for t in range(S):
            nxt = self._perm[toks[:, t]]
            toks[:, t + 1] = np.where(flips[:, t], noise[:, t], nxt)
        return toks

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        B = self.host_batch
        if cfg.family in ("vit", "vit_moe"):
            patches = rng.standard_normal(
                (B, cfg.image_tokens - 1, PATCH_DIM)).astype(np.float32)
            labels = np.argmax(patches.mean(axis=1)[:, :16] @ self._probe, axis=-1)
            return {"patches": patches, "labels": labels.astype(np.int32)}
        toks = self._bigram_tokens(rng, B, text_tokens_for(cfg, self.shape))
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend:  # the frames of an encoder-decoder, a vlm's patches
            cls = rng.integers(0, 8, B)
            fe = (self._fe_means[cls][:, None, :] + 0.3 * rng.standard_normal(
                (B, frontend_tokens(cfg, self.shape), cfg.frontend_dim)))
            out["frontend_embeds"] = fe.astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_for_step(step)
            step += 1


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, **kw) -> SyntheticPipeline:
    return SyntheticPipeline(cfg, shape, **kw)


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
