"""Fault-tolerant training loop, ported from ``repro.train.trainer``:
checkpoint and restart, preemption drain, straggler monitoring,
deterministic data resume.

Each step's time is device time on the card (a pair of CUDA events around
the step, read after it), host time on the CPU. On the card the process
runs under ``torch.use_deterministic_algorithms(True)`` from the first
``Trainer`` on (``deterministic_mode``; cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG``, which is set to ``:4096:8`` unless the caller
set it): the hand kernels sum in a fixed order with no float atomics, so a
step repeats bit for bit, and a run resumed from a checkpoint follows the
uninterrupted run bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.distributed.fault_tolerance import (
    PreemptionGuard,
    StragglerMonitor,
    run_step_with_retry,
)
from repro_torch.models.param import require_device
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train.train_step import TrainState, build_train_step, init_train_state


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_last_k: int = 3
    log_every: int = 10
    seed: int = 0
    grad_compress: bool = False
    max_grad_norm: float = 1.0
    device: str = "cuda"  # "cpu" to train on the CPU


def deterministic_mode() -> None:
    """Deterministic algorithms for every later op of the process (cuBLAS
    with a fixed workspace; an op with no deterministic form then raises)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 tc: TrainerConfig) -> None:
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.tc = tc
        self.device = require_device(tc.device)
        if self.device.type == "cuda":
            deterministic_mode()
        schedule = warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
        self.optimizer = make_optimizer(cfg.optimizer, schedule)
        self.pipeline = SyntheticPipeline(cfg, shape, seed=tc.seed)
        self.ckpt = (CheckpointManager(tc.checkpoint_dir, tc.keep_last_k)
                     if tc.checkpoint_dir else None)
        self.guard = PreemptionGuard()
        self.straggler = StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self.step_fn = build_train_step(cfg, shape, mesh, self.optimizer,
                                        grad_compress=tc.grad_compress,
                                        max_grad_norm=tc.max_grad_norm)

    # -- state ---------------------------------------------------------------
    def init_or_restore(self) -> TrainState:
        state = init_train_state(self.cfg, self.optimizer, self.tc.seed,
                                 grad_compress=self.tc.grad_compress, device=self.device)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
        return state

    def _timed_step(self, state: TrainState, batch: dict):
        """One step with retry; returns (state, metrics, seconds): device
        time on the card, host time on the CPU."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            state, metrics = run_step_with_retry(self.step_fn, state, batch)
            return state, metrics, time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = run_step_with_retry(self.step_fn, state, batch)
        stop.record()
        stop.synchronize()
        return state, metrics, start.elapsed_time(stop) / 1e3

    # -- loop ----------------------------------------------------------------
    def run(self, state: Optional[TrainState] = None,
            on_step: Optional[Callable] = None) -> TrainState:
        state = state if state is not None else self.init_or_restore()
        for step in range(int(state.step), self.tc.total_steps):
            batch = self.pipeline.batch_for_step(step)
            state, metrics, dt = self._timed_step(state, batch)
            self.straggler.record(dt, step=step)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = step
            rec["step_time_s"] = dt
            self.history.append(rec)
            if on_step is not None:
                on_step(step, rec)
            if step % self.tc.log_every == 0:
                print(f"step {step:5d} loss {rec['loss']:.4f} "
                      f"acc {rec.get('acc', 0):.3f} {dt*1e3:.0f} ms", flush=True)
            if self.ckpt is not None and ((step + 1) % self.tc.checkpoint_every == 0
                                          or self.guard.preempted):
                self.ckpt.save(int(state.step), state)
            if self.guard.preempted:
                print(f"preemption requested: drained at step {step}", flush=True)
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        return state
