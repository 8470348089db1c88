"""Training launcher, ported from ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch m3vit-small \\
      --steps 40 --batch 64 [--ckpt DIR] [--device cpu --smoke]

Runs the fault-tolerant ``Trainer`` on one device (``--device``, default
``cuda``): the config's full width, or ``--smoke``'s reduced config of the
same family. ``--seq`` sets the LM sequence length (a vision model's is its
patch count).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import TRAIN_4K, get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Train as the flags say; returns the ``Trainer`` (its ``history``)."""
    args = parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = TRAIN_4K.replace(seq_len=args.seq, global_batch=args.batch)
    tc = TrainerConfig(total_steps=args.steps, lr=args.lr, checkpoint_dir=args.ckpt,
                       checkpoint_every=args.ckpt_every, grad_compress=args.grad_compress,
                       seed=args.seed, device=args.device)
    trainer = Trainer(cfg, shape, make_host_mesh(devices=[args.device]), tc)
    state = trainer.run()
    print(f"finished at step {int(state.step)}; "
          f"final loss {trainer.history[-1]['loss']:.4f}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
