"""Training launcher: real training on one device.

PyTorch counterpart of ``repro.launch.train``.  It runs on the card unless
``--device cpu`` asks for the CPU (where ``--reduced`` configs train end to
end).  Checkpoints (``--ckpt-dir``, ``--resume``) need ``ckpt/``, which is
not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ckpt import checkpoint as ckpt
from ..configs.base import TrainConfig
from ..configs.registry import ARCH_IDS, get_config
from ..data import make_pipeline
from ..models import get_model
from ..train import build_train_step, init_train_state


def main(argv: list[str] | None = None) -> list[float]:
    """Train; returns the losses of the steps this call ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg, device=dev)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, grad_accum=args.grad_accum)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{model.num_params() / 1e6:.1f}M params, device {name}")

    state = init_train_state(model, tcfg,
                             torch.Generator(device=dev).manual_seed(args.seed))
    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {start_step}")

    step_fn = build_train_step(model, tcfg)
    pipe = make_pipeline(cfg, seq_len=args.seq, global_batch=args.batch,
                         seed=args.seed, device=dev)
    losses = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = pipe.batch(step)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:>5}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.1f}s")
        if args.ckpt_dir and (step + 1) % max(args.steps // 4, 1) == 0:
            ckpt.save(args.ckpt_dir, state, step + 1)
    k = max(len(losses) // 10, 1)
    print(f"loss {np.mean(losses[:k]):.4f} -> {np.mean(losses[-k:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
