"""Training launcher: real training on one device (smoke scale with
``--smoke``). Port of ``repro/launch/train.py``: the same flags, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path, the scans' plain twins included). Like the reference it has no
console script.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 30 --batch 8 --seq 512

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 50 --batch 4 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.models.common import resolve_device
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import train

    dev = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke \
        else registry.get_config(args.arch)
    extra = {}
    if cfg.modality == "vision":
        extra["frontend_shape"] = (args.batch, 8, cfg.d_model)
        extra["dtype"] = cfg.dtype
    if cfg.family == "audio":
        extra["frames_shape"] = (args.batch, args.seq, cfg.d_model)
        extra["dtype"] = cfg.dtype
    data = packed_batches(cfg.vocab_size, args.batch, args.seq,
                          seed=args.seed, device=dev, **extra)
    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    return train(cfg, adamw, data, args.steps, seed=args.seed,
                 checkpoint_dir=args.checkpoint_dir or None,
                 checkpoint_every=args.checkpoint_every, device=dev)


if __name__ == "__main__":
    main()
