"""Training launcher: real steps of the LM on one device.

A port of the JAX package's ``launch/train.py``, with its flags and its
checkpoints (a run of either package resumes the other's).  It runs on
the card unless ``--device cpu`` (or ``device="cpu"``) asks for the CPU,
and trains a SMOKE config under ``--smoke``, else the full width of the
arch, which one H100 holds for internvl2-1b, whisper-tiny and
xlstm-125m (float32 parameters, gradients and AdamW moments: 16 bytes a
parameter).

Usage:
  python -m repro_torch.launch.train --arch glm4-9b --smoke --steps 20
  python -m repro_torch.launch.train --arch internvl2-1b --smoke \
      --device cpu
  python -m repro_torch.launch.train --arch xlstm-125m --smoke --steps 50 \
      --batch 8 --seq 128 --ckpt-dir build/ckpt
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..checkpoint.npz import latest_step, restore_checkpoint, save_checkpoint
from ..configs import ARCH_NAMES, get_config
from ..data import TokenPipeline
from ..data.tokens import step_generator
from ..kernels.ops import device_of
from ..optim import AdamWConfig
from . import steps


def make_batch_fn(cfg, batch: int, seq: int, seed: int = 0, *,
                  device="cuda"):
    """``fn(step) -> batch`` on ``device``: the token pipeline's tokens
    (B, seq) and, in the vlm and audio families, ``patches`` or ``frames``
    (B, n_frontend_tokens, d_model), seeded bf16 normals.  Each is a pure
    function of (seed, step), drawn on the CPU, so every device gets the
    same batches."""
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=seed)
    device = device_of(device)

    def fn(step: int) -> dict:
        b = {"tokens": pipe.batch_at(step)["tokens"].to(device)}
        name = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
        if name is not None:
            b[name] = torch.randn(
                (batch, cfg.n_frontend_tokens, cfg.d_model),
                generator=step_generator(seed + 1, step)).to(
                    device=device, dtype=torch.bfloat16)
        return b
    return fn


def train(arch: str, *, smoke: bool = True, steps_n: int = 20,
          batch: int = 4, seq: int = 128, lr: float = 1e-3,
          ckpt_dir: str | None = None, ckpt_every: int = 0,
          microbatches: int = 1, log_every: int = 5,
          device="cuda") -> list[float]:
    """Train ``arch`` from seeded weights (or from the latest checkpoint
    in ``ckpt_dir``) up to step ``steps_n``; the losses of the steps run.
    A checkpoint every ``ckpt_every`` steps (0: none)."""
    cfg = get_config(arch, smoke=smoke)
    device = device_of(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(10, steps_n // 4),
                          total_steps=steps_n)
    gen = torch.Generator(device=device).manual_seed(0)
    model, opt = steps.init_train_state(cfg, gen, opt_cfg, device=device)
    start = 0
    if ckpt_dir and (s := latest_step(ckpt_dir)) is not None:
        restore_checkpoint(os.path.join(ckpt_dir, f"step_{s:08d}.npz"),
                           model, opt)
        start = s
        print(f"[train] restored step {s} from {ckpt_dir}")

    step_fn = steps.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    batch_fn = make_batch_fn(cfg, batch, seq, device=device)
    losses = []
    t0 = time.time()
    for i in range(start, steps_n):
        model, opt, metrics = step_fn(model, opt, batch_fn(i))
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps_n - 1:
            print(f"[train] {arch} step={i:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['gnorm']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, model, opt)
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, smoke=args.smoke, steps_n=args.steps,
                   batch=args.batch, seq=args.seq, lr=args.lr,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   microbatches=args.microbatches, device=args.device)
    print(f"[train] done: first={losses[0]:.4f} last={losses[-1]:.4f}")


if __name__ == "__main__":
    main()
