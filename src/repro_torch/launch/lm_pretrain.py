"""End-to-end LM pretraining: a ~100M-parameter model for a few
hundred steps on the synthetic token pipeline, with checkpoints.

The counterpart of the JAX package's ``examples/lm_pretrain.py``.  The
default arch is xlstm-125m at FULL size; ``--smoke`` takes the reduced
variant of any arch.  It runs on the card unless ``--device cpu``.
Checkpoints go to ``--ckpt-dir`` (by default ``build/lm_pretrain_ckpt``
at the root of the checkout), and a run resumes from the latest one
there.

Run:  PYTHONPATH=src python -m repro_torch.launch.lm_pretrain [--steps 300]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .train import train

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "lm_pretrain_ckpt")


def pretrain(arch: str = "xlstm-125m", *, steps_n: int = 300,
             smoke: bool = False, batch: int = 8, seq: int = 256,
             ckpt_dir: str = DEFAULT_CKPT_DIR, ckpt_every: int | None = None,
             device="cuda") -> list[float]:
    """``train`` at lr 3e-4 with a checkpoint every ``ckpt_every`` steps
    (by default ``max(50, steps_n // 4)``, as the JAX example takes)."""
    if ckpt_every is None:
        ckpt_every = max(50, steps_n // 4)
    return train(arch, smoke=smoke, steps_n=steps_n, batch=batch, seq=seq,
                 lr=3e-4, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                 device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (fast CPU demo)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    losses = pretrain(args.arch, steps_n=args.steps, smoke=args.smoke,
                      batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, device=args.device)
    drop = losses[0] - losses[-1]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (drop {drop:.3f})")
    if args.steps >= 100:
        assert drop > 0, "training failed to reduce loss"
    elif drop <= 0:
        print("note: <100 steps is a smoke run; loss movement at full "
              "model size needs a few hundred steps")


if __name__ == "__main__":
    main()
