"""Batched serving demo: prefill + greedy decode with a KV cache or a
recurrent state, across the attention, MoE and hybrid (SSM) families.

The port of the JAX package's ``examples/serve_decode.py``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_decode [--device cpu]

``--device`` defaults to ``cuda`` and raises where there is no GPU.
"""

from __future__ import annotations

import argparse

from .serve import generate

ARCHS = ("glm4-9b", "deepseek-moe-16b", "zamba2-2.7b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {}
    for arch in ARCHS:
        print(f"--- {arch} (reduced config) ---")
        run = generate(arch, smoke=True, batch=4, prompt_len=16, gen=8,
                       device=args.device)
        out[arch] = run.tokens
        print(f"  first sequence: {run.tokens[0].tolist()}")
    return out


if __name__ == "__main__":
    main()
