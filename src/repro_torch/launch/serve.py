"""Serving launcher: prefill into a KV cache or a recurrent state, then
batched greedy decode.

A port of the JAX package's ``launch/serve.py``.  The prompt is run
through the decode path token by token, as there (simple and the same
for every family; the fast path is the prefill step), so no
flash-attention kernel runs there: decode attention is plain torch, and
so are the ssm and hybrid families' recurrent steps.  The audio family
first encodes its frames once (the encoder's attention on the flash
kernel at 1500 frames) and caches each decoder layer's cross-attention
K/V; the vlm family is served without patches, as in the JAX package.
The prompts, the frames and the random weights come from seeded
``torch.Generator``s, so the numbers differ from ``jax.random``'s.

Usage:
  python -m repro_torch.launch.serve --arch glm4-9b --smoke --batch 4 \\
      --prompt-len 32 --gen 16 [--device cpu]

``--device`` defaults to ``cuda`` and raises where there is no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..kernels.ops import device_of
from ..models import DecoderLM, init_decode_state, init_params
from . import steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_into_cache(model: DecoderLM, cfg, batch, cache_len: int, *,
                       prompt_logits: list | None = None):
    """Run the serve step over the prompt ``batch["tokens"]`` (B, S), one
    position at a time, into a new decode state (KV caches of
    ``cache_len`` slots).  In the audio family ``batch["frames"]`` (B, F,
    D) is encoded first, once, and each decoder layer's cross-attention
    K/V of it goes into the state (``cross_k``, ``cross_v``).

    Returns (logits (B, 1, V) of the last position, state, S).  Where
    ``prompt_logits`` is a list, each position's logits are appended to
    it.
    """
    device = model.embed.table.device
    tokens = torch.as_tensor(batch["tokens"], device=device)
    b, s = tokens.shape
    if cfg.family == "audio":
        with torch.inference_mode():
            enc = model.encode_audio(cfg, batch["frames"])
            f = enc.shape[1]
            state = init_decode_state(cfg, b, cache_len, device=device,
                                      frames=f)
            for i, cross in enumerate(model.cross_layers):
                for name, w in (("cross_k", cross.attn.wk),
                                ("cross_v", cross.attn.wv)):
                    state[name][i].copy_(w(enc).reshape(
                        b, f, cfg.n_kv_heads, cfg.head_dim))
    else:
        state = init_decode_state(cfg, b, cache_len, device=device)
    serve = steps.make_serve_step(cfg)
    logits = None
    for t in range(s):
        logits, state = serve(model, state, tokens[:, t:t + 1],
                              torch.full((b,), t, device=device))
        if prompt_logits is not None:
            prompt_logits.append(logits)
    return logits, state, s


def greedy_decode(model: DecoderLM, cfg, state, logits, pos0: int, gen: int,
                  *, step_seconds: list | None = None) -> torch.Tensor:
    """``gen`` greedy tokens a row, the first from ``logits`` (B, 1, V),
    each next one from a serve step at positions ``pos0``, ``pos0 + 1``,
    ... -> (B, gen).  Where ``step_seconds`` is a list, each step's
    seconds (ending in a synchronise) are appended to it."""
    device = logits.device
    b = logits.shape[0]
    serve = steps.make_serve_step(cfg)
    out = [logits[:, -1:].argmax(-1)]
    for t in range(gen - 1):
        t0 = time.perf_counter()
        logits, state = serve(model, state, out[-1],
                              torch.full((b,), pos0 + t, device=device))
        out.append(logits[:, -1:].argmax(-1))
        _sync(device)
        if step_seconds is not None:
            step_seconds.append(time.perf_counter() - t0)
    return torch.cat(out, 1)


@dataclasses.dataclass
class Generation:
    """What :func:`generate` served: the greedy ``tokens`` (B, gen), the
    request ``batch`` (``"tokens"``: the prompts (B, S); ``"frames"`` (B,
    F, D) in the audio family), the ``last_logits`` (B, 1, V) of the last
    prompt position, the prefill's seconds, each decode step's seconds,
    and the ``model`` and ``cfg`` that served them."""

    tokens: torch.Tensor
    batch: dict
    last_logits: torch.Tensor
    prefill_seconds: float
    step_seconds: list
    model: DecoderLM
    cfg: object

    @property
    def prompts(self) -> torch.Tensor:
        return self.batch["tokens"]

    @property
    def step_p50_ms(self) -> float:
        return float(np.median(self.step_seconds)) * 1e3

    @property
    def tokens_per_s(self) -> float:
        """Decode tokens a second over the timed steps (batch a step)."""
        return (self.tokens.shape[0] * len(self.step_seconds)
                / max(sum(self.step_seconds), 1e-9))


def generate(arch: str, *, smoke: bool = True, batch: int = 4,
             prompt_len: int = 32, gen: int = 16, seed: int = 0,
             device="cuda") -> Generation:
    """Random weights and prompts from ``seed`` (in the audio family also
    the stub frames, (batch, n_frontend_tokens, d_model) in bf16, drawn
    after the prompts), prefill into a cache of ``prompt_len + gen``
    slots, then ``gen`` greedy tokens a row."""
    device = device_of(device)
    cfg = get_config(arch, smoke=smoke)
    model = init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    draws = torch.Generator().manual_seed(seed)
    request = {"tokens": torch.randint(0, cfg.vocab_size,
                                       (batch, prompt_len), generator=draws)}
    if cfg.family == "audio":
        request["frames"] = torch.randn(
            (batch, cfg.n_frontend_tokens, cfg.d_model),
            generator=draws).to(torch.bfloat16)
    request = {k: t.to(device) for k, t in request.items()}
    t0 = time.perf_counter()
    logits, state, pos0 = prefill_into_cache(model, cfg, request,
                                             prompt_len + gen)
    _sync(device)
    prefill_seconds = time.perf_counter() - t0
    print(f"[serve] {arch} prefill {prompt_len} tokens x{batch} "
          f"in {prefill_seconds:.1f}s", flush=True)
    step_seconds: list = []
    toks = greedy_decode(model, cfg, state, logits, pos0, gen,
                         step_seconds=step_seconds)
    run = Generation(toks, request, logits, prefill_seconds, step_seconds,
                     model, cfg)
    print(f"[serve] generated {gen}x{batch} tokens in "
          f"{sum(step_seconds):.1f}s ({run.tokens_per_s:.1f} tok/s)",
          flush=True)
    return run


def main(argv=None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = generate(args.arch, smoke=args.smoke, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen,
                   device=args.device)
    print("[serve] sample tokens:", run.tokens[0, :8].tolist())
    return run


if __name__ == "__main__":
    main()
