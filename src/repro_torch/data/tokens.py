"""Deterministic synthetic LM token pipeline (sharded, stateless).

A port of the JAX package's ``data/tokens.py``: a batch is a pure
function of (seed, step), so every data-parallel worker can make its own
shard without coordination.  Tokens follow the same rules: a Zipf-like
marginal, ``floor((vocab - 1) * u ** 3)`` for u uniform in [1e-6, 1),
and every second token repeats the one before it, so that cross-entropy
is learnable.  The uniforms come from a ``torch.Generator`` seeded from
(seed, step) (:func:`step_generator`); ``jax.random`` streams cannot be
reproduced in torch, so the tokens differ from the JAX package's, and
the rules are the same.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU ``torch.Generator`` that is a pure function of (seed, step).

    The CPU generator keeps 32 bits of its seed, so the pair is hashed
    down to 32 bits (SHA-256), rather than packed into 64."""
    digest = hashlib.sha256(f"{seed}/{step}".encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:4], "little"))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """The full global batch ``{"tokens": (B, S) int32}`` of a step,
        on the CPU."""
        gen = step_generator(self.seed, step)
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        u = torch.rand((b, s), generator=gen) * (1.0 - 1e-6) + 1e-6
        toks = torch.floor((v - 1) * u ** 3.0).to(torch.int32)
        rep = torch.roll(toks, 1, dims=1)
        odd = (torch.arange(s) % 2).bool()[None, :]
        return {"tokens": torch.where(odd, rep, toks)}

    def shard_at(self, step: int, worker: int, n_workers: int) -> dict:
        """One data-parallel worker's rows of the global batch."""
        full = self.batch_at(step)
        per = self.global_batch // n_workers
        return {k: v[worker * per:(worker + 1) * per]
                for k, v in full.items()}
