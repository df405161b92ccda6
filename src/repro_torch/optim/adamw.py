"""AdamW with global-norm clipping and a cosine schedule.

A port of the JAX package's ``optim/adamw.py``.  Parameters, gradients
and the moments are dicts of tensors by parameter name (a model's
``named_parameters()``, the counterpart of the JAX params pytree); the
state is ``{"m", "v", "step"}``, with m and v float32 and ``step`` a 0-d
int32 tensor on the parameters' device, so that a step never waits on
the host.

The arithmetic is the JAX package's, op by op in float32: the global
norm of all gradients, ``scale = min(1, clip_norm / (gnorm + 1e-9))``,
the moments, the bias correction by ``b ** step`` in float32, weight
decay on every leaf (norms included), the result cast to the parameter's
dtype.  The JAX update returns new arrays; :func:`adamw_update` writes
the parameters and the moments IN PLACE (and returns them), which saves
a second copy of each, 8 bytes a parameter more at the peak.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor): linear warm-up
    to ``cfg.lr``, then a cosine down to 0 at ``total_steps``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict) -> dict:
    """``{"m", "v"}`` float32 zeros shaped like each parameter, and
    ``"step"`` 0 (int32, on the parameters' device)."""
    first = next(iter(params.values()))
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step -> (params, state, gnorm).

    ``params`` and ``grads`` map the same names to tensors; ``state`` is
    :func:`adamw_init`'s.  The parameters and ``state["m"]`` and
    ``state["v"]`` are updated in place; ``state["step"]`` is a new
    tensor.  ``gnorm`` (0-d float32) is the norm of the gradients before
    clipping, their squares summed leaf by leaf (a stacked JAX leaf sums
    its layers in one reduction: the two agree within float32 rounding).
    """
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32)
    sq = sum(torch.sum(torch.square(grads[n].to(torch.float32)))
             for n in params)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=step.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=step.device)
    c1 = 1 - torch.pow(b1, stepf)
    c2 = 1 - torch.pow(b2, stepf)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m, v = state["m"][name], state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        pf = p.to(torch.float32)
        newp = pf - lr * ((m / c1) / (torch.sqrt(v / c2) + cfg.eps)
                          + cfg.weight_decay * pf)
        p.copy_(newp.to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm

