"""Optimizer substrate: AdamW with global-norm clipping and a cosine
schedule."""

from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr"]
