"""Parity of the port's AdamW (``repro_torch.optim``) with the JAX
package's, on the CPU.

The same numpy parameters, gradients and moments go through both
``adamw_update``s.  Tolerances, with their reasons: the schedule and the
update are float32 elementwise arithmetic in the same order on both
sides, but XLA:CPU may fuse a multiply and an add, and ``b ** step`` and
``cos`` are library calls of their own on each side, so each value is
held to ``rtol=2e-6`` (a few float32 ulps) plus ``2e-7`` of the largest
magnitude of its leaf (``b1 m + (1 - b1) g`` may cancel, and an ulp of
a term is then many of the result); the global norm sums its squares in
another order (a stacked JAX leaf in one reduction), held to
``rtol=1e-6``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.optim import AdamWConfig as JaxAdamWConfig, \
    adamw_update as jax_adamw_update, cosine_lr as jax_cosine_lr
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    cosine_lr

RTOL = 2e-6
LEAF_ATOL = 2e-7        # of the leaf's largest magnitude


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=LEAF_ATOL * np.abs(want).max(),
                               err_msg=name)


SHAPES = {"embed.table": (40, 16), "layers.0.attn.wq.w": (16, 24),
          "layers.0.ln1.scale": (16,), "ln_f.scale": (16,)}


def _cfgs(**kw):
    return AdamWConfig(**kw), JaxAdamWConfig(**kw)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (1, 1)])
def test_cosine_lr_matches_jax(warmup, total):
    cfg, jcfg = _cfgs(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2,
                 total - 1, total, total + 7):
        got = float(cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jax_cosine_lr(jcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), step
        assert float(cosine_lr(cfg, step)) == got


def _state(rng, step):
    """Parameters, gradients and a state at ``step`` as numpy float32."""
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = {n: rng.normal(size=s).astype(np.float32)
             for n, s in SHAPES.items()}
    m = {n: 0.1 * rng.normal(size=s).astype(np.float32) if step else
         np.zeros(s, np.float32) for n, s in SHAPES.items()}
    v = {n: 0.01 * rng.random(size=s).astype(np.float32) if step else
         np.zeros(s, np.float32) for n, s in SHAPES.items()}
    return params, grads, m, v


@pytest.mark.parametrize("step", [0, 4, 150],
                         ids=["first", "in-warmup", "after-warmup"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e6], ids=["clipped",
                                                       "unclipped"])
def test_adamw_update_matches_jax(step, clip_norm):
    rng = np.random.default_rng(step)
    params, grads, m, v = _state(rng, step)
    cfg, jcfg = _cfgs(lr=1e-2, warmup_steps=10, total_steps=200,
                      clip_norm=clip_norm)
    t = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    state = {"m": {n: torch.from_numpy(a.copy()) for n, a in m.items()},
             "v": {n: torch.from_numpy(a.copy()) for n, a in v.items()},
             "step": torch.tensor(step, dtype=torch.int32)}
    new_p, new_state, gnorm = adamw_update(
        t, {n: torch.from_numpy(a) for n, a in grads.items()}, state, cfg)
    jp, jstate, jgnorm = jax_adamw_update(
        {n: jnp.asarray(a) for n, a in params.items()},
        {n: jnp.asarray(a) for n, a in grads.items()},
        {"m": {n: jnp.asarray(a) for n, a in m.items()},
         "v": {n: jnp.asarray(a) for n, a in v.items()},
         "step": jnp.int32(step)}, jcfg)
    # clipping is active exactly where the norm exceeds clip_norm
    assert (float(jgnorm) > clip_norm) == (clip_norm == 1.0)
    assert float(gnorm) == pytest.approx(float(jgnorm), rel=1e-6)
    assert int(new_state["step"]) == int(jstate["step"]) == step + 1
    for n in SHAPES:
        assert new_p[n] is t[n]                     # in place
        _close(new_p[n].numpy(), jp[n], n)
        for part in ("m", "v"):
            _close(new_state[part][n].numpy(), jstate[part][n], n)


def test_adamw_casts_to_the_parameter_dtype():
    """A bf16 parameter gets the float32 update rounded to bf16, as the
    JAX package's ``astype(p.dtype)``; its moments stay float32."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(8, 8)).astype(np.float32)
    g = rng.normal(size=(8, 8)).astype(np.float32)
    cfg, jcfg = _cfgs(lr=1e-2, warmup_steps=0, total_steps=10)
    pb = torch.from_numpy(p).bfloat16()
    state = adamw_init({"w": pb})
    assert state["m"]["w"].dtype == state["v"]["w"].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    new_p, new_state, _ = adamw_update({"w": pb}, {"w": torch.from_numpy(g)},
                                       state, cfg)
    jb = jnp.asarray(p).astype(jnp.bfloat16)
    jp, jstate, _ = jax_adamw_update(
        {"w": jb}, {"w": jnp.asarray(g)},
        {"m": {"w": jnp.zeros((8, 8))}, "v": {"w": jnp.zeros((8, 8))},
         "step": jnp.int32(0)}, jcfg)
    assert new_p["w"].dtype == torch.bfloat16
    want = np.asarray(jp["w"].astype(jnp.float32))
    got = new_p["w"].float().numpy()
    # one bf16 rounding of values that agree within float32 rounding
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
    _close(new_state["m"]["w"].numpy(), jstate["m"]["w"], "m")


def test_adamw_init_on_the_meta_device():
    params = {"a": torch.empty((3, 4), device="meta"),
              "b": torch.empty((5,), device="meta", dtype=torch.bfloat16)}
    state = adamw_init(params)
    for n, p in params.items():
        for part in ("m", "v"):
            t = state[part][n]
            assert t.device.type == "meta" and t.shape == p.shape
            assert t.dtype == torch.float32
    assert state["step"].device.type == "meta"
