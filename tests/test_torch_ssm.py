"""Parity of the port's state-space blocks (``models/ssm.py``) with the JAX
package's, on the CPU.

The same numpy inputs go through the JAX function and the port's; the
JAX parameters enter the port's modules as numpy (float32 for the float32
cases, the projections rounded to bf16 for the bf16 ones; ``A_log``,
``D``, ``dt_bias`` and sLSTM's ``r`` stay float32 in both).  Tolerances,
with their reasons:

* ``softplus`` and ``log_sigmoid`` are JAX's formula (``jnp.logaddexp``)
  written out op by op: bit for bit wherever torch's ``exp`` and
  ``log1p`` give XLA's bits on the same operands (they differ by an ulp
  in places, and XLA flushes subnormals to zero).
* The chunked core, the layers and their decode steps in float32:
  within 1e-5 abs and rel (sums in another order: the chunk's products,
  the ``cumsum`` of the log-decays, the mean over dh in sLSTM).  Against
  the port's own token-by-token recurrence: the JAX package's own
  tolerance for that invariant (``tests/test_ssm.py``).
* bf16 activations: within two bf16 ulps (``ULP2``, as in
  ``tests/test_torch_lm.py``), since a bf16 product may round one ulp
  apart; the float32 states, which such products feed, within two bf16
  ulps of the largest.
* The one departure: the JAX package's chunked core overflows above the
  diagonal where a chunk's log-decays sum below about -88 (xlstm-125m's
  mLSTM at full width, ROADMAP "Reference conditions"); the port masks
  the exponent first.  It is pinned below, beside a full-width case where
  the JAX package is finite and the port equals it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import layers, ssm

ULP2 = 2.0 ** -6          # two bf16 ulps: one is at most 2^-7 of the value
F32_TOL = 1e-5
STEP_TOL = dict(rtol=2e-2, atol=2e-3)   # tests/test_ssm.py, chunked vs steps


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(x: np.ndarray, dtype: torch.dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)


def _close(got, want, dtype=torch.float32):
    got, want = _f32(got), _f32(want)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=ULP2,
                                   atol=ULP2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _state_close(got, want, dtype=torch.float32):
    """float32 states: within 1e-5 of the largest, abs and rel, or with
    bf16 activations (whose products feed the state, an ulp apart in
    places) within two bf16 ulps of the largest."""
    got, want = _f32(got), _f32(want)
    tol = ULP2 if dtype == torch.bfloat16 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _flat(params, prefix=""):
    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _module(cls, cfg, params, dtype):
    """The port's ``cls`` holding the JAX ``params``: float32 parameters
    stay float32, the others are stored in ``dtype``."""
    mod = cls(cfg, device="meta", dtype=dtype)
    kinds = {k: v.dtype for k, v in mod.state_dict().items()}
    mod.load_state_dict({k: torch.from_numpy(np.array(v)).to(
        torch.float32 if kinds[k] == torch.float32 else dtype)
        for k, v in _flat(params).items()}, assign=True, strict=True)
    return mod


BLOCKS = {
    "mamba2": ("zamba2-2.7b", ssm.Mamba2, jssm.init_mamba2,
               jssm.mamba2_layer, jssm.mamba2_step, ssm.mamba2_layer,
               ssm.mamba2_step),
    "mlstm": ("xlstm-125m", ssm.MLSTM, jssm.init_mlstm, jssm.mlstm_layer,
              jssm.mlstm_step, ssm.mlstm_layer, ssm.mlstm_step),
    "slstm": ("xlstm-125m", ssm.SLSTM, jssm.init_slstm, jssm.slstm_layer,
              jssm.slstm_step, ssm.slstm_layer, ssm.slstm_step),
}


def _zero_state(block, cfg, b):
    """The JAX package's zero state of ``block`` and the port's."""
    if block == "slstm":
        return jssm.slstm_init_state(cfg, b), ssm.slstm_init_state(
            cfg, b, device="cpu")
    shape = (jssm.mamba2_state_shape if block == "mamba2"
             else jssm.mlstm_state_shape)(cfg, b)
    return jnp.zeros(shape, jnp.float32), torch.zeros(shape)


def _states(st):
    return list(st) if isinstance(st, tuple) else [st]


# --------------------------------------------------------------------------
# the activations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["softplus", "log_sigmoid"])
def test_softplus_and_log_sigmoid_are_the_jax_formula_bit_for_bit(name,
                                                                  dtype):
    """Bit for bit wherever the two libraries' ``exp`` and ``log1p`` agree
    on the operands the formula gives them; every other difference is
    one of those primitives'."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.normal(size=60_000) * 3,
                        rng.normal(size=30_000) * 30,
                        [0.0, -0.0, 20.0, -20.0, 88.0, -100.0, np.inf,
                         -np.inf, np.nan]]).astype(np.float32)
    xj, xt = _pair(x, dtype)
    sign = -1 if name == "log_sigmoid" else 1     # log_sigmoid = -softplus(-x)
    got = _f32(getattr(layers, name)(xt))
    want = _f32(getattr(jax.nn, name)(xj))
    # the primitives on the formula's operands: exp(-|x|), then log1p of it
    a_t, a_j = (sign * xt).abs(), jnp.abs(sign * xj)
    e_t, e_j = torch.exp(-a_t), jnp.exp(-a_j)
    l_t = torch.log1p(torch.from_numpy(_f32(e_j).copy()).to(dtype))
    explained = (_f32(e_t) != _f32(e_j)) | (_f32(l_t) != _f32(jnp.log1p(e_j)))
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert not (~same & ~explained).any(), x[~same & ~explained][:8]
    assert same.mean() > 0.8
    # torch's own softplus is another formula (log1p(exp(x)) below 20)
    assert not np.array_equal(_f32(torch.nn.functional.softplus(
        torch.from_numpy(x[:60_000]))), _f32(jax.nn.softplus(
            jnp.asarray(x[:60_000]))))


# --------------------------------------------------------------------------
# the chunked core
# --------------------------------------------------------------------------

def _core_inputs(seed, b=2, s=32, g=3, h=3, n=8, p=5):
    """tests/test_ssm.py's shapes and scales, from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, g, n)).astype(np.float32),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32),
            rng.normal(size=(b, s, h, p)).astype(np.float32),
            -np.abs(rng.normal(size=(b, s, h))).astype(np.float32))


def _steps(q, k, v, ld, g, h):
    """The port's token-by-token recurrence over (B, S, ...) inputs."""
    b, s, _, n = q.shape
    q, k = (t.repeat_interleave(h // g, dim=2) for t in (q, k))
    state = torch.zeros((b, h, n, v.shape[-1]))
    ys = []
    for t in range(s):
        y, state = ssm.decay_attention_step(q[:, t], k[:, t], v[:, t],
                                            ld[:, t], state)
        ys.append(y)
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("groups", [3, 1], ids=["per-head", "shared-qk"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_decay_attention_matches_jax_and_the_steps(chunk, groups):
    arrays = _core_inputs(chunk, g=groups)
    jy, js = jssm.chunked_decay_attention(*map(jnp.asarray, arrays), chunk)
    ty, ts = ssm.chunked_decay_attention(*map(torch.from_numpy, arrays),
                                         chunk)
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy)
    _close(ts, js)
    sy, ss = _steps(*map(torch.from_numpy, arrays), groups, 3)
    np.testing.assert_allclose(_f32(ty), _f32(sy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(ts), _f32(ss), rtol=1e-4, atol=1e-4)


def test_chunked_decay_attention_continues_from_a_state():
    """Two calls, the second from the first's state, give one call's
    outputs (and the JAX package's with the same initial state)."""
    q, k, v, ld = map(torch.from_numpy, _core_inputs(5, s=64))
    y, st = ssm.chunked_decay_attention(q, k, v, ld, 16)
    y1, st1 = ssm.chunked_decay_attention(q[:, :32], k[:, :32], v[:, :32],
                                          ld[:, :32], 16)
    y2, st2 = ssm.chunked_decay_attention(q[:, 32:], k[:, 32:], v[:, 32:],
                                          ld[:, 32:], 16, st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(st2, st, rtol=1e-5, atol=1e-5)
    jy, jst = jssm.chunked_decay_attention(
        *(jnp.asarray(t[:, 32:].numpy()) for t in (q, k, v, ld)), 16,
        jnp.asarray(st1.numpy()))
    _close(y2, jy)
    _close(st2, jst)


def test_chunked_decay_attention_in_bf16_compute():
    """``compute_dtype=bf16``: the products' operands rounded to bf16,
    summed in float32, as JAX's ``preferred_element_type``."""
    arrays = _core_inputs(7, s=64)
    jy, js = jssm.chunked_decay_attention(*map(jnp.asarray, arrays), 16,
                                          compute_dtype=jnp.bfloat16)
    ty, ts = ssm.chunked_decay_attention(*map(torch.from_numpy, arrays), 16,
                                         dtype=torch.bfloat16)
    _close(ty, jy, torch.bfloat16)
    _close(ts, js, torch.bfloat16)
    with pytest.raises(ValueError, match="must divide"):
        ssm.chunked_decay_attention(*map(torch.from_numpy, arrays), 24)


def test_decay_attention_step_matches_jax():
    rng = np.random.default_rng(3)
    q, k = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, 3, 5)).astype(np.float32)
    ld = -np.abs(rng.normal(size=(2, 3))).astype(np.float32)
    st = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)
    jy, js = jssm.decay_attention_step(*map(jnp.asarray, (q, k, v, ld, st)))
    ty, ts = ssm.decay_attention_step(*map(torch.from_numpy,
                                           (q, k, v, ld, st)))
    _close(ty, jy)
    _close(ts, js)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_layer_matches_jax(block, dtype):
    """The full-sequence layer (64 tokens: two SMOKE chunks) from zeros
    and from a state, outputs and final states."""
    arch, cls, jinit, jlayer, _, tlayer, _ = BLOCKS[block]
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    params = jinit(jax.random.PRNGKey(1), jcfg)
    mod = _module(cls, tcfg, params, dtype)
    rng = np.random.default_rng(len(block))
    x = (rng.normal(size=(2, 64, jcfg.d_model)) * 0.5).astype(np.float32)
    xj, xt = _pair(x, dtype)
    jy, jst = jlayer(params, jcfg, xj[:, :32])
    ty, tst = tlayer(mod, tcfg, xt[:, :32])
    assert ty.dtype == dtype and ty.shape == (2, 32, jcfg.d_model)
    _close(ty, jy, dtype)
    for got, want in zip(_states(tst), _states(jst)):
        assert got.dtype == torch.float32
        _state_close(got, want, dtype)
    # on from the JAX state: the second half
    carried = [torch.from_numpy(_f32(s).copy()) for s in _states(jst)]
    jy, jst = jlayer(params, jcfg, xj[:, 32:], jst)
    ty, tst = tlayer(mod, tcfg, xt[:, 32:],
                     tuple(carried) if block == "slstm" else carried[0])
    _close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_step_matches_jax(block, dtype):
    """16 decode steps on both sides from the zero state: each output, and
    the states after the last."""
    arch, cls, jinit, _, jstep, _, tstep = BLOCKS[block]
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    params = jinit(jax.random.PRNGKey(2), jcfg)
    mod = _module(cls, tcfg, params, dtype)
    x = (np.random.default_rng(9).normal(size=(2, 16, jcfg.d_model))
         * 0.5).astype(np.float32)
    xj, xt = _pair(x, dtype)
    jst, tst = _zero_state(block, jcfg, 2)
    for t in range(16):
        jy, jst = jstep(params, jcfg, xj[:, t:t + 1], jst)
        ty, tst = tstep(mod, tcfg, xt[:, t:t + 1], tst)
        assert ty.shape == (2, 1, jcfg.d_model)
        _close(ty, jy, dtype)
    for got, want in zip(_states(tst), _states(jst)):
        _state_close(got, want, dtype)


@pytest.mark.parametrize("block", ["mamba2", "mlstm"])
def test_layer_matches_its_own_steps(block):
    """The JAX package's invariant (``tests/test_ssm.py``): the chunked
    layer equals the token-by-token decode recurrence, on the port."""
    arch, cls, *_, tlayer, tstep = BLOCKS[block]
    cfg = get_config(arch, smoke=True)
    mod = cls(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
              dtype=torch.float32)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.1
    y, st = tlayer(mod, cfg, x)
    _, state = _zero_state(block, cfg, 2)
    ys = []
    for t in range(32):
        yt, state = tstep(mod, cfg, x[:, t:t + 1], state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, **STEP_TOL)
    torch.testing.assert_close(state, st, **STEP_TOL)


def test_slstm_continues_a_sequence():
    """``tests/test_ssm.py``'s invariant: over [a; b] equals over a, then b
    from a's state."""
    cfg = get_config("xlstm-125m", smoke=True)
    mod = ssm.SLSTM(cfg, generator=torch.Generator().manual_seed(3),
                    device="cpu", dtype=torch.float32)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(4)) * 0.1
    y_all, _ = ssm.slstm_layer(mod, cfg, x)
    y_a, st = ssm.slstm_layer(mod, cfg, x[:, :8])
    y_b, _ = ssm.slstm_layer(mod, cfg, x[:, 8:], st)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1), y_all, rtol=1e-4,
                               atol=1e-5)


def test_bf16_compute_knob_matches_jax():
    """``ssm_compute_dtype="bf16"`` at the layer: mamba2 in bf16."""
    import dataclasses
    jcfg = dataclasses.replace(jax_config("zamba2-2.7b", smoke=True),
                               ssm_compute_dtype="bf16")
    tcfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True),
                               ssm_compute_dtype="bf16")
    params = jssm.init_mamba2(jax.random.PRNGKey(4), jcfg)
    mod = _module(ssm.Mamba2, tcfg, params, torch.bfloat16)
    x = (np.random.default_rng(4).normal(size=(2, 64, jcfg.d_model))
         * 0.5).astype(np.float32)
    xj, xt = _pair(x, torch.bfloat16)
    jy, jst = jssm.mamba2_layer(params, jcfg, xj)
    ty, tst = ssm.mamba2_layer(mod, tcfg, xt)
    _close(ty, jy, torch.bfloat16)
    _close(tst, jst, torch.bfloat16)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_parameters_follow_the_jax_dicts(block):
    """The names, shapes and dtypes: the JAX dict's paths; float32 where
    the JAX package keeps float32 whatever the storage dtype."""
    arch, cls, jinit, *_ = BLOCKS[block]
    cfg = jax_config(arch)
    want = jax.eval_shape(lambda k: jinit(k, cfg), jax.random.PRNGKey(0))
    mod = cls(get_config(arch), device="meta", dtype=torch.bfloat16)
    got = {k: (tuple(v.shape), v.dtype) for k, v in mod.state_dict().items()}
    assert {k: s for k, (s, _) in got.items()} == {
        k: tuple(v.shape) for k, v in _flat(want).items()}
    f32 = {k for k, (_, d) in got.items() if d == torch.float32}
    assert f32 == {k for k in got if k.endswith("scale")
                   or k in ("A_log", "D", "dt_bias", "r")}


# --------------------------------------------------------------------------
# the overflow of the reference's chunked core
# --------------------------------------------------------------------------

def _full_width_x(cfg, seed):
    return (np.random.default_rng(seed).normal(size=(1, 256, cfg.d_model))
            .astype(np.float32))


def test_mlstm_prefill_is_finite_where_the_reference_overflows():
    """One xlstm-125m mLSTM layer at full width over 1 x 256 tokens (one
    chunk): a chunk's log-decays sum to about -216, so the JAX package's
    ``exp(cum_i - cum_j)`` overflows above the diagonal and its output is
    NaN.  The port masks the exponent first: its output is finite and
    equals its own token-by-token recurrence."""
    jcfg, tcfg = jax_config("xlstm-125m"), get_config("xlstm-125m")
    params = jssm.init_mlstm(jax.random.PRNGKey(0), jcfg)
    x = _full_width_x(jcfg, 0)
    jy, jst = jssm.mlstm_layer(params, jcfg, jnp.asarray(x))
    assert np.isnan(_f32(jy)).any()
    assert np.isfinite(_f32(jst)).all()
    mod = _module(ssm.MLSTM, tcfg, params, torch.float32)
    ty, tst = ssm.mlstm_layer(mod, tcfg, torch.from_numpy(x))
    assert torch.isfinite(ty).all() and torch.isfinite(tst).all()
    ld = ssm._mlstm_project(mod, tcfg, torch.from_numpy(x))[-1]
    assert float(ld.sum(1).max()) < -88           # where exp(-cum) overflows
    _, state = _zero_state("mlstm", tcfg, 1)
    ys = []
    for t in range(256):
        yt, state = ssm.mlstm_step(mod, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                   state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), ty, **STEP_TOL)
    # the final state, where the JAX package is finite: the same
    _state_close(tst, jst)


def test_mamba2_at_full_width_matches_the_reference_where_it_is_finite():
    """zamba2-2.7b's Mamba2 at full width over 1 x 256 tokens: its
    log-decays sum to about -54 in the chunk, so the JAX package stays
    finite, and the port equals it."""
    jcfg, tcfg = jax_config("zamba2-2.7b"), get_config("zamba2-2.7b")
    params = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg)
    x = _full_width_x(jcfg, 1)
    jy, jst = jssm.mamba2_layer(params, jcfg, jnp.asarray(x))
    assert np.isfinite(_f32(jy)).all()
    mod = _module(ssm.Mamba2, tcfg, params, torch.float32)
    ty, tst = ssm.mamba2_layer(mod, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=F32_TOL,
                               atol=F32_TOL * np.abs(_f32(jy)).max())
    _state_close(tst, jst)
