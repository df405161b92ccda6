"""Parity of the port's audio family (whisper-tiny) with the JAX package's,
on the CPU: parameters and checkpoints, the encoder, the prefill step
(the encoder over the stub frame embeddings, the causal decoder with a
cross-attention block a layer), decode against the self-attention KV
cache and the cached cross K/V, and greedy serving.

The SMOKE config (2 + 2 layers, MHA 4:4, 64 frames, tied embedding)
enters the port through ``params_from_numpy`` and its decode state
through ``decode_state_from_numpy``; the same numpy tokens and frames
(rounded to bf16, as the JAX package's input specs give them) go
through both packages.  Tolerances are the dense family's, with their
reasons (``tests/test_torch_vlm.py``): bf16 logits within ``LOGIT_TOL``
of the jitted JAX steps with the argmax differing only at near ties;
float32 activations on both sides within 2e-4 (the JAX embedding patched
to float32 and, since the JAX encoder casts its frames to
``layers.COMPUTE_DTYPE``, that dtype patched to float32 too); bf16
hidden states and the encoder's output no farther from the float32 ones
than 1.25 times the jitted JAX step's; the cross K/V the JAX package
caches at prefill within two bf16 ulps (a projection of the encoder's
output).

The attention runs through the naive path (64 frames, 48 text tokens:
every product of lengths at most 512^2) and through ``xla_chunked``'s
blockwise path at 600 frames and 520 text tokens: the encoder 600 x 600
and the cross-attention 520 x 600 without a mask, and the decoder's
causal 520 x 520, lengths that are no multiple of 128, which the card
pads (bounding the keys by ``kv_len``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import npz as jnpz
from repro.configs import get_config as jax_config
from repro.launch import serve as jserve, steps as jsteps
from repro.models import layers as jlayers, model as jmodel
from repro_torch.checkpoint import npz
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import init_decode_state, init_params
from repro_torch.models.model import sinusoidal
from test_torch_moe import LOGIT_TOL, ULP2
from test_torch_vlm import (F32_TOL, _f32, f32_embed, jax_decode_state_shapes,
                            jax_flat_shapes, no_tie, pair, port_flat_shapes)

NAME = "whisper-tiny"


def _batch(cfg, text, frames, *, seed, batch=2):
    """Numpy tokens and bf16-rounded frames: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    fr = rng.normal(size=(batch, frames, cfg.d_model)).astype(np.float32)
    fj = jnp.asarray(fr).astype(jnp.bfloat16)
    return ({"tokens": jnp.asarray(tok), "frames": fj},
            {"tokens": tok, "frames": torch.from_numpy(
                np.array(_f32(fj))).to(torch.bfloat16)})


def _f32_jax(monkeypatch):
    """The JAX package with float32 activations, its encoder too."""
    monkeypatch.setattr(jlayers, "embed", f32_embed)
    monkeypatch.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)


# --------------------------------------------------------------------------
# parameters, checkpoints and the decode state
# --------------------------------------------------------------------------

def test_full_width_parameter_names_and_shapes():
    """whisper-tiny at full width, on the meta device: the JAX
    ``init_params``'s flat paths and shapes (``enc_layers``,
    ``dec_layers`` and ``cross_layers`` stacked over layers;
    ``frame_proj``, ``ln_enc``), 36 587 136 parameters."""
    model = init_params(get_config(NAME), device="meta")
    assert port_flat_shapes(model) == jax_flat_shapes(jax_config(NAME))
    assert sum(p.numel() for p in model.parameters()) == 36_587_136
    assert len(model.enc_layers) == 4 and len(model.cross_layers) == 4


def test_flat_keys_of_the_stacks():
    assert npz.flat_key("enc_layers.3.attn.wq.w") == (
        "enc_layers/attn/wq/w", (3,))
    assert npz.flat_key("dec_layers.1.mlp.wi") == ("dec_layers/mlp/wi", (1,))
    assert npz.flat_key("cross_layers.2.ln.scale") == (
        "cross_layers/ln/scale", (2,))
    assert npz.flat_key("frame_proj.w") == ("frame_proj/w", None)
    assert npz.flat_key("ln_enc.scale") == ("ln_enc/scale", None)


def test_params_from_numpy_is_the_jax_params_rounded():
    jcfg, tcfg, params, model = pair(NAME)
    flat = jnpz._flatten(params)
    back = npz.to_numpy(model)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        want = arr if key.endswith("scale") else np.asarray(
            jnp.asarray(arr).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    for key, arr in npz.to_numpy(pair(NAME, torch.float32)[3]).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)


def test_checkpoint_round_trip(tmp_path):
    """The port's checkpoint loads back bit for bit (and gives the same
    prefill), and into the JAX package's ``restore_checkpoint``."""
    jcfg, tcfg, _, _ = pair(NAME)
    model = init_params(tcfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    path = npz.save_checkpoint(str(tmp_path), 4, model)
    again = npz.load_checkpoint(path, tcfg, device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    target = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    restored = jnpz._flatten(jnpz.restore_checkpoint(path, target))
    for key, arr in npz.to_numpy(model).items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)
    _, tb = _batch(tcfg, 16, 64, seed=0)
    step = make_prefill_step(tcfg)
    assert torch.equal(step(again, tb), step(model, tb))


def test_full_width_decode_state_shapes():
    """At full width (batch 4, 48 slots) on the meta device: the JAX
    ``init_decode_state``'s pytree, shapes and dtypes: the decoder's KV
    caches and the cross K/V of 1500 frames, all bf16."""
    want = jax_decode_state_shapes(jax_config(NAME), 4, 48)
    got = npz.flat_state(init_decode_state(get_config(NAME), 4, 48,
                                           device="meta"))
    assert set(got) == set(want) == {"kv/k", "kv/v", "cross_k", "cross_v"}
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert t.dtype == torch.bfloat16
    assert tuple(got["cross_k"].shape) == (4, 4, 1500, 6, 64)


def test_decode_state_crosses_from_jax_and_back():
    """A state the JAX package filled (its prefill_into_cache: the
    encoder's cross K/V, then 5 prompt tokens) crosses into the port and
    back bit for bit; the frames' count comes from the arrays."""
    jcfg, tcfg, params, _ = pair(NAME)
    jb, _ = _batch(jcfg, 5, 40, seed=6)
    _, jstate, _ = jserve.prefill_into_cache(params, jcfg, jb, 8)
    flat = jnpz._flatten(jstate)
    assert set(flat) == {"kv/k", "kv/v", "cross_k", "cross_v"}
    state = npz.decode_state_from_numpy(tcfg, flat, device="cpu")
    assert tuple(state["cross_k"].shape) == (2, 2, 40, 4, 32)
    back = npz.decode_state_to_numpy(state)
    for key, arr in flat.items():
        assert npz.flat_state(state)[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(back[key], _f32(arr), err_msg=key)
    again = npz.decode_state_from_numpy(tcfg, back, device="cpu")
    for key, t in npz.flat_state(again).items():
        assert torch.equal(t, npz.flat_state(state)[key].float())
    bad = dict(flat, cross_v=flat["cross_v"][:, :, :39])
    with pytest.raises(ValueError, match="shape"):
        npz.decode_state_from_numpy(tcfg, bad, device="cpu")
    missing = {k: v for k, v in flat.items() if k != "cross_v"}
    with pytest.raises(KeyError, match="decode state keys"):
        npz.decode_state_from_numpy(tcfg, missing, device="cpu")


# --------------------------------------------------------------------------
# the encoder and the prefill step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(1500, 384), (64, 128)])
def test_sinusoid_matches_jax(n, d):
    """float32 ``sin``/``cos`` of angles up to 1500 rad: within 1e-5 of the
    JAX package's (its ``pow`` and ``sin`` round an ulp apart from
    torch's, and an ulp of an angle of 1500 is 1.2e-4 of it)."""
    np.testing.assert_allclose(sinusoidal(n, d).numpy(),
                               np.asarray(jmodel._sinusoidal(n, d)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("frames", [64, 600], ids=["naive", "blockwise"])
def test_encoder_matches_jax(frames, monkeypatch):
    """``encode_audio``: in float32 (both sides) within 2e-4 of the JAX
    ``_encode_audio``; in bf16 no farther from those float32 states than
    1.25 times the jitted JAX encoder's.  At 600 frames the encoder's
    attention is blockwise (600^2 > 512^2), one call a layer."""
    jcfg, tcfg, params, model = pair(NAME)
    jb, tb = _batch(jcfg, 8, frames, seed=frames)
    enc = jax.jit(functools.partial(jmodel._encode_audio, cfg=jcfg))
    want = _f32(enc(params, frames=jb["frames"]))
    with monkeypatch.context() as m:
        _f32_jax(m)
        f32 = _f32(jax.jit(functools.partial(jmodel._encode_audio,
                                             cfg=jcfg))(
            params, frames=jb["frames"].astype(jnp.float32)))
    seen = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: seen.append(a[0].shape[2])
                        or real(*a, **kw))
    with torch.inference_mode():
        got = model.encode_audio(tcfg, tb["frames"])
        got_f32 = pair(NAME, torch.float32)[3].encode_audio(
            tcfg, tb["frames"], dtype=torch.float32)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (2, frames, jcfg.d_model)
    assert seen == ([frames] * 2 * tcfg.n_encoder_layers if frames > 512
                    else [])
    np.testing.assert_allclose(_f32(got_f32), f32, rtol=F32_TOL,
                               atol=F32_TOL)
    assert np.abs(_f32(got) - f32).max() <= 1.25 * np.abs(want - f32).max()


@pytest.mark.parametrize("text,frames,attn_impl,calls", [
    (48, 64, "xla_chunked", 0), (128, 128, "pallas", 6),
    (520, 600, "xla_chunked", 6)],
    ids=["naive", "pallas-128", "blockwise-600-frames"])
def test_prefill_matches_jax(text, frames, attn_impl, calls, monkeypatch):
    """Logits within LOGIT_TOL of the jitted JAX step, argmax differing
    only at near ties.  Under ``pallas`` and on the blockwise path each
    encoder layer, decoder layer and cross-attention block calls
    ``ops.flash_attention`` (here ``ref.attention_ref``) once."""
    jcfg, tcfg, params, model = pair(NAME)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    jb, tb = _batch(jcfg, text, frames, seed=text + frames)
    want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(params, jb))
    seen = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    logits = make_prefill_step(tcfg)(model, tb)
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (2, text, jcfg.vocab_size)
    assert len(seen) == calls
    no_tie(_f32(logits), want)


@pytest.mark.parametrize("text,frames", [(48, 64), (520, 600)],
                         ids=["naive", "blockwise"])
def test_float32_prefill_within_2e4(text, frames, monkeypatch):
    jcfg, tcfg, params, _ = pair(NAME)
    model = pair(NAME, torch.float32)[3]
    jb, tb = _batch(jcfg, text, frames, seed=text + 2)
    with monkeypatch.context() as m:
        _f32_jax(m)
        jb["frames"] = jb["frames"].astype(jnp.float32)
        want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(params, jb))
    with torch.inference_mode():
        x, _ = model.hidden(tb, dtype=torch.float32)
        got = _f32(model.logits(x))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_hidden_states_match_jax(monkeypatch):
    """``hidden``: bf16 no farther from the float32 states than 1.25
    times the jitted JAX step's; the frames are attended to (other frames
    move the text's states)."""
    jcfg, tcfg, params, model = pair(NAME)
    jb, tb = _batch(jcfg, 40, 64, seed=1)
    want = _f32(jax.jit(functools.partial(jmodel.hidden, cfg=jcfg))(
        params, batch=jb)[0])
    with monkeypatch.context() as m:
        _f32_jax(m)
        f32 = _f32(jax.jit(functools.partial(jmodel.hidden, cfg=jcfg))(
            params, batch=dict(jb, frames=jb["frames"].astype(
                jnp.float32)))[0])
    with torch.inference_mode():
        got, aux = model.hidden(tb)
        moved, _ = model.hidden(dict(tb, frames=-tb["frames"]))
    assert tuple(got.shape) == (2, 40, jcfg.d_model) and float(aux) == 0
    assert np.abs(_f32(got) - f32).max() <= 1.25 * np.abs(want - f32).max()
    assert not torch.equal(got, moved)


# --------------------------------------------------------------------------
# decode and serving
# --------------------------------------------------------------------------

def test_prefill_into_cache_matches_jax():
    """The port's ``prefill_into_cache``: the cross K/V of every decoder
    layer within two bf16 ulps of the JAX package's (a projection of the
    encoder's output), the self-attention caches writing the same slots,
    the last prompt position's logits within LOGIT_TOL."""
    jcfg, tcfg, params, model = pair(NAME)
    jb, tb = _batch(jcfg, 12, 64, seed=3)
    jl, jstate, _ = jserve.prefill_into_cache(params, jcfg, jb, 16)
    seen: list = []
    tl, state, s = serve.prefill_into_cache(model, tcfg, tb, 16,
                                            prompt_logits=seen)
    assert s == 12 and len(seen) == 12
    for key in ("cross_k", "cross_v"):
        want = _f32(jstate[key])
        np.testing.assert_allclose(_f32(state[key]), want, rtol=ULP2,
                                   atol=ULP2 * np.abs(want).max())
    for key in ("k", "v"):
        np.testing.assert_array_equal(_f32(state["kv"][key]) != 0,
                                      _f32(jstate["kv"][key]) != 0)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_decode_step_matches_jax_serve_step():
    """An 8-token prompt over 64 frames prefilled into a 24-slot cache by
    the JAX package, carried across; then 16 teacher-forced steps on both
    sides: the decoder's self-attention, then the plain float32
    cross-attention against the cached K/V."""
    jcfg, tcfg, params, model = pair(NAME)
    jb, _ = _batch(jcfg, 24, 64, seed=16)
    tok = np.array(jb["tokens"])
    _, jstate, s = jserve.prefill_into_cache(
        params, jcfg, dict(jb, tokens=jb["tokens"][:, :8]), 24)
    state = npz.decode_state_from_numpy(tcfg, jnpz._flatten(jstate),
                                        device="cpu")
    ptrs = {k: t.data_ptr() for k, t in npz.flat_state(state).items()}
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    step = make_serve_step(tcfg)
    want, got = [], []
    for t in range(s, 24):
        jl, jstate = jstep(params, jstate, jnp.asarray(tok[:, t:t + 1]),
                           jnp.full((2,), t, jnp.int32))
        tl, out = step(model, state, tok[:, t:t + 1], torch.full((2,), t))
        assert out is state
        want.append(_f32(jl))
        got.append(_f32(tl))
    no_tie(np.concatenate(got, 1), np.concatenate(want, 1))
    assert {k: t.data_ptr() for k, t in npz.flat_state(state).items()} \
        == ptrs


def test_float32_decode_within_2e4(monkeypatch):
    """float32 activations, weights and caches on both sides: the JAX
    package's prefill_into_cache over 64 frames and 6 prompt tokens (its
    self-attention caches, bf16 by their default, widened to float32 after
    it, so that later steps write float32 on both sides), then 10
    teacher-forced steps; every step's logits and the state within
    2e-4."""
    jcfg, tcfg, params, _ = pair(NAME)
    model = pair(NAME, torch.float32)[3]
    _f32_jax(monkeypatch)
    jb, tb = _batch(jcfg, 16, 64, seed=8)
    jb["frames"] = jb["frames"].astype(jnp.float32)
    tok = np.array(jb["tokens"])
    _, jstate, s = jserve.prefill_into_cache(
        params, jcfg, dict(jb, tokens=jb["tokens"][:, :6]), 16)
    jstate = jax.tree.map(lambda a: a.astype(jnp.float32), jstate)
    state = npz.decode_state_from_numpy(
        tcfg, {k: _f32(v) for k, v in jnpz._flatten(jstate).items()},
        device="cpu")
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    for t in range(s, 16):
        jl, jstate = jstep(params, jstate, jnp.asarray(tok[:, t:t + 1]),
                           jnp.full((2,), t, jnp.int32))
        with torch.inference_mode():
            x = model.embed(torch.from_numpy(tok[:, t:t + 1]),
                            dtype=torch.float32)
            x = model.decode_backbone(tcfg, x, state, torch.full((2,), t))
            tl = model.logits(model.ln_f(x))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=F32_TOL,
                                   atol=F32_TOL)
    back = npz.decode_state_to_numpy(state)
    for key, arr in jnpz._flatten(jstate).items():
        np.testing.assert_allclose(back[key], _f32(arr), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=key)


def test_greedy_generation_matches_jax():
    """``prefill_into_cache`` and greedy decode from the same prompts and
    frames, 4 x 16 tokens then 12 generated: each row's tokens equal the
    JAX package's up to its first near tie of the JAX logits."""
    jcfg, tcfg, params, model = pair(NAME)
    jb, tb = _batch(jcfg, 16, 64, seed=4, batch=4)
    gen, cache_len = 12, 28
    jl, jstate, pos0 = jserve.prefill_into_cache(params, jcfg, jb, cache_len)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    want_logits = [_f32(jl)[:, -1]]
    jtok = [np.asarray(jnp.argmax(jl[:, -1:], -1))]
    for t in range(gen - 1):
        jl, jstate = jstep(params, jstate, jnp.asarray(jtok[-1]),
                           jnp.full((4,), pos0 + t, jnp.int32))
        want_logits.append(_f32(jl)[:, -1])
        jtok.append(np.asarray(jnp.argmax(jl[:, -1:], -1)))
    want_tok = np.concatenate(jtok, 1)
    logits, state, s = serve.prefill_into_cache(model, tcfg, tb, cache_len)
    got_tok = serve.greedy_decode(model, tcfg, state, logits, s, gen).numpy()
    srt = -np.sort(-np.stack(want_logits, 1), axis=-1)
    tie = srt[..., 0] - srt[..., 1] <= LOGIT_TOL
    for r in range(4):
        differ = np.flatnonzero(got_tok[r] != want_tok[r])
        first = int(differ[0]) if len(differ) else gen
        assert first == gen or tie[r, first], (r, first)


def test_prefill_into_cache_matches_the_prefill_step():
    """The decode path over a prompt (after the frames' cross K/V) against
    the port's own prefill step over the same prompt and frames: within
    LOGIT_TOL, argmax differing only at near ties."""
    _, tcfg, _, model = pair(NAME)
    _, tb = _batch(tcfg, 32, 64, seed=5)
    seen: list = []
    serve.prefill_into_cache(model, tcfg, tb, 32, prompt_logits=seen)
    want = _f32(make_prefill_step(tcfg)(model, tb))
    no_tie(_f32(torch.cat(seen, 1)), want)


def test_generate_on_the_cpu():
    """SMOKE serving: the frames (2, 64, 128) in bf16 drawn after the
    prompts from the seed; the same seed gives the same request and
    tokens."""
    run = serve.generate(NAME, smoke=True, batch=2, prompt_len=8, gen=4,
                         device="cpu")
    assert run.tokens.shape == (2, 4) and run.prompts.shape == (2, 8)
    assert run.batch["frames"].shape == (2, 64, 128)
    assert run.batch["frames"].dtype == torch.bfloat16
    again = serve.generate(NAME, smoke=True, batch=2, prompt_len=8, gen=4,
                           device="cpu")
    assert torch.equal(again.batch["frames"], run.batch["frames"])
    assert torch.equal(again.tokens, run.tokens)
    assert torch.equal(run.tokens[:, 0], run.last_logits[:, -1].argmax(-1))
