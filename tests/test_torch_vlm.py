"""Parity of the port's vlm family (internvl2-1b) with the JAX package's,
on the CPU: parameters and checkpoints, the prefill step with the stub
vision tower's patches before the text, decode against the dense KV
cache, and greedy serving.

The SMOKE config (2 layers, 16 patches, GQA 4:2, QKV bias) enters the
port through ``params_from_numpy`` and its decode state through
``decode_state_from_numpy``; the same numpy tokens and patches (rounded
to bf16, as the JAX package's input specs give them) go through both
packages.  Tolerances are the dense family's (``tests/test_torch_lm.py``,
``tests/test_torch_decode.py``), with their reasons:

* Logits (prefill, and decode teacher-forced from a JAX-filled cache):
  within ``LOGIT_TOL`` (3e-2) of the jitted JAX steps, the argmax
  differing only at near ties: bf16 products round an ulp apart.  The
  final bf16 hidden states no farther from the float32 ones than 1.25
  times the jitted JAX step's (the card's rule against the CPU).
* With float32 activations on both sides (the JAX embedding patched to
  float32, the port's weights stored in float32): logits and the caches
  within 2e-4 abs and rel, the contract the card is held to against the
  CPU.
* Greedy generation: the tokens equal the JAX package's up to the first
  near tie (within ``LOGIT_TOL``) of its logits.

The prefill runs through the naive attention (16 + 48 tokens), through
``pallas`` (16 + 112 = 128 tokens, ``ops.flash_attention``'s plain
version here) and through ``xla_chunked``'s blockwise path (16 + 512 =
528 tokens: 528^2 > 512^2, a length that is no multiple of 128).
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
from test_torch_moe import LOGIT_TOL, assert_logits_match

NAME = "internvl2-1b"
F32_TOL = 2e-4


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


_models: dict = {}


def pair(name, dtype=torch.bfloat16):
    """(jax cfg, port cfg, jax params, port model) for a SMOKE config, the
    port's weights stored in ``dtype``."""
    if (name, dtype) not in _models:
        jcfg, tcfg = jax_config(name, smoke=True), get_config(name,
                                                             smoke=True)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _models[name, dtype] = (jcfg, tcfg, params, npz.params_from_numpy(
            tcfg, jnpz._flatten(params), device="cpu", dtype=dtype))
    return _models[name, dtype]


def no_tie(got, want):
    assert_logits_match(got, want, np.zeros(got.shape[:-1], bool))


def f32_embed(p, tokens, dtype=None):
    return p["table"].astype(jnp.float32)[tokens]


def jax_flat_shapes(cfg):
    shapes = jax.eval_shape(functools.partial(jmodel.init_params, cfg),
                            jax.random.PRNGKey(0))
    return {"/".join(jnpz._key_str(k) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}


def port_flat_shapes(model):
    out: dict = {}
    for name, p in model.named_parameters():
        key, index = npz.flat_key(name)
        out.setdefault(key, []).append((index, tuple(p.shape)))
    return {k: ((max(i[0] for i, _ in v) + 1,) + v[0][1])
            if v[0][0] is not None else v[0][1] for k, v in out.items()}


def jax_decode_state_shapes(cfg, batch, length):
    shapes = jax.eval_shape(functools.partial(
        jmodel.init_decode_state, cfg, batch, length))
    return {"/".join(jnpz._key_str(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}


def _batch(cfg, text, *, seed, batch=2, patches=None):
    """Numpy tokens and bf16-rounded patches: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    n = cfg.n_frontend_tokens if patches is None else patches
    pat = rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)
    pj = jnp.asarray(pat).astype(jnp.bfloat16)
    return ({"tokens": jnp.asarray(tok), "patches": pj},
            {"tokens": tok, "patches": torch.from_numpy(
                np.array(_f32(pj))).to(torch.bfloat16)})


# --------------------------------------------------------------------------
# parameters, checkpoints and the decode state
# --------------------------------------------------------------------------

def test_full_width_parameter_names_and_shapes():
    """internvl2-1b at full width, on the meta device: the JAX
    ``init_params``'s flat paths and shapes (``patch_proj`` beside the
    dense stack), 494 583 808 parameters."""
    model = init_params(get_config(NAME), device="meta")
    assert port_flat_shapes(model) == jax_flat_shapes(jax_config(NAME))
    assert sum(p.numel() for p in model.parameters()) == 494_583_808
    assert tuple(model.patch_proj.w.shape) == (896, 896)
    assert model.layers[0].attn.wq.b is not None


def test_params_from_numpy_is_the_jax_params_rounded():
    jcfg, tcfg, params, model = pair(NAME)
    flat = jnpz._flatten(params)
    back = npz.to_numpy(model)
    assert set(back) == set(flat) and "patch_proj/w" in flat
    assert npz.flat_key("patch_proj.w") == ("patch_proj/w", None)
    for key, arr in flat.items():
        want = arr if key.endswith("scale") else np.asarray(
            jnp.asarray(arr).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    for key, arr in npz.to_numpy(pair(NAME, torch.float32)[3]).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)


def test_checkpoint_round_trip(tmp_path):
    """The port's checkpoint loads back bit for bit, and into the JAX
    package's ``restore_checkpoint``."""
    jcfg, tcfg, _, _ = pair(NAME)
    model = init_params(tcfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    path = npz.save_checkpoint(str(tmp_path), 3, model)
    again = npz.load_checkpoint(path, tcfg, device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    target = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    restored = jnpz._flatten(jnpz.restore_checkpoint(path, target))
    for key, arr in npz.to_numpy(model).items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)


def test_decode_state_is_the_dense_one_and_crosses_both_ways():
    """The vlm decode state is the dense family's ``{"kv"}`` at full width
    (shapes and dtype of the JAX ``init_decode_state``); a state the JAX
    package filled crosses into the port and back bit for bit, in bf16
    and in float32."""
    want = jax_decode_state_shapes(jax_config(NAME), 4, 48)
    got = npz.flat_state(init_decode_state(get_config(NAME), 4, 48,
                                           device="meta"))
    assert set(got) == set(want) == {"kv/k", "kv/v"}
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape
        assert t.dtype == torch.bfloat16
    jcfg, tcfg, params, _ = pair(NAME)
    tok = np.random.default_rng(6).integers(0, 512, (2, 5)).astype(np.int32)
    _, jstate, _ = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(tok)}, 8)
    flat = jnpz._flatten(jstate)
    for dtype in (torch.bfloat16, torch.float32):
        arrays = flat if dtype == torch.bfloat16 else {
            k: _f32(v) for k, v in flat.items()}
        state = npz.decode_state_from_numpy(tcfg, arrays, device="cpu")
        assert state["kv"]["k"].dtype == dtype
        back = npz.decode_state_to_numpy(state)
        for key, arr in flat.items():
            np.testing.assert_array_equal(back[key], _f32(arr))
        again = npz.decode_state_from_numpy(tcfg, back, device="cpu")
        for key, t in npz.flat_state(again).items():
            assert torch.equal(t, npz.flat_state(state)[key].float())


# --------------------------------------------------------------------------
# the prefill step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("text,attn_impl,calls", [
    (48, "xla_chunked", 0), (112, "pallas", 2), (512, "xla_chunked", 2)],
    ids=["naive-64", "pallas-128", "blockwise-528"])
def test_prefill_matches_jax(text, attn_impl, calls, monkeypatch):
    """16 patches before the text: logits over the text positions alone,
    within LOGIT_TOL of the jitted JAX step; the blockwise paths call
    ``ops.flash_attention`` (here ``ref.attention_ref``) once a layer."""
    jcfg, tcfg, params, model = pair(NAME)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    jb, tb = _batch(jcfg, text, seed=text)
    want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(params, jb))
    seen = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: seen.append(a[0].shape[2])
                        or real(*a, **kw))
    logits = make_prefill_step(tcfg)(model, tb)
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (2, text, jcfg.vocab_size)
    assert seen == [text + 16] * calls
    no_tie(_f32(logits), want)


def test_hidden_trims_the_patch_rows(monkeypatch):
    """``hidden``: the final states of the text rows alone.  In float32
    (both sides) within 2e-4 of the JAX ``hidden``; in bf16 no farther
    from those float32 states than 1.25 times the jitted JAX step's bf16
    states are (XLA keeps some bf16 intermediates in float32, so the two
    bf16 results differ by more than their own rounding in a few
    elements).  The patches are attended to (other patches move the
    text's states), and the states equal the stack run by hand over
    [patch_proj(patches), embed(tokens)]."""
    jcfg, tcfg, params, model = pair(NAME)
    jb, tb = _batch(jcfg, 40, seed=1)
    jhidden = jax.jit(functools.partial(jmodel.hidden, cfg=jcfg))
    want = _f32(jhidden(params, batch=jb)[0])
    with monkeypatch.context() as m:
        m.setattr(jlayers, "embed", f32_embed)
        f32 = _f32(jax.jit(functools.partial(jmodel.hidden, cfg=jcfg))(
            params, batch=dict(jb, patches=jb["patches"].astype(
                jnp.float32)))[0])
    with torch.inference_mode():
        got_f32, _ = pair(NAME, torch.float32)[3].hidden(
            tb, dtype=torch.float32)
        got, aux = model.hidden(tb)
        other = dict(tb, patches=-tb["patches"])
        moved, _ = model.hidden(other)
        x = torch.cat([model.patch_proj(tb["patches"]),
                       model.embed(torch.from_numpy(tb["tokens"]))], 1)
        by_hand, _ = model.backbone(tcfg, x, torch.arange(56).expand(2, 56))
        by_hand = model.ln_f(by_hand)[:, 16:]
    assert tuple(got.shape) == (2, 40, jcfg.d_model) and float(aux) == 0
    np.testing.assert_allclose(_f32(got_f32), f32, rtol=F32_TOL,
                               atol=F32_TOL)
    assert np.abs(_f32(got) - f32).max() <= 1.25 * np.abs(want - f32).max()
    assert torch.equal(got, by_hand)
    assert not torch.equal(got, moved)


@pytest.mark.parametrize("text", [48, 512], ids=["naive", "blockwise"])
def test_float32_prefill_within_2e4(text, monkeypatch):
    """float32 activations on both sides (float32 patches too): the
    logits within 2e-4 abs and rel."""
    jcfg, tcfg, params, _ = pair(NAME)
    model = pair(NAME, torch.float32)[3]
    jb, tb = _batch(jcfg, text, seed=text + 1)
    jb["patches"] = jb["patches"].astype(jnp.float32)
    with monkeypatch.context() as m:
        m.setattr(jlayers, "embed", f32_embed)
        want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(params, jb))
    with torch.inference_mode():
        x, _ = model.hidden(tb, dtype=torch.float32)
        got = _f32(model.logits(x))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


# --------------------------------------------------------------------------
# decode and serving (the dense decode path; no patches, as in the JAX
# package's prefill_into_cache)
# --------------------------------------------------------------------------

def test_decode_step_matches_jax_serve_step():
    """An 8-token prompt prefilled into a 24-slot cache by the JAX package,
    carried across; then 16 teacher-forced steps on both sides."""
    jcfg, tcfg, params, model = pair(NAME)
    tok = np.random.default_rng(16).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    _, jstate, s = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(tok[:, :8])}, 24)
    state = npz.decode_state_from_numpy(tcfg, jnpz._flatten(jstate),
                                        device="cpu")
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


def test_float32_decode_within_2e4(monkeypatch):
    """float32 activations, weights and caches on both sides: 12
    teacher-forced steps from an empty cache, every step's logits and the
    caches within 2e-4."""
    jcfg, tcfg, params, _ = pair(NAME)
    model = pair(NAME, torch.float32)[3]
    tok = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    monkeypatch.setattr(jlayers, "embed", f32_embed)
    jstate = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jmodel.init_decode_state(jcfg, 2, 12))
    state = init_decode_state(tcfg, 2, 12, device="cpu",
                              dtype=torch.float32)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    for t in range(12):
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
    """``prefill_into_cache`` and greedy decode from the same prompts, 4 x
    16 tokens then 12 generated, against the JAX package's: each row's
    tokens equal up to its first near tie of the JAX logits, the last
    prompt position's logits within LOGIT_TOL."""
    jcfg, tcfg, params, model = pair(NAME)
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    gen, cache_len = 12, 28
    jl, jstate, pos0 = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(prompts)}, cache_len)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    want_logits = [_f32(jl)[:, -1]]
    jtok = [np.asarray(jnp.argmax(jl[:, -1:], -1))]
    for t in range(gen - 1):
        jl, jstate = jstep(params, jstate, jnp.asarray(jtok[-1]),
                           jnp.full((4,), pos0 + t, jnp.int32))
        want_logits.append(_f32(jl)[:, -1])
        jtok.append(np.asarray(jnp.argmax(jl[:, -1:], -1)))
    want_tok = np.concatenate(jtok, 1)
    logits, state, s = serve.prefill_into_cache(
        model, tcfg, {"tokens": prompts}, cache_len)
    got_tok = serve.greedy_decode(model, tcfg, state, logits, s, gen).numpy()
    want_logits = np.stack(want_logits, 1)
    srt = -np.sort(-want_logits, axis=-1)
    tie = srt[..., 0] - srt[..., 1] <= LOGIT_TOL
    for r in range(4):
        differ = np.flatnonzero(got_tok[r] != want_tok[r])
        first = int(differ[0]) if len(differ) else gen
        assert first == gen or tie[r, first], (r, first)
    np.testing.assert_allclose(_f32(logits)[:, -1], want_logits[:, 0],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_prefill_into_cache_matches_the_prefill_step():
    """The decode path over a prompt (no patches) against the prefill step
    over the same prompt with an image of no patches, (B, 0, D): within
    LOGIT_TOL, argmax differing only at near ties (the check the card
    makes at full width)."""
    _, tcfg, _, model = pair(NAME)
    prompts = np.random.default_rng(5).integers(0, 512, size=(2, 32))
    seen: list = []
    serve.prefill_into_cache(model, tcfg, {"tokens": prompts}, 32,
                             prompt_logits=seen)
    want = _f32(make_prefill_step(tcfg)(model, {
        "tokens": prompts,
        "patches": torch.zeros((2, 0, tcfg.d_model), dtype=torch.bfloat16)}))
    no_tie(_f32(torch.cat(seen, 1)), want)


def test_generate_on_the_cpu():
    run = serve.generate(NAME, smoke=True, batch=2, prompt_len=8, gen=4,
                         device="cpu")
    assert run.tokens.shape == (2, 4) and run.prompts.shape == (2, 8)
    assert set(run.batch) == {"tokens"}
    assert run.last_logits.shape == (2, 1, 512)
    assert torch.equal(run.tokens[:, 0], run.last_logits[:, -1].argmax(-1))
