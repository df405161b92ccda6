"""Parity of the port's ssm (xlstm-125m) and hybrid (zamba2-2.7b) models
with the JAX package's, on the CPU: parameters and checkpoints, the
prefill step, decode against a recurrent state and per-group KV caches,
and greedy serving.

The SMOKE configs run with ``n_layers=4``: two groups, so that xlstm has
two sLSTM layers and zamba2's one shared attention block runs twice, with
a KV cache for each group.  The JAX package's parameters enter through
``params_from_numpy`` and its decode state through
``decode_state_from_numpy``; the same numpy tokens go through both.
Tolerances, with their reasons:

* Logits (prefill, and decode teacher-forced from a JAX-filled state):
  within ``LOGIT_TOL`` (3e-2) of the JAX steps run op by op
  (``jax.disable_jit``), the argmax differing only at near ties: bf16
  products round an ulp apart.  The port rounds as eager JAX does.  At
  640 tokens (the blockwise attention path) a prefill logit in a million
  may lie beyond LOGIT_TOL of the op-by-op step; it must then be nearer
  than that step's to the float32 logits (the rounding is the JAX
  step's).  The
  jitted JAX steps keep some bf16 intermediates in float32 (ROADMAP,
  Reference conditions), and at zamba2 they lie up to 0.05 (prefill, 64
  tokens) and 0.04 (decode) from the op-by-op steps: beyond LOGIT_TOL in
  a few hundredths of a percent of the logits.  Against the jitted steps
  the port is held as the card is held against the CPU: its bf16 logits
  are no farther from the float32 logits (both packages agree on those
  within 2e-5) than 1.25 times the jitted step's.
* The recurrent states and KV caches: in bf16 the states carry the
  rounding differences above, so they are held with float32 activations
  on both sides (the JAX embedding patched to float32 for the test, the
  weights stored in float32): within 2e-4 abs and rel, the contract the
  card is held to against the CPU; the KV slots written are the same.
* Greedy generation: the tokens equal the op-by-op JAX package's up to
  the first near tie (within ``LOGIT_TOL``) of its logits.
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
from repro_torch.launch import serve, serve_decode
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import init_decode_state, init_params
from test_torch_moe import LOGIT_TOL, assert_logits_match

ARCHS = ["xlstm-125m", "zamba2-2.7b"]
STATE_TOL = 2e-4
N_LAYERS = 4


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _configs(name, **over):
    over = {"n_layers": N_LAYERS, **over}
    return (dataclasses.replace(jax_config(name, smoke=True), **over),
            dataclasses.replace(get_config(name, smoke=True), **over))


_models: dict = {}


def _pair(name, dtype=torch.bfloat16):
    """(jax cfg, port cfg, jax params, port model) for a SMOKE config with
    two groups, the port's weights stored in ``dtype``."""
    if (name, dtype) not in _models:
        jcfg, tcfg = _configs(name)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _models[name, dtype] = (jcfg, tcfg, params, npz.params_from_numpy(
            tcfg, jnpz._flatten(params), device="cpu", dtype=dtype))
    return _models[name, dtype]


def _no_tie(got, want):
    assert_logits_match(got, want, np.zeros(got.shape[:-1], bool))


def _eager(fn, *args):
    """``fn(*args)`` in the JAX package op by op, each bf16 operation
    rounded (no jit)."""
    with jax.disable_jit():
        return fn(*args)


def _f32_embed(p, tokens, dtype=None):
    return p["table"].astype(jnp.float32)[tokens]


def _jax_f32_prefill(jcfg, params, tok, monkeypatch):
    """The jitted JAX prefill with float32 activations (the embedding
    patched to float32; the weights are float32 already)."""
    with monkeypatch.context() as m:
        m.setattr(jlayers, "embed", _f32_embed)
        return _f32(jax.jit(jsteps.make_prefill_step(jcfg))(
            params, {"tokens": jnp.asarray(tok)}))


def _port_f32_prefill(model, cfg, tok):
    with torch.inference_mode():
        t = torch.as_tensor(tok)
        x = model.embed(t, dtype=torch.float32)
        x, _ = model.backbone(cfg, x, torch.arange(t.shape[1]).expand(
            *t.shape))
        return _f32(model.logits(model.ln_f(x)))


# --------------------------------------------------------------------------
# parameters, checkpoints and the decode state's layout
# --------------------------------------------------------------------------

def _jax_flat_shapes(cfg):
    shapes = jax.eval_shape(functools.partial(jmodel.init_params, cfg),
                            jax.random.PRNGKey(0))
    return {"/".join(jnpz._key_str(k) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}


def _port_flat_shapes(model):
    out: dict = {}
    for name, p in model.named_parameters():
        key, index = npz.flat_key(name)
        out.setdefault(key, []).append((index, tuple(p.shape)))
    shapes = {}
    for key, v in out.items():
        lead = () if v[0][0] is None else tuple(
            max(i[a] for i, _ in v) + 1 for a in range(len(v[0][0])))
        shapes[key] = lead + v[0][1]
    return shapes


@pytest.mark.parametrize("name,count", [("xlstm-125m", 144_936_192),
                                        ("zamba2-2.7b", 2_312_842_400)])
def test_full_width_parameter_names_and_shapes(name, count):
    """At full width, on the meta device: the JAX ``init_params``'s flat
    paths and shapes (``mlstm`` and ``mamba`` stacked over groups and the
    layers in each, ``slstm`` over groups, one ``shared_attn``)."""
    model = init_params(get_config(name), device="meta")
    assert _port_flat_shapes(model) == _jax_flat_shapes(jax_config(name))
    assert sum(p.numel() for p in model.parameters()) == count


def test_flat_keys_of_the_stacks():
    assert npz.flat_key("mlstm.1.2.up.w") == ("mlstm/up/w", (1, 2))
    assert npz.flat_key("slstm.2.r") == ("slstm/r", (2,))
    assert npz.flat_key("mamba.8.5.A_log") == ("mamba/A_log", (8, 5))
    assert npz.flat_key("shared_attn.attn.wq.w") == (
        "shared_attn/attn/wq/w", None)
    assert npz.flat_key("layers.3.attn.wq.w") == ("layers/attn/wq/w", (3,))


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_numpy_is_the_jax_params_rounded(name):
    """``params_from_numpy(_flatten(params))`` and back through
    ``to_numpy``: the JAX arrays, the projections rounded to bf16 and the
    float32 parameters as they are; in float32 storage, all as they
    are."""
    jcfg, tcfg, params, model = _pair(name)
    flat = jnpz._flatten(params)
    back = npz.to_numpy(model)
    assert set(back) == set(flat)
    keep = ("scale", "A_log", "/D", "dt_bias", "slstm/r")
    for key, arr in flat.items():
        want = arr if key.endswith(keep) else np.asarray(
            jnp.asarray(arr).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    f32 = _pair(name, torch.float32)[3]
    for key, arr in npz.to_numpy(f32).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)


@pytest.mark.parametrize("name", ARCHS)
def test_port_checkpoint_restores_into_jax(name, tmp_path):
    jcfg, tcfg, _, _ = _pair(name)
    model = init_params(tcfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    path = npz.save_checkpoint(str(tmp_path), 2, model)
    target = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    restored = jnpz._flatten(jnpz.restore_checkpoint(path, target))
    for key, arr in npz.to_numpy(model).items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)
    again = npz.load_checkpoint(path, tcfg, device="cpu")
    tok = np.random.default_rng(0).integers(0, 512, (1, 64))
    step = make_prefill_step(tcfg)
    assert torch.equal(step(again, {"tokens": tok}),
                       step(model, {"tokens": tok}))


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_decode_state_shapes(name):
    """At the dry-run's decode_32k shape (128 x 32768) on the meta device:
    the JAX ``init_decode_state``'s pytree, shapes and dtypes (bf16
    caches, float32 recurrent states)."""
    shapes = jax.eval_shape(functools.partial(
        jmodel.init_decode_state, jax_config(name), 128, 32_768))
    want = {"/".join(jnpz._key_str(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}
    got = npz.flat_state(init_decode_state(get_config(name), 128, 32_768,
                                            device="meta"))
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert str(t.dtype)[6:] == str(want[key].dtype), key


@pytest.mark.parametrize("name", ARCHS)
def test_decode_state_crosses_from_jax_and_back(name):
    jcfg, tcfg, params, _ = _pair(name)
    tok = np.random.default_rng(6).integers(0, 512, (2, 5)).astype(np.int32)
    _, jstate, _ = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(tok)}, 8)
    flat = jnpz._flatten(jstate)
    assert set(flat) == ({"mlstm", "slstm/#0", "slstm/#1", "slstm/#2",
                          "slstm/#3"} if name == "xlstm-125m"
                         else {"mamba", "kv/k", "kv/v"})
    state = npz.decode_state_from_numpy(tcfg, flat, device="cpu")
    back = npz.decode_state_to_numpy(state)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], _f32(arr), err_msg=key)
    for key, t in npz.flat_state(state).items():
        assert t.dtype == (torch.bfloat16 if key.startswith("kv")
                           else torch.float32), key
    missing = dict(flat)
    missing.pop(sorted(flat)[-1])
    with pytest.raises(KeyError, match="decode state keys"):
        npz.decode_state_from_numpy(tcfg, missing, device="cpu")
    bad = dict(flat)
    key = "mamba" if name == "zamba2-2.7b" else "slstm/#1"
    bad[key] = flat[key][:1]
    with pytest.raises(ValueError, match="shape"):
        npz.decode_state_from_numpy(tcfg, bad, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_updates_the_state_in_place(name):
    _, tcfg, _, model = _pair(name)
    state = init_decode_state(tcfg, 2, 6, device="cpu")
    flat = npz.flat_state(state)
    ptrs = {k: t.data_ptr() for k, t in flat.items()}
    logits, out = model.decode_step(state, [[3], [4]], [2, 5])
    assert out is state and logits.shape == (2, 1, 512)
    assert {k: t.data_ptr() for k, t in npz.flat_state(state).items()} \
        == ptrs
    for key, t in flat.items():
        if key.startswith("kv"):
            # one cache a group: rows write slots 2 and 5 only
            written = t.abs().sum(dim=(3, 4)) != 0          # (G, B, slots)
            assert written[:, 0].nonzero()[:, 1].unique().tolist() == [2]
            assert written[:, 1].nonzero()[:, 1].unique().tolist() == [5]
            assert written.any(-1).all()
        elif key == "slstm/#3":
            assert bool((t > -1e29).all())                  # m moved
        else:
            assert bool(t.any()), key


# --------------------------------------------------------------------------
# the prefill step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,seq,attn_impl", [
    ("xlstm-125m", 64, "xla_chunked"), ("xlstm-125m", 128, "xla_chunked"),
    ("zamba2-2.7b", 64, "xla_chunked"), ("zamba2-2.7b", 128, "pallas"),
    ("zamba2-2.7b", 640, "xla_chunked")],
    ids=["xlstm-64", "xlstm-128", "zamba2-naive-64", "zamba2-pallas-128",
         "zamba2-blockwise-640"])
def test_prefill_matches_jax(name, seq, attn_impl, monkeypatch):
    """zamba2's shared block goes through ``ops.flash_attention`` (its
    plain version here) once a group under ``pallas``, and under
    ``xla_chunked`` above 512 x 512 pairs; xlstm has no attention."""
    jcfg, tcfg, params, model = _pair(name)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    tok = np.random.default_rng(seq).integers(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    want = _f32(_eager(jsteps.make_prefill_step(jcfg), params,
                       {"tokens": jnp.asarray(tok)}))
    f32 = _jax_f32_prefill(jcfg, params, tok, monkeypatch)
    calls = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    logits = make_prefill_step(tcfg)(model, {"tokens": tok})
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (2, seq, jcfg.vocab_size)
    blockwise = attn_impl == "pallas" or seq * seq > 512 * 512
    groups = N_LAYERS // jcfg.attn_every if name == "zamba2-2.7b" else 0
    assert len(calls) == (groups if blockwise else 0)
    got = _f32(logits)
    # beyond LOGIT_TOL only where the port is the nearer of the two to the
    # float32 logits: there the difference is the op-by-op step's rounding
    beyond = np.abs(got - want) > LOGIT_TOL + LOGIT_TOL * np.abs(want)
    assert (np.abs(got - f32) <= np.abs(want - f32))[beyond].all()
    assert beyond.mean() < 1e-4
    _no_tie(np.where(beyond, want, got), want)


@pytest.mark.parametrize("seq", [64, 128])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_against_the_jitted_step(name, seq, monkeypatch):
    """Float32 activations: the port's logits within 2e-5 of the jitted
    JAX step's.  bf16: the port's logits no farther from those float32
    logits than 1.25 times the jitted JAX step's bf16 logits are, and the
    argmax differs from the jitted step's only where the float32 logits
    nearly tie (within twice the jitted step's error)."""
    jcfg, tcfg, params, model = _pair(name)
    f32_model = _pair(name, torch.float32)[3]
    tok = np.random.default_rng(seq + 1).integers(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    f32 = _jax_f32_prefill(jcfg, params, tok, monkeypatch)
    np.testing.assert_allclose(_port_f32_prefill(f32_model, tcfg, tok), f32,
                               rtol=2e-5, atol=2e-5)
    jitted = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)}))
    got = _f32(make_prefill_step(tcfg)(model, {"tokens": tok}))
    jit_err = np.abs(jitted - f32).max()
    assert np.abs(got - f32).max() <= 1.25 * jit_err
    differ = got.argmax(-1) != jitted.argmax(-1)
    srt = -np.sort(-f32, axis=-1)
    assert (srt[..., 0] - srt[..., 1])[differ].max(initial=0) <= 2 * jit_err


def test_prefill_refuses_a_length_the_chunks_do_not_divide():
    _, tcfg, _, model = _pair("xlstm-125m")
    with pytest.raises(ValueError, match="must divide"):
        make_prefill_step(tcfg)(model, {"tokens": np.zeros((1, 48), int)})


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _jax_filled(name, tok, cache_len, *, f32=False):
    """The JAX package's state after an 8-token prompt (jitted), and the
    port's copy of it; with ``f32`` the caches widened to float32 on both
    sides, so that later steps write float32."""
    jcfg, tcfg, params, model = _pair(name)
    _, jstate, s = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(tok[:, :8])}, cache_len)
    if f32:
        jstate = jax.tree.map(lambda a: a.astype(jnp.float32), jstate)
    return jstate, npz.decode_state_from_numpy(
        tcfg, jnpz._flatten(jstate), device="cpu"), s


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_jax_serve_step(name):
    """An 8-token prompt prefilled into a 24-slot state by the JAX package
    (jitted), carried across; then 16 teacher-forced steps on both sides
    (the JAX ones op by op): logits within LOGIT_TOL, and the KV caches
    write the same slots."""
    jcfg, tcfg, params, model = _pair(name)
    tok = np.random.default_rng(16).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    jstate, state, s = _jax_filled(name, tok, 24)
    jstep = jsteps.make_serve_step(jcfg)
    step = make_serve_step(tcfg)
    want, got = [], []
    for t in range(s, 24):
        jl, jstate = _eager(jstep, params, jstate,
                            jnp.asarray(tok[:, t:t + 1]),
                            jnp.full((2,), t, jnp.int32))
        tl, out = step(model, state, tok[:, t:t + 1], torch.full((2,), t))
        assert out is state and tl.shape == (2, 1, jcfg.vocab_size)
        want.append(_f32(jl))
        got.append(_f32(tl))
    _no_tie(np.concatenate(got, 1), np.concatenate(want, 1))
    back = npz.decode_state_to_numpy(state)
    for key, arr in jnpz._flatten(jstate).items():
        if key.startswith("kv"):
            np.testing.assert_array_equal(back[key] != 0, _f32(arr) != 0)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_states_match_jax_in_float32(name, monkeypatch):
    """With float32 activations on both sides (float32 weights and caches;
    the JAX embedding patched to float32): 16 teacher-forced steps from a
    JAX-filled state, every step's logits, the recurrent states and the
    per-group KV caches within 2e-4 abs and rel, the same slots written."""
    monkeypatch.setattr(jlayers, "embed", _f32_embed)
    jcfg, tcfg, params, model = _pair(name, torch.float32)
    tok = np.random.default_rng(17).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    jstate, state, s = _jax_filled(name, tok, 24, f32=True)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    for t in range(s, 24):
        jl, jstate = jstep(params, jstate, jnp.asarray(tok[:, t:t + 1]),
                           jnp.full((2,), t, jnp.int32))
        with torch.inference_mode():
            x = model.embed(torch.from_numpy(tok[:, t:t + 1]),
                            dtype=torch.float32)
            x = model.decode_backbone(tcfg, x, state, torch.full((2,), t))
            tl = model.logits(model.ln_f(x))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=STATE_TOL,
                                   atol=STATE_TOL)
    back = npz.decode_state_to_numpy(state)
    for key, arr in jnpz._flatten(jstate).items():
        want = _f32(arr)
        np.testing.assert_allclose(back[key], want, rtol=STATE_TOL,
                                   atol=STATE_TOL, err_msg=key)
        if key.startswith("kv"):
            np.testing.assert_array_equal(back[key] != 0, want != 0)


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_generation_matches_jax(name):
    """``prefill_into_cache`` and greedy decode from the same prompts (4 x
    16, then 12 generated) against the JAX package's, op by op: each
    row's tokens equal up to its first near tie of the JAX logits, and
    the last prompt position's logits within LOGIT_TOL."""
    jcfg, tcfg, params, model = _pair(name)
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    gen, cache_len = 12, 28
    jl, jstate, pos0 = _eager(jserve.prefill_into_cache, params, jcfg,
                              {"tokens": jnp.asarray(prompts)}, cache_len)
    jstep = jsteps.make_serve_step(jcfg)
    want_logits = [_f32(jl)[:, -1]]
    jtok = [np.asarray(jnp.argmax(jl[:, -1:], -1))]
    for t in range(gen - 1):
        jl, jstate = _eager(jstep, params, jstate, jnp.asarray(jtok[-1]),
                            jnp.full((4,), pos0 + t, jnp.int32))
        want_logits.append(_f32(jl)[:, -1])
        jtok.append(np.asarray(jnp.argmax(jl[:, -1:], -1)))
    want_tok = np.concatenate(jtok, 1)
    logits, state, s = serve.prefill_into_cache(
        model, tcfg, {"tokens": prompts}, cache_len)
    got_tok = serve.greedy_decode(model, tcfg, state, logits, s, gen).numpy()
    assert s == 16 and got_tok.shape == (4, gen)
    want_logits = np.stack(want_logits, 1)                  # (4, gen, V)
    srt = -np.sort(-want_logits, axis=-1)
    tie = srt[..., 0] - srt[..., 1] <= LOGIT_TOL
    for r in range(4):
        differ = np.flatnonzero(got_tok[r] != want_tok[r])
        first = int(differ[0]) if len(differ) else gen
        assert first == gen or tie[r, first], (r, first)
    np.testing.assert_allclose(_f32(logits)[:, -1], want_logits[:, 0],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert (got_tok[:, :2] == want_tok[:, :2]).any()


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_into_cache_matches_the_prefill_step(name):
    """The port's decode path over a prompt, position by position, against
    its own prefill step over the whole prompt (the check the card makes
    at full width)."""
    _, tcfg, _, model = _pair(name)
    prompts = np.random.default_rng(5).integers(0, 512, size=(2, 32))
    seen: list = []
    serve.prefill_into_cache(model, tcfg, {"tokens": prompts}, 32,
                             prompt_logits=seen)
    want = _f32(make_prefill_step(tcfg)(model, {"tokens": prompts}))
    _no_tie(_f32(torch.cat(seen, 1)), want)


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_generate_on_the_cpu(name):
    run = serve.generate(name, smoke=True, batch=2, prompt_len=8, gen=4,
                         device="cpu")
    assert run.tokens.shape == (2, 4) and run.last_logits.shape == (2, 1, 512)
    assert torch.equal(run.tokens[:, 0], run.last_logits[:, -1].argmax(-1))
    again = serve.generate(name, smoke=True, batch=2, prompt_len=8, gen=4,
                           device="cpu")
    assert torch.equal(again.tokens, run.tokens)


def test_serve_decode_serves_all_three_archs(capsys):
    out = serve_decode.main(["--device", "cpu"])
    assert list(out) == ["glm4-9b", "deepseek-moe-16b", "zamba2-2.7b"]
    assert all(t.shape == (4, 8) for t in out.values())
    assert "not ported" not in capsys.readouterr().out
