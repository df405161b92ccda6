"""Parity of the port's KV-cache decode and greedy serving with the JAX
package's, on the CPU.

The JAX package's parameters enter the port through
``params_from_numpy`` and its decode state through
``decode_state_from_numpy``; the same numpy tokens go through both
packages.  Tolerances, with their reasons:

* ``attention_decode``: outputs and the K/V it writes within two bf16
  ulps, as the layers of ``tests/test_torch_lm.py`` (a projection, then
  RoPE); the slots written are exactly the JAX package's (the ring buffer
  under a window, the last slot past the cache without one) and every
  other slot stays zero.
* The port's decode against its own prefill: within the JAX package's
  own tolerance for that invariant (``tests/test_attention.py``, 2e-3).
* ``decode_step``, teacher-forced from a cache the JAX package filled,
  against its jitted serve step: logits within 3e-2 (``LOGIT_TOL``, the
  prefill's), the argmax differing only at near ties.  In the moe family
  the routers are recorded on both sides and compared as in
  ``tests/test_torch_moe.py``: logits are held where no differing router
  choice reaches them, and a differing choice must be a near tie of the
  JAX router.
* Greedy generation: the tokens equal the JAX package's up to the first
  near tie of the JAX logits (within ``LOGIT_TOL``) or of the port's
  router.
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
from repro.models import attention as jattn, model as jmodel
from repro_torch.checkpoint import npz
from repro_torch.configs import get_config
from repro_torch.launch import serve, serve_decode
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention, init_decode_state
from test_torch_moe import (LOGIT_TOL, ULP2, assert_logits_match,
                            port_routing, record_jax_routing, routing_taint)

DECODE = ["glm4-9b", "qwen2.5-14b", "granite-20b", "deepseek-moe-16b",
          "qwen3-moe-235b-a22b"]
DECODE_IDS = ["glm4", "qwen2.5-qkv-bias", "granite-gelu-mqa",
              "deepseek-moe-shared", "qwen3-moe-qk-norm"]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


_models: dict = {}


def _pair(name):
    """(jax cfg, port cfg, jax params, port model) for a SMOKE config."""
    if name not in _models:
        jcfg, tcfg = jax_config(name, smoke=True), get_config(name, smoke=True)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _models[name] = (jcfg, tcfg, params, npz.params_from_numpy(
            tcfg, jnpz._flatten(params), device="cpu"))
    return _models[name]


def _attention_pair(dtype=torch.bfloat16):
    """SMOKE glm4-9b attention (GQA 8:2): JAX params, the port's module."""
    jcfg, tcfg = jax_config("glm4-9b", smoke=True), get_config(
        "glm4-9b", smoke=True)
    p = jattn.init_attention(jax.random.PRNGKey(0), jcfg)
    mod = attention.Attention(tcfg, device="meta", dtype=dtype)
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(
        np.array(v)).to(dtype) for k, v in jnpz._flatten(p).items()},
        assign=True, strict=True)
    return jcfg, tcfg, p, mod


# --------------------------------------------------------------------------
# attention_decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch,length,steps,window,offsets", [
    (2, 16, 16, 0, (0, 0)),          # a cache as long as the sequence
    (1, 8, 20, 8, (0,)),             # a ring buffer that wraps twice
    (3, 24, 12, 0, (0, 3, 7)),       # rows at different positions
    (2, 8, 12, 0, (0, 2)),           # past the cache: the last slot
], ids=["window0", "ring-wrap", "rows-at-own-pos", "past-the-cache"])
def test_attention_decode_matches_jax(batch, length, steps, window, offsets):
    jcfg, tcfg, p, mod = _attention_pair()
    rng = np.random.default_rng(length + steps)
    jc = jattn.init_kv_cache(jcfg, batch, length)
    tc = attention.init_kv_cache(tcfg, batch, length, device="cpu")
    for t in range(steps):
        x = rng.normal(size=(batch, 1, jcfg.d_model)).astype(np.float32)
        pos = (t + np.array(offsets)).astype(np.int32)
        yj, jc = jattn.attention_decode(
            p, jcfg, jnp.asarray(x).astype(jnp.bfloat16), jc,
            jnp.asarray(pos), window=window)
        yt, out = attention.attention_decode(
            mod, tcfg, torch.from_numpy(x).to(torch.bfloat16), tc,
            torch.from_numpy(pos), window=window)
        assert out is tc and yt.dtype == torch.bfloat16
        want = _f32(yj)
        np.testing.assert_allclose(_f32(yt), want, rtol=ULP2,
                                   atol=ULP2 * np.abs(want).max())
        for name in ("k", "v"):
            want = _f32(jc[name])
            got = _f32(tc[name])
            np.testing.assert_array_equal(got != 0, want != 0)
            np.testing.assert_allclose(got, want, rtol=ULP2,
                                       atol=ULP2 * np.abs(want).max())
    # every written slot, and only those: the JAX slot rule
    last = steps - 1 + np.array(offsets)
    for b in range(batch):
        if window:
            written = set(range(min(last[b] + 1, length)))
        else:
            written = set(range(offsets[b], min(last[b] + 1, length)))
        assert {int(i) for i in np.flatnonzero(
            _f32(tc["k"])[b].any(axis=(1, 2)))} == written


@pytest.mark.parametrize("window", [0, 8])
def test_decode_matches_own_prefill(window):
    """Token by token through the cache (under a window: a ring buffer of
    the window's length) gives the causal prefill's attention, float32,
    within 2e-3 (``tests/test_attention.py:63,82``)."""
    cfg = dataclasses.replace(get_config("glm4-9b", smoke=True),
                              attn_impl="xla_full")
    mod = attention.Attention(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu", dtype=torch.float32)
    b, s = 2, 24
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    pos = torch.arange(s).expand(b, s)
    want = attention.attention(mod, cfg, x, pos, window=window)
    cache = attention.init_kv_cache(cfg, b, window or s, torch.float32,
                                    device="cpu")
    got = torch.cat([attention.attention_decode(
        mod, cfg, x[:, t:t + 1], cache, torch.full((b,), t),
        window=window)[0] for t in range(s)], 1)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# decode_step against the jitted serve step
# --------------------------------------------------------------------------

def _taint(jcfg, jax_calls, port_calls, batch, positions):
    if jcfg.family != "moe":
        return np.zeros((batch, positions), bool)
    jax.effects_barrier()
    tainted, unexplained = routing_taint(jax_calls, port_calls, jcfg.top_k,
                                         jcfg.n_layers)
    assert not unexplained.any(), np.argwhere(unexplained)
    return tainted


@pytest.mark.parametrize("name", DECODE, ids=DECODE_IDS)
def test_decode_step_matches_jax_serve_step(name, monkeypatch):
    """An 8-token prompt prefilled into a 24-slot cache by the JAX package,
    carried across with ``decode_state_from_numpy``; then 16 teacher-forced
    steps on both sides from that state."""
    jcfg, tcfg, params, model = _pair(name)
    jax_calls = record_jax_routing(monkeypatch)
    tok = np.random.default_rng(16).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    _, jstate, s = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(tok[:, :8])}, 24)
    state = npz.decode_state_from_numpy(
        tcfg, jnpz._flatten(jstate), device="cpu")
    assert state["kv"]["k"].dtype == torch.bfloat16
    jax.effects_barrier()
    jax_calls.clear()
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    step = make_serve_step(tcfg)
    want, got = [], []
    with port_routing(model) as port_calls:
        for t in range(s, 24):
            jl, jstate = jstep(params, jstate, jnp.asarray(tok[:, t:t + 1]),
                               jnp.full((2,), t, jnp.int32))
            tl, out = step(model, state, tok[:, t:t + 1],
                           torch.full((2,), t))
            assert out is state and tl.shape == (2, 1, jcfg.vocab_size)
            want.append(_f32(jl))
            got.append(_f32(tl))
    tainted = _taint(jcfg, jax_calls, port_calls, 2, 24 - s)
    assert_logits_match(np.concatenate(got, 1), np.concatenate(want, 1),
                        tainted)
    # the caches: the same slots written; layer 0 (which no router choice
    # reaches) within two bf16 ulps
    back = npz.decode_state_to_numpy(state)
    for name_ in ("k", "v"):
        jkv = _f32(jstate["kv"][name_])
        np.testing.assert_array_equal(back[f"kv/{name_}"] != 0, jkv != 0)
        np.testing.assert_allclose(back[f"kv/{name_}"][0], jkv[0],
                                   rtol=ULP2, atol=ULP2 * np.abs(jkv).max())


@pytest.mark.parametrize("name", ["glm4-9b", "deepseek-moe-16b"])
def test_greedy_generation_matches_jax(name, monkeypatch):
    """``prefill_into_cache`` and greedy decode from the same prompts, 4 x
    16 tokens then 12 generated, against the JAX package's
    ``prefill_into_cache`` and the greedy loop of its ``generate``: each
    row's tokens equal up to its first near tie (of the JAX logits, or a
    differing router choice that reaches the token), and the last prompt
    position's logits within LOGIT_TOL where no such choice reaches
    them."""
    jcfg, tcfg, params, model = _pair(name)
    jax_calls = record_jax_routing(monkeypatch)
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

    seen: list = []
    with port_routing(model) as port_calls:
        logits, state, s = serve.prefill_into_cache(
            model, tcfg, {"tokens": prompts}, cache_len, prompt_logits=seen)
        got_tok = serve.greedy_decode(model, tcfg, state, logits, s,
                                      gen).numpy()
    assert s == 16 and len(seen) == 16 and seen[-1] is logits
    assert got_tok.shape == (4, gen)
    tainted = unexplained = np.zeros((4, s + gen - 1), bool)
    if jcfg.family == "moe":
        jax.effects_barrier()
        tainted, unexplained = routing_taint(jax_calls, port_calls,
                                             jcfg.top_k, jcfg.n_layers)
    want_logits = np.stack(want_logits, 1)                  # (4, gen, V)
    srt = -np.sort(-want_logits, axis=-1)
    # the token of step i comes from the logits at position s - 1 + i
    tie = (srt[..., 0] - srt[..., 1] <= LOGIT_TOL) | tainted[:, s - 1:]
    for r in range(4):
        differ = np.flatnonzero(got_tok[r] != want_tok[r])
        first = int(differ[0]) if len(differ) else gen
        # both sides were fed the same tokens up to position s - 1 + first
        assert not unexplained[r, :s + first].any(), r
        assert first == gen or tie[r, first], (r, first)
    held = ~tainted[:, s - 1]
    assert held.any()
    np.testing.assert_allclose(_f32(logits)[held, -1], want_logits[held, 0],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert (got_tok[:, :2] == want_tok[:, :2]).any()


def test_prefill_into_cache_matches_the_prefill_step():
    """The port's decode path over a prompt, position by position, against
    its own prefill step over the whole prompt: within LOGIT_TOL, argmax
    differing only at near ties (the check the card makes at full
    width)."""
    _, tcfg, _, model = _pair("glm4-9b")
    prompts = np.random.default_rng(5).integers(0, 512, size=(2, 32))
    seen: list = []
    serve.prefill_into_cache(model, tcfg, {"tokens": prompts}, 32,
                             prompt_logits=seen)
    want = _f32(make_prefill_step(tcfg)(model, {"tokens": prompts}))
    assert_logits_match(_f32(torch.cat(seen, 1)), want,
                        np.zeros((2, 32), bool))


# --------------------------------------------------------------------------
# the decode state
# --------------------------------------------------------------------------

def test_decode_state_crosses_from_jax_and_back():
    jcfg, tcfg, params, _ = _pair("glm4-9b")
    tok = np.random.default_rng(6).integers(0, 512, (2, 5)).astype(np.int32)
    _, jstate, _ = jserve.prefill_into_cache(
        params, jcfg, {"tokens": jnp.asarray(tok)}, 8)
    flat = jnpz._flatten(jstate)
    assert set(flat) == {"kv/k", "kv/v"}
    state = npz.decode_state_from_numpy(tcfg, flat, device="cpu")
    back = npz.decode_state_to_numpy(state)
    for key in flat:
        assert state["kv"][key[-1]].dtype == torch.bfloat16
        np.testing.assert_array_equal(back[key], _f32(flat[key]))
    f32 = npz.decode_state_from_numpy(
        tcfg, {k: _f32(v) for k, v in flat.items()}, device="cpu")
    assert f32["kv"]["k"].dtype == torch.float32
    with pytest.raises(KeyError, match="decode state keys"):
        npz.decode_state_from_numpy(tcfg, {"kv/k": flat["kv/k"]},
                                    device="cpu")
    with pytest.raises(ValueError, match="shape"):
        npz.decode_state_from_numpy(
            tcfg, {"kv/k": flat["kv/k"][:1], "kv/v": flat["kv/v"][:1]},
            device="cpu")


@pytest.mark.parametrize("name", ["glm4-9b", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b"])
def test_full_width_decode_state_shapes(name):
    """At the dry-run's decode_32k shape (128 x 32768), on the meta device:
    the JAX ``init_decode_state``'s pytree, shapes and dtype."""
    want = jax.eval_shape(functools.partial(
        jmodel.init_decode_state, jax_config(name), 128, 32_768))
    got = init_decode_state(get_config(name), 128, 32_768, device="meta")
    assert set(got) == set(want) == {"kv"}
    for key in ("k", "v"):
        assert tuple(got["kv"][key].shape) == want["kv"][key].shape
        assert got["kv"][key].dtype == torch.bfloat16
        assert want["kv"][key].dtype == jnp.bfloat16


def test_decode_step_updates_the_state_in_place():
    _, tcfg, _, model = _pair("glm4-9b")
    state = init_decode_state(tcfg, 2, 6, device="cpu")
    ptrs = [t.data_ptr() for t in state["kv"].values()]
    logits, out = model.decode_step(state, [[3], [4]], [2, 5])
    assert out is state and logits.shape == (2, 1, 512)
    assert [t.data_ptr() for t in state["kv"].values()] == ptrs
    written = state["kv"]["k"].abs().sum(dim=(3, 4)) != 0   # (L, B, slots)
    assert written[:, 0].nonzero()[:, 1].unique().tolist() == [2]
    assert written[:, 1].nonzero()[:, 1].unique().tolist() == [5]


@pytest.mark.parametrize("name", ["internvl2-1b", "whisper-tiny"])
def test_other_families_have_no_decode_state(name):
    """The other families, vlm and audio, have the JAX package's decode
    state: the dense KV caches, and in the audio family the cross K/V of
    the encoded frames, at full width (the dry-run's decode_32k: 128 x
    32768) on the meta device, shapes and dtypes.  The name dates from
    before these families were ported, when they had no decode state; it
    is kept so that the test's record runs on."""
    want = jax.eval_shape(functools.partial(
        jmodel.init_decode_state, jax_config(name), 128, 32_768))
    got = init_decode_state(get_config(name), 128, 32_768, device="meta")
    want = {"/".join(jnpz._key_str(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = npz.flat_state(got)
    assert set(got) == set(want)
    assert set(got) >= {"kv/k", "kv/v"}
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape
        assert t.dtype == torch.bfloat16 and want[key].dtype == jnp.bfloat16


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

def test_generate_on_the_cpu():
    run = serve.generate("glm4-9b", smoke=True, batch=2, prompt_len=8,
                         gen=4, device="cpu")
    assert run.tokens.shape == (2, 4) and run.prompts.shape == (2, 8)
    assert run.last_logits.shape == (2, 1, 512)
    assert len(run.step_seconds) == 3 and run.tokens_per_s > 0
    assert torch.equal(run.tokens[:, 0], run.last_logits[:, -1].argmax(-1))
    again = serve.generate("glm4-9b", smoke=True, batch=2, prompt_len=8,
                           gen=4, device="cpu")
    assert torch.equal(again.tokens, run.tokens)
    assert torch.equal(again.prompts, run.prompts)


def test_serve_main_and_the_serve_decode_demo(capsys):
    run = serve.main(["--arch", "deepseek-moe-16b", "--smoke", "--batch",
                      "2", "--prompt-len", "4", "--gen", "3", "--device",
                      "cpu"])
    assert run.tokens.shape == (2, 3)
    out = serve_decode.main(["--device", "cpu"])
    assert set(out) == {"glm4-9b", "deepseek-moe-16b", "zamba2-2.7b"}
    assert all(t.shape == (4, 8) for t in out.values())
    text = capsys.readouterr().out
    assert "sample tokens" in text and "zamba2-2.7b" in text
    assert "not ported" not in text


def test_generate_refuses_what_is_not_ported():
    """Every family is served: whisper-tiny (its frames drawn after the
    prompts from the seed) and internvl2-1b (no patches, as the JAX
    package serves it) at SMOKE on the CPU, the same tokens from the same
    seed; without a GPU the default device raises.  The name dates from
    before these families were ported, when ``generate`` refused them;
    it is kept so that the test's record runs on."""
    for name in ("whisper-tiny", "internvl2-1b"):
        run = serve.generate(name, batch=2, prompt_len=8, gen=4,
                             device="cpu")
        assert run.tokens.shape == (2, 4)
        assert set(run.batch) == ({"tokens", "frames"}
                                  if name == "whisper-tiny" else {"tokens"})
        again = serve.generate(name, batch=2, prompt_len=8, gen=4,
                               device="cpu")
        assert torch.equal(again.tokens, run.tokens)
    if not torch.cuda.is_available():
        for name in ("glm4-9b", "whisper-tiny", "internvl2-1b"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                serve.generate(name)
