"""Parity of the port's dense LM prefill with the JAX package's, on the CPU.

The JAX package's parameters (``init_params`` from a PRNG key) enter the
port through ``params_from_numpy`` (bf16 storage, exact: both round the
float32 weights to nearest even), and the same numpy tokens go through
both prefill steps.  Tolerances, with their reasons:

* The activations are bit-equal: elementwise, the port writes out the
  JAX package's bf16 operations one by one.  RoPE too, but for its
  float32 ``cos``/``sin``, which may round one float32 ulp apart and
  move a bf16 rounding: held to two bf16 ulps.
* A reduction sums its float32 terms in another order in torch than in
  XLA:CPU, so its bf16 result may round one ulp apart: a bf16 matrix
  product in about 1e-4 of its outputs, RMSNorm's mean of squares more
  rarely.  A layer with a reduction is held to two bf16 ulps
  (``rtol=2**-6``: one ulp is at most 2^-7 of the value).
* The prefill logits are held to 3e-2 abs and rel, the JAX package's own
  bf16 attention tolerance: the one-ulp differences above change the
  rounding of later products, and XLA's jit keeps some bf16 intermediates
  in float32 (excess precision), so most logits differ in the last bit or
  two (about 1e-2 at logits of 1.5).  Where the argmax of a position
  differs, the two tokens must be a near tie: within the same tolerance
  in the JAX logits.

The SMOKE configs of glm4-9b, qwen2.5-14b (qkv bias) and granite-20b
(gelu, MQA) and glm4-9b's head geometry at narrow width (16 query heads,
1 KV head, head dim 128) run with ``attn_impl`` ``pallas`` (through
``ops.flash_attention``) and ``xla_chunked`` (the naive path at these
lengths, on both sides).  No test builds a full-width model: the
full-width parameter shapes are checked on the meta device against
``jax.eval_shape``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import npz as jnpz
from repro.configs import get_config as jax_config, ARCH_NAMES
from repro.launch import steps as jsteps
from repro.models import layers as jlayers, model as jmodel
from repro_torch.checkpoint import npz
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import layers, init_params

LOGIT_TOL = 3e-2
ULP2 = 2.0 ** -6          # two bf16 ulps: one is at most 2^-7 of the value

PREFILL_CASES = [("glm4-9b", {}), ("qwen2.5-14b", {}), ("granite-20b", {}),
                 ("glm4-9b", dict(n_heads=16, n_kv_heads=1, head_dim=128))]
PREFILL_IDS = ["glm4", "qwen2.5-qkv-bias", "granite-gelu-mqa",
               "glm4-heads-narrow"]
DENSE = ["glm4-9b", "qwen2.5-14b", "granite-20b", "granite-34b"]


def _configs(name, over):
    return (dataclasses.replace(jax_config(name, smoke=True), **over),
            dataclasses.replace(get_config(name, smoke=True), **over))


_models: dict = {}


def _pair(name, over):
    """(jax cfg, port cfg, jax params, port model) for a SMOKE variant."""
    key = (name, tuple(sorted(over.items())))
    if key not in _models:
        jcfg, tcfg = _configs(name, over)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        model = npz.params_from_numpy(tcfg, jnpz._flatten(params),
                                      device="cpu")
        _models[key] = (jcfg, tcfg, params, model)
    return _models[key]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(rng, shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rmsnorm_within_two_ulps():
    rng = np.random.default_rng(0)
    xj, xt = _bf16(rng, (2, 64, 256), 3.0)
    scale = rng.normal(size=256).astype(np.float32)
    norm = layers.RMSNorm(256, device="cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    want = _f32(jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xj))
    np.testing.assert_allclose(_f32(norm(xt)), want, rtol=ULP2, atol=0)
    assert norm.scale.dtype == torch.float32


@pytest.mark.parametrize("head_dim", [32, 80, 128])
def test_rope_rotates_halves_within_two_ulps_in_bf16(head_dim):
    rng = np.random.default_rng(head_dim)
    xj, xt = _bf16(rng, (2, 96, 4, head_dim))
    pos = np.broadcast_to(np.arange(96)[None], (2, 96)).astype(np.int32)
    want = jlayers.apply_rope(xj, jnp.asarray(pos), 1e4)
    got = layers.apply_rope(xt, torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=ULP2, atol=0)
    np.testing.assert_allclose(_f32(layers.rope_freqs(head_dim, 1e6)),
                               _f32(jlayers.rope_freqs(head_dim, 1e6)),
                               rtol=1e-6, atol=0)


def test_rope_float32_within_rounding():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 64, 2, 64)).astype(np.float32)
    pos = np.arange(64)[None].astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn,jfn", [(layers.silu, jax.nn.silu),
                                    (layers.gelu_tanh, jax.nn.gelu)],
                         ids=["silu", "gelu_tanh"])
def test_activations_bit_equal_in_bf16(fn, jfn):
    rng = np.random.default_rng(2)
    xj, xt = _bf16(rng, (4, 128, 512), 2.0)
    np.testing.assert_array_equal(_f32(fn(xt)), _f32(jfn(xj)))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_within_two_ulps(mlp_type):
    rng = np.random.default_rng(3)
    params = jlayers.init_mlp(jax.random.PRNGKey(3), 256, 512, mlp_type)
    mlp = layers.MLP(256, 512, mlp_type, device="meta",
                     dtype=torch.bfloat16)
    mlp.load_state_dict({k: torch.from_numpy(np.array(v)).to(
        torch.bfloat16) for k, v in params.items()}, assign=True)
    xj, xt = _bf16(rng, (2, 64, 256))
    want = _f32(jlayers.mlp(params, xj, mlp_type))
    np.testing.assert_allclose(_f32(mlp(xt)), want, rtol=ULP2,
                               atol=ULP2 * np.abs(want).max())


def test_linear_with_bias_within_two_ulps():
    rng = np.random.default_rng(4)
    p = jlayers.init_linear(jax.random.PRNGKey(4), 256, 96, bias=True)
    p["b"] = jnp.asarray(rng.normal(size=96).astype(np.float32))
    lin = layers.Linear(256, 96, bias=True, device="meta",
                        dtype=torch.bfloat16)
    lin.load_state_dict({k: torch.from_numpy(np.array(v)).to(
        torch.bfloat16) for k, v in p.items()}, assign=True)
    assert tuple(lin.w.shape) == (256, 96)     # the JAX (d_in, d_out)
    xj, xt = _bf16(rng, (2, 32, 256))
    want = _f32(jlayers.linear(p, xj))
    np.testing.assert_allclose(_f32(lin(xt)), want, rtol=ULP2,
                               atol=ULP2 * np.abs(want).max())


def test_embed_and_tied_unembed():
    rng = np.random.default_rng(5)
    p = jlayers.init_embedding(jax.random.PRNGKey(5), 512, 256)
    emb = layers.Embedding(512, 256, device="meta", dtype=torch.bfloat16)
    emb.load_state_dict({"table": torch.from_numpy(np.array(
        p["table"])).to(torch.bfloat16)}, assign=True)
    tok = rng.integers(0, 512, size=(2, 40)).astype(np.int32)
    x = emb(torch.from_numpy(tok))
    np.testing.assert_array_equal(_f32(x), _f32(jlayers.embed(
        p, jnp.asarray(tok))))
    want = _f32(jlayers.unembed(p, jnp.asarray(_f32(x)).astype(
        jnp.bfloat16)))
    np.testing.assert_allclose(_f32(emb.unembed(x)), want, rtol=ULP2,
                               atol=ULP2 * np.abs(want).max())


# --------------------------------------------------------------------------
# the prefill step
# --------------------------------------------------------------------------

def _assert_logits_match(got, want):
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    differ = a_got != a_want
    gap = (np.take_along_axis(want, a_want[..., None], -1)
           - np.take_along_axis(want, a_got[..., None], -1))[..., 0]
    assert (gap[differ] <= LOGIT_TOL).all(), gap[differ]
    assert differ.mean() <= 0.05, differ.mean()


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("attn_impl", ["pallas", "xla_chunked"])
@pytest.mark.parametrize("name,over", PREFILL_CASES, ids=PREFILL_IDS)
def test_prefill_matches_jax(name, over, attn_impl, seq, monkeypatch):
    jcfg, tcfg, params, model = _pair(name, over)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    tok = np.random.default_rng(seq).integers(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)}))

    calls = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    logits = make_prefill_step(tcfg)(model, {"tokens": tok})
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (2, seq, jcfg.vocab_size)
    # pallas goes through ops.flash_attention (on the CPU: its plain
    # version), xla_chunked at these lengths through the naive path
    assert len(calls) == (tcfg.n_layers if attn_impl == "pallas" else 0)
    _assert_logits_match(_f32(logits), want)


def test_xla_chunked_goes_blockwise_above_512_squared(monkeypatch):
    """Past 512 x 512 query-key pairs the default path is the blockwise
    one, as in the JAX package (there ``_flash_xla``)."""
    jcfg, tcfg, params, model = _pair("glm4-9b", {})
    tok = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, size=(1, 640)).astype(np.int32)
    want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)}))
    calls = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    logits = make_prefill_step(tcfg)(model, {"tokens": tok})
    assert len(calls) == tcfg.n_layers
    _assert_logits_match(_f32(logits), want)


def test_xla_chunked_prefill_at_a_ragged_length(monkeypatch):
    """1000 tokens, not a multiple of 128: the JAX package's
    ``_flash_xla`` takes it, and so does the port's blockwise path (on the
    card by padding, ``ops.pad_ragged``; here its plain version)."""
    jcfg, tcfg, params, model = _pair("glm4-9b", {})
    tok = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, size=(1, 1000)).astype(np.int32)
    want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)}))
    calls = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    logits = make_prefill_step(tcfg)(model, {"tokens": tok})
    assert tuple(logits.shape) == (1, 1000, jcfg.vocab_size)
    assert len(calls) == tcfg.n_layers
    _assert_logits_match(_f32(logits), want)


@pytest.mark.parametrize("seq,window", [(1000, 0), (1000, 200), (130, 0),
                                        (130, 64), (256, 0)])
def test_pad_ragged_is_exact(seq, window):
    """Padding q, k and v at the tail to a multiple of 128 and slicing the
    output back is exact under a causal mask: with ``ref.attention_ref``
    as the inner function it matches the unpadded call within 1e-6 in
    float32."""
    gen = torch.Generator().manual_seed(seq + window)
    q = torch.randn((1, 4, seq, 32), generator=gen)
    k, v = (torch.randn((1, 2, seq, 32), generator=gen) for _ in range(2))
    lengths = []

    def inner(*a, **kw):
        lengths.append(a[0].shape[2])
        return ref.attention_ref(*a, **kw)
    got = ops.pad_ragged(inner, q, k, v, causal=True, window=window)
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    assert lengths == [-(-seq // 128) * 128]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_pad_ragged_refuses_no_mask_and_unequal_lengths():
    """No mask over a ragged length is taken: the padded keys are bounded
    by ``kv_len`` (``inner`` sees it, and the result is the unpadded
    call's, within float32 rounding of sums of another length).  A causal
    mask over unequal lengths is refused before any
    padding, where padding would make the lengths equal.  The name dates
    from before the key-length bound, when no mask over a ragged length
    was refused too; it is kept so that the test's record runs on."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 2, 1000, 32), generator=gen)
    seen = []

    def inner(*a, **kw):
        seen.append(kw["kv_len"])
        return ref.attention_ref(*a, **kw)
    torch.testing.assert_close(
        ops.pad_ragged(inner, q, q, q, causal=False, window=0),
        ref.attention_ref(q, q, q, causal=False), rtol=1e-5, atol=1e-5)
    assert seen == [1000]
    with pytest.raises(ValueError, match="as many queries as keys"):
        ops.pad_ragged(ref.attention_ref, q[:, :, :900], q, q, causal=True,
                       window=0)
    # multiples of 128 go through as they are, with or without a mask
    q = torch.randn((1, 2, 256, 32), generator=torch.Generator().manual_seed(0))
    for causal in (False, True):
        assert torch.equal(ops.pad_ragged(ref.attention_ref, q, q, q,
                                          causal=causal, window=0),
                           ref.attention_ref(q, q, q, causal=causal))


def test_prefill_refuses_a_config_of_other_parameters():
    _, tcfg, _, model = _pair("glm4-9b", {})
    other = dataclasses.replace(tcfg, d_ff=256)
    tok = np.zeros((1, 128), np.int32)
    with pytest.raises(ValueError, match="does not describe"):
        make_prefill_step(other)(model, {"tokens": tok})
    # execution knobs alone may differ
    make_prefill_step(dataclasses.replace(
        tcfg, attn_impl="xla_full", scan_layers=False, remat=False))(
        model, {"tokens": tok})


# --------------------------------------------------------------------------
# parameters and checkpoints
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
        key, layer = npz.flat_key(name)
        out.setdefault(key, []).append((layer, tuple(p.shape)))
    return {k: ((len(v),) + v[0][1]) if v[0][0] is not None else v[0][1]
            for k, v in out.items()}


@pytest.mark.parametrize("name", DENSE)
def test_full_width_parameter_names_and_shapes(name):
    """At full width, on the meta device (nothing allocated): the same
    flat paths and shapes as the JAX ``init_params``."""
    model = init_params(get_config(name), device="meta")
    assert _port_flat_shapes(model) == _jax_flat_shapes(jax_config(name))
    if name == "glm4-9b":
        n = sum(p.numel() for p in model.parameters())
        assert n == 8_779_010_048
        assert model.layers[0].attn.wq.w.dtype == torch.bfloat16
        assert model.layers[0].ln1.scale.dtype == torch.float32


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_are_copies(name):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(name, smoke)) == \
            dataclasses.asdict(jax_config(name, smoke))


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if jax_config(n).family in ("vlm",
                                                              "audio")])
def test_other_families_raise_not_implemented(name):
    """The other families, vlm and audio (a stub frontend before the
    decoder), build as the JAX package's ``init_params`` does, at full
    width and SMOKE, on the meta device: no family is refused.  The name
    dates from before these families were ported, when they raised
    ``NotImplementedError``; it is kept so that the test's record runs
    on."""
    for smoke in (False, True):
        model = init_params(get_config(name, smoke=smoke), device="meta")
        assert _port_flat_shapes(model) == _jax_flat_shapes(
            jax_config(name, smoke=smoke))


def test_init_params_draws_the_jax_distributions():
    cfg = get_config("glm4-9b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    model = init_params(cfg, generator=gen, device="cpu",
                        dtype=torch.float32)
    blk = model.layers[0]
    for w, fan_in in ((blk.attn.wq.w, 256), (blk.mlp.wo, 512)):
        assert abs(float(w.std()) - fan_in ** -0.5) < 0.05 * fan_in ** -0.5
    assert abs(float(model.embed.table.std()) - 0.02) < 0.002
    assert torch.equal(blk.ln1.scale, torch.ones(256))
    bias = init_params(get_config("qwen2.5-14b", smoke=True),
                       generator=gen, device="cpu").layers[0].attn.wq.b
    assert not bool(bias.any())
    with pytest.raises(ValueError, match="Generator"):
        init_params(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg, generator=gen)


def test_params_from_numpy_is_the_jax_params_rounded():
    jcfg, tcfg, params, model = _pair("qwen2.5-14b", {})
    flat = jnpz._flatten(params)
    back = npz.to_numpy(model)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        want = np.asarray(jnp.asarray(arr).astype(jnp.bfloat16).astype(
            jnp.float32)) if not key.endswith("scale") else arr
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    f32 = npz.params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    for key, arr in npz.to_numpy(f32).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)


def test_params_from_numpy_refuses_missing_extra_or_misshapen():
    _, tcfg, params, _ = _pair("glm4-9b", {})
    flat = dict(jnpz._flatten(params))
    with pytest.raises(KeyError, match="missing"):
        npz.params_from_numpy(tcfg, {k: v for k, v in flat.items()
                                     if k != "ln_f/scale"}, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        npz.params_from_numpy(tcfg, {**flat, "extra/w": flat["ln_f/scale"]},
                              device="cpu")
    bad = dict(flat)
    bad["layers/mlp/wi"] = bad["layers/mlp/wi"][:1]
    with pytest.raises(ValueError, match="shape"):
        npz.params_from_numpy(tcfg, bad, device="cpu")


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jcfg, tcfg, params, model = _pair("granite-20b", {})
    path = jnpz.save_checkpoint(str(tmp_path), 3, params)
    loaded = npz.load_checkpoint(path, tcfg, device="cpu")
    for (n1, p1), (n2, p2) in zip(loaded.named_parameters(),
                                  model.named_parameters()):
        assert n1 == n2 and p1.dtype == p2.dtype and torch.equal(p1, p2), n1
    # bf16 trees are stored as raw 2-byte voids and come back bit for bit
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    path = jnpz.save_checkpoint(str(tmp_path / "bf16"), 1, bf)
    with np.load(path) as data:
        assert data["embed/table"].dtype.kind == "V"
    loaded = npz.load_checkpoint(path, tcfg, device="cpu")
    for name, p in loaded.named_parameters():
        key, layer = npz.flat_key(name)
        arr = np.asarray(jnpz._flatten(bf)[key].astype(np.float32))
        want = arr if layer is None else arr[layer]
        np.testing.assert_array_equal(_f32(p), want, err_msg=name)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jcfg, tcfg, _, _ = _pair("qwen2.5-14b", {})
    model = init_params(tcfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    path = npz.save_checkpoint(str(tmp_path), 7, model)
    assert jnpz.latest_step(str(tmp_path)) == 7
    target = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    restored = jnpz._flatten(jnpz.restore_checkpoint(path, target))
    for key, arr in npz.to_numpy(model).items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)
    # and back into the port: the same model, the same logits
    again = npz.load_checkpoint(path, tcfg, device="cpu")
    tok = np.random.default_rng(0).integers(0, 512, (1, 128))
    step = make_prefill_step(tcfg)
    assert torch.equal(step(again, {"tokens": tok}),
                       step(model, {"tokens": tok}))
