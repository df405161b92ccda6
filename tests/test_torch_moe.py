"""Parity of the port's MoE layer and moe family with the JAX package's, on
the CPU.

The JAX package's parameters enter the port as numpy (router float32,
experts in the storage dtype), and the same numpy inputs go through both
``moe_layer``s.  Tolerances, with their reasons:

* With nothing dropped (``capacity_factor=8.0``, the pins of
  ``tests/test_moe.py``), bf16 outputs within two bf16 ulps (the expert
  products are bf16 matrix products, whose float32 sums may be ordered
  otherwise) and float32 outputs within 1e-5; the aux loss within rtol
  1e-6.
* Dropped assignments: the port writes nothing for them, where the JAX
  package scatters zeros into slot 0 of their expert (``moe.py:86-90``)
  and so zeroes the token kept there.  The port equals the JAX package on
  every other token, and a plain numpy Switch dispatch on every token.
* A whole moe model: the router picks its top k, a discontinuous choice.
  Two implementations whose bf16 activations lie an ulp or two apart pick
  other experts where two probabilities nearly tie, and from there the
  outputs part by far more than rounding.  So both routers are recorded
  (the JAX one through ``jax.debug.callback`` from inside the jitted
  step) and compared: a choice that differs must be a near tie in the
  JAX router's own probabilities (within :data:`ROUTER_TIE`) unless an
  earlier differing choice reaches it, and logits are held to the JAX
  package's only where no differing choice reaches them (a choice at an
  earlier layer reaches a later position through attention; one at the
  last layer reaches its own position only).
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import npz as jnpz
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.models import model as jmodel, moe as jmoe
from repro_torch.checkpoint import npz
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import init_params, moe

LOGIT_TOL = 3e-2
ULP2 = 2.0 ** -6          # two bf16 ulps: one is at most 2^-7 of the value
# two router probabilities this close are a near tie: about two bf16
# rounding steps of a probability of one (the router's input is bf16)
ROUTER_TIE = 2.0 ** -6
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _cfgs(name="deepseek-moe-16b", **over):
    return (dataclasses.replace(jax_config(name, smoke=True), **over),
            dataclasses.replace(get_config(name, smoke=True), **over))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _port_moe(tcfg, p, dtype) -> moe.MoE:
    """The port's MoE module holding the JAX params ``p``."""
    m = moe.MoE(tcfg, device="meta", dtype=dtype)
    m.load_state_dict({
        key.replace("/", "."): torch.from_numpy(np.array(arr)).to(
            torch.float32 if key.startswith("router") else dtype)
        for key, arr in jnpz._flatten(p).items()}, assign=True, strict=True)
    return m


def _layer_case(jcfg, tcfg, dtype, *, b=2, s=32, seed=1):
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(seed).normal(
        size=(b, s, jcfg.d_model)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return p, _port_moe(tcfg, p, dtype), jnp.asarray(x).astype(jdt), \
        torch.from_numpy(x).to(dtype)


# --------------------------------------------------------------------------
# router records: which experts each side chose
# --------------------------------------------------------------------------

def record_jax_routing(monkeypatch) -> list:
    """Patch ``repro.models.moe.moe_layer``, as the JAX model reaches it,
    to report each call's router probabilities (B, S, E), in call order,
    through an ordered ``jax.debug.callback``: also from inside a jitted
    step.  The probabilities are the layer's own expression."""
    sink: list = []
    real = jmoe.moe_layer

    def moe_layer(p, cfg, x):
        b, s, d = x.shape
        g = moe.groups(cfg, b * s)
        xt = x.reshape(g, b * s // g, d)
        probs = jax.nn.softmax(
            (xt.astype(jnp.float32) @ p["router"]["w"]).astype(jnp.float32),
            axis=-1)
        jax.debug.callback(
            lambda pr: sink.append(np.asarray(pr).reshape(b, s, -1)), probs,
            ordered=True)
        return real(p, cfg, x)
    monkeypatch.setattr(jmoe, "moe_layer", moe_layer)
    return sink


@contextlib.contextmanager
def port_routing(model):
    """Forward hooks on the port's MoE modules, for the ``with`` block:
    yields a list of each call's router probabilities (B, S, E), in call
    order (none for a dense model)."""
    sink: list = []

    def hook(mod, args, _):
        cfg, x = args
        b, s, d = x.shape
        g = moe.groups(cfg, b * s)
        probs, _, _ = moe.route(mod, cfg, x.reshape(g, b * s // g, d))
        sink.append(probs.reshape(b, s, -1).float().numpy())
    handles = [block.moe.register_forward_hook(hook)
               for block in model.layers if block.moe is not None]
    try:
        yield sink
    finally:
        for h in handles:
            h.remove()


def _top_k(probs, k):
    """``jax.lax.top_k``'s experts: descending, ties to the lower id."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :k]


def routing_taint(jax_calls, port_calls, k, n_layers):
    """Compare the recorded choices of a run of ``n_layers`` calls a step
    (prefill: one step; decode: one a token), position by position.

    Returns (tainted, unexplained), both (B, P) bool: the positions whose
    logits a differing choice reaches, and those with a differing choice
    that no earlier one reaches and that is no near tie of the JAX
    router."""
    j = np.stack([np.concatenate(jax_calls[l::n_layers], 1)
                  for l in range(n_layers)])          # (L, B, P, E)
    t = np.stack([np.concatenate(port_calls[l::n_layers], 1)
                  for l in range(n_layers)])
    flip = (_top_k(j, k) != _top_k(t, k)).any(-1)     # (L, B, P)
    srt = -np.sort(-j, axis=-1)
    near = (srt[..., :k] - srt[..., 1:k + 1]).min(-1) < ROUTER_TIE
    L, B, P = flip.shape
    tainted = np.zeros((B, P), bool)
    unexplained = np.zeros((B, P), bool)
    for b in range(B):
        reach = np.zeros(L + 1, bool)     # from an earlier position's flip
        for p in range(P):
            here = np.zeros(L, bool)
            for l in range(L):
                # reached: an earlier position's flip below layer l, or
                # this position's below it (the residual stream)
                if flip[l, b, p] and not (reach[l] or here[:l].any()
                                          or near[l, b, p]):
                    unexplained[b, p] = True
                here[l] = flip[l, b, p]
            tainted[b, p] = reach[L - 1] or here.any()
            # a flip at layer l reaches later positions from layer l+1 on
            for l in np.flatnonzero(here):
                reach[l + 1:] = True
    return tainted, unexplained


def assert_logits_match(got, want, tainted, *, min_share=0.25):
    """Logits within LOGIT_TOL where no differing router choice reaches
    them, at least ``min_share`` of all; there the argmax may differ only
    at near ties."""
    assert (~tainted).mean() >= min_share, (~tainted).mean()
    got, want = got[~tainted], want[~tainted]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    differ = a_got != a_want
    gap = (np.take_along_axis(want, a_want[..., None], -1)
           - np.take_along_axis(want, a_got[..., None], -1))[..., 0]
    assert (gap[differ] <= LOGIT_TOL).all(), gap[differ]
    assert differ.mean() <= 0.05, differ.mean()


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_layer_matches_jax(dispatch, groups, dtype):
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, moe_groups=groups,
                       capacity_factor=8.0)
    p, m, xj, xt = _layer_case(jcfg, tcfg, dtype)
    yj, aj = jmoe.moe_layer(p, jcfg, xj)
    yt, at = moe.moe_layer(m, tcfg, xt)
    assert yt.dtype == dtype and yt.shape == xt.shape
    assert at.dtype == torch.float32 and at.shape == ()
    want = _f32(yj)
    tol = ULP2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(_f32(yt), want, rtol=tol,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


@pytest.mark.parametrize("name", MOE)
def test_sort_equals_onehot_and_groups_agree(name):
    """The pins of tests/test_moe.py on the port: with room for every
    assignment, ``sort`` gives ``onehot``'s positions and so the same
    output bit for bit; 4 groups give 1 group's within 1e-4."""
    out = {}
    for dispatch, g in (("onehot", 1), ("sort", 1), ("onehot", 4)):
        jcfg, tcfg = _cfgs(name, moe_dispatch=dispatch, moe_groups=g,
                           capacity_factor=8.0)
        _, m, _, xt = _layer_case(jcfg, tcfg, torch.float32)
        out[dispatch, g] = moe.moe_layer(m, tcfg, xt)
    assert torch.equal(out["onehot", 1][0], out["sort", 1][0])
    assert torch.equal(out["onehot", 1][1], out["sort", 1][1])
    torch.testing.assert_close(out["onehot", 4][0], out["onehot", 1][0],
                               rtol=1e-4, atol=1e-5)
    # positions: the order of the assignments within each expert
    gen = torch.Generator().manual_seed(0)
    flat_e = torch.randint(0, 5, (3, 200), generator=gen)
    cfg = dataclasses.replace(get_config(name, smoke=True), n_experts=5)
    onehot = moe.positions(dataclasses.replace(cfg, moe_dispatch="onehot"),
                           flat_e)
    assert torch.equal(moe.positions(dataclasses.replace(
        cfg, moe_dispatch="sort"), flat_e), onehot)
    for g in range(3):
        for e in range(5):
            assert onehot[g][flat_e[g] == e].tolist() == list(
                range(int((flat_e[g] == e).sum())))


@pytest.mark.parametrize("name,tg,cf", [
    ("deepseek-moe-16b", 8192, 1.25), ("deepseek-moe-16b", 4, 1.25),
    ("deepseek-moe-16b", 256, 1.25), ("deepseek-moe-16b", 100, 0.3),
    ("qwen3-moe-235b-a22b", 8192, 1.25), ("qwen3-moe-235b-a22b", 3, 8.0)])
def test_capacity_is_the_reference_expression(name, tg, cf):
    cfg = dataclasses.replace(get_config(name), capacity_factor=cf)
    e, k = cfg.n_experts, cfg.top_k
    assert moe.capacity(cfg, tg) == jmoe._round_up(
        max(1, int(tg * k / e * cf)), 8)
    if (name, tg) == ("deepseek-moe-16b", 8192):
        assert moe.capacity(cfg, tg) == 960       # the moe_prefill cell
    # groups: moe_groups where it divides the tokens, else 1
    assert moe.groups(dataclasses.replace(cfg, moe_groups=4), 32) == 4
    assert moe.groups(dataclasses.replace(cfg, moe_groups=3), 32) == 1
    assert moe.groups(dataclasses.replace(cfg, moe_groups=4), 2) == 1


def test_top_k_breaks_ties_toward_the_lower_expert():
    """Equal probabilities go to the lower expert id first, as in
    ``jax.lax.top_k``: a router whose columns repeat ties exactly."""
    jcfg, tcfg = _cfgs(n_experts=6, top_k=3)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    w = np.array(p["router"]["w"])
    w[:, 4] = w[:, 1]
    w[:, 5] = w[:, 2]
    w[:, 3] = 0.0
    p["router"]["w"] = jnp.asarray(w)
    m = _port_moe(tcfg, p, torch.float32)
    x = np.random.default_rng(2).normal(size=(1, 64, jcfg.d_model)).astype(
        np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"]["w"], axis=-1)
    _, want = jax.lax.top_k(probs, 3)
    _, _, got = moe.route(m, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and a router of zeros: every expert ties, the first k win
    m.router.w.zero_()
    _, topw, tope = moe.route(m, tcfg, torch.from_numpy(x))
    assert (tope == torch.arange(3)).all()
    torch.testing.assert_close(topw, torch.full_like(topw, 1 / 3))


def _routing_numpy(p, cfg, x):
    """The router and positions of a one-group Switch dispatch: (tope,
    topw float64, pos, kept, cap) for x (T, D)."""
    t, k, e = x.shape[0], cfg.top_k, cfg.n_experts
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x, jnp.float32) @ p["router"]["w"], axis=-1))
    tope = _top_k(probs, k)
    topw = np.take_along_axis(probs, tope, -1).astype(np.float64)
    topw /= topw.sum(-1, keepdims=True)
    cap = jmoe._round_up(max(1, int(t * k / e * cfg.capacity_factor)), 8)
    pos = np.zeros((t, k), int)
    seen = np.zeros(e, int)
    for i in range(t):
        for j in range(k):
            pos[i, j] = seen[tope[i, j]]
            seen[tope[i, j]] += 1
    return tope, topw, pos, pos < cap, cap


def _switch_numpy(p, cfg, x, use):
    """A plain Switch dispatch in float64: each assignment that ``use``
    (T, k) keeps adds its weight times its expert's swiglu, plus the
    shared experts."""
    tope, topw, _, _, _ = _routing_numpy(p, cfg, x)
    x = x.astype(np.float64)

    def swiglu(xs, wi, wg, wo):
        h = xs @ np.asarray(wi, np.float64)
        h = h / (1 + np.exp(-h)) * (xs @ np.asarray(wg, np.float64))
        return h @ np.asarray(wo, np.float64)
    out = np.zeros_like(x)
    for i, j in zip(*np.nonzero(use)):
        ex = tope[i, j]
        out[i] += topw[i, j] * swiglu(x[i], p["wi"][ex], p["wg"][ex],
                                      p["wo"][ex])
    if cfg.n_shared_experts:
        sh = p["shared"]
        out += swiglu(x, sh["wi"], sh["wg"], sh["wo"])
    return out


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_dropped_assignments_write_nothing(dispatch):
    """32 tokens, top-2 of 4 experts, capacity_factor 0.5: 8 slots an
    expert, 32 of the 64 assignments dropped.  The JAX package's dropped
    assignments scatter zeros into slot 0 of their expert, so the token
    kept there loses that expert's output; the port's write nothing.  So
    the port is a plain numpy Switch dispatch of the kept assignments, and
    equals the JAX package on every token but the overwritten ones; the
    JAX package is the same dispatch without the slot-0 assignments of
    experts that dropped one."""
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, capacity_factor=0.5)
    p, m, xj, xt = _layer_case(jcfg, tcfg, torch.float32, b=1)
    x = _f32(xj).reshape(32, -1)
    yj = _f32(jmoe.moe_layer(p, jcfg, xj)[0]).reshape(32, -1)
    yt = _f32(moe.moe_layer(m, tcfg, xt)[0]).reshape(32, -1)
    tope, _, pos, kept, cap = _routing_numpy(p, jcfg, x)
    assert cap == 8 and int((~kept).sum()) == 32
    assert int(m.n_dropped) == 32
    full = np.unique(tope[~kept])                 # experts that dropped one
    hit = (pos == 0) & np.isin(tope, full)
    overwritten = np.flatnonzero(hit.any(-1))
    others = np.setdiff1d(np.arange(32), overwritten)
    assert len(overwritten) > 0
    want = _switch_numpy(p, jcfg, x, kept)
    scale = np.abs(want).max()
    np.testing.assert_allclose(yt, want, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(yt[others], yj[others], rtol=1e-5,
                               atol=1e-5 * scale)
    assert np.abs(yt[overwritten] - yj[overwritten]).max() > 1e-3 * scale
    np.testing.assert_allclose(yj, _switch_numpy(p, jcfg, x, kept & ~hit),
                               rtol=1e-5, atol=1e-5 * scale)


# --------------------------------------------------------------------------
# the moe model: parameters, checkpoints, prefill
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


@pytest.mark.parametrize("name", MOE)
def test_full_width_moe_parameter_names_and_shapes(name):
    """At full width, on the meta device: the JAX ``init_params``'s flat
    paths and shapes; experts in bf16, the router in float32."""
    model = init_params(get_config(name), device="meta")
    assert _port_flat_shapes(model) == _jax_flat_shapes(jax_config(name))
    blk = model.layers[0]
    assert blk.mlp is None and blk.moe.wi.dtype == torch.bfloat16
    assert blk.moe.router.w.dtype == torch.float32
    if name == "deepseek-moe-16b":
        n = sum(p.numel() for p in model.parameters())
        assert n == 16_669_853_696
        assert blk.moe.shared.wi.shape == (2048, 2 * 1408)
    else:
        assert blk.moe.shared is None


def _pair(name, **over):
    jcfg, tcfg = _cfgs(name, **over)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, npz.params_from_numpy(
        tcfg, jnpz._flatten(params), device="cpu")


@pytest.mark.parametrize("name", MOE)
def test_moe_params_from_numpy_is_the_jax_params_rounded(name):
    _, tcfg, params, model = _pair(name)
    flat = jnpz._flatten(params)
    assert any(k.startswith("layers/moe/router") for k in flat)
    back = npz.to_numpy(model)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        exact = key.endswith("scale") or "router" in key
        want = arr if exact else np.asarray(jnp.asarray(arr).astype(
            jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    f32 = npz.params_from_numpy(tcfg, flat, device="cpu",
                                dtype=torch.float32)
    for key, arr in npz.to_numpy(f32).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)


def test_moe_checkpoint_round_trip_both_ways(tmp_path):
    jcfg, tcfg, params, model = _pair("deepseek-moe-16b")
    path = jnpz.save_checkpoint(str(tmp_path / "jax"), 2, params)
    loaded = npz.load_checkpoint(path, tcfg, device="cpu")
    for (n1, p1), (n2, p2) in zip(loaded.named_parameters(),
                                  model.named_parameters()):
        assert n1 == n2 and p1.dtype == p2.dtype and torch.equal(p1, p2), n1
    mine = init_params(tcfg, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    path = npz.save_checkpoint(str(tmp_path / "port"), 5, mine)
    restored = jnpz._flatten(jnpz.restore_checkpoint(path, params))
    for key, arr in npz.to_numpy(mine).items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla_chunked"])
@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_matches_jax(name, attn_impl, monkeypatch):
    """The prefill of a moe model against the jitted JAX step, 4 x 128
    tokens, nothing dropped: logits within LOGIT_TOL where no differing
    router choice reaches them; the aux loss, the mean of the routers'
    losses, within 1e-2 (a differing top-1 choice moves it)."""
    jcfg, tcfg, params, model = _pair(name, capacity_factor=8.0,
                                      attn_impl=attn_impl)
    tok = np.random.default_rng(128).integers(
        0, jcfg.vocab_size, size=(4, 128)).astype(np.int32)
    jax_calls = record_jax_routing(monkeypatch)
    want = _f32(jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)}))
    with port_routing(model) as port_calls:
        logits = make_prefill_step(tcfg)(model, {"tokens": tok})
    assert logits.dtype == torch.bfloat16
    jax.effects_barrier()
    assert len(jax_calls) == len(port_calls) == jcfg.n_layers
    tainted, unexplained = routing_taint(jax_calls, port_calls, jcfg.top_k,
                                         jcfg.n_layers)
    assert not unexplained.any(), np.argwhere(unexplained)
    assert_logits_match(_f32(logits), want, tainted)
    _, aux_j = jax.jit(functools.partial(jmodel.forward, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(tok)})
    with torch.inference_mode():
        _, aux_t = model({"tokens": tok}, cfg=tcfg)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-2)
