"""Parity of the port's LM training with the JAX package's, on the CPU:
the losses, ``loss_fn`` and one ``make_train_step`` step for every family,
microbatches, remat, the token pipeline, the launcher, and checkpoints
that each package resumes from the other's.

The JAX package's parameters (``init_params`` from a PRNG key) enter the
port through ``params_from_numpy`` in float32, as the JAX package keeps
them, and the same numpy tokens (and bf16 patches or frames) go through
both.  SMOKE configs (2 layers) at 64 tokens (zamba2, whose JAX step runs
op by op, at 32: one chunk of its scan); the moe family at
``capacity_factor=8.0``, where nothing is dropped (the port departs from
the JAX package on dropped assignments, ``models/moe.py``).  Tolerances,
with their reasons:

* The losses: float32 in, float32 out, within 1e-5 of the JAX package's
  (sums in other orders).
* ``loss_fn`` and the train step in bf16: the loss within ``LOSS_TOL``
  (3e-2, the prefill contract's bound) of the JAX step's, jitted, or op
  by op for zamba2 (``jax.disable_jit``), whose jitted step keeps bf16
  intermediates in float32 (``tests/test_torch_hybrid.py``).  Gradients
  round differently in the two packages' bf16, so each is held to the
  port's own float32 gradient (``loss_fn(..., dtype=float32)``): per JAX
  leaf, the port's bf16 gradient lies no farther from it in relative L2
  than ``GRAD_RATIO`` (1.25) times the JAX step's bf16 gradient does.
  The JAX gradient is read from its first moment, ``m = (1 - b1) * scale
  * g`` (``scale`` the clipping factor, from its gnorm).
* After one AdamW step the parameters agree within ``2 lr`` (plus float32
  rounding): Adam's first update is ``lr * g / |g|`` to within eps, so a
  gradient near 0 whose sign differs moves the parameter by up to 2 lr
  the other way; the gradient norms within ``LOSS_TOL`` relative.
* Microbatches: 2 against 1, the loss within rtol 1e-3 and the
  accumulated gradients (first moments) within 5e-3 of the largest (the
  counterpart of ``tests/test_models.py::
  test_microbatched_step_matches_plain``).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import npz as jnpz
from repro.configs import get_config as jax_config
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.launch import steps as jsteps, train as jtrain
from repro.models import layers as jlayers, model as jmodel
from repro.optim import AdamWConfig as JaxAdamWConfig, \
    adamw_init as jax_adamw_init
from repro_torch.checkpoint import npz
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import lm_pretrain, steps, train
from repro_torch.models import init_params, layers, model as model_lib
from repro_torch.optim import AdamWConfig, adamw_init

LOSS_TOL = 3e-2
GRAD_RATIO = 1.25
SEQ = 64
LR = 1e-3
FAMILIES = ["glm4-9b", "deepseek-moe-16b", "xlstm-125m", "zamba2-2.7b",
            "internvl2-1b", "whisper-tiny"]
FAMILY_IDS = ["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
OVER = {"deepseek-moe-16b": dict(capacity_factor=8.0)}


def _opt(**kw):
    kw = dict(lr=LR, warmup_steps=0, total_steps=10, **kw)
    return AdamWConfig(**kw), JaxAdamWConfig(**kw)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# the losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = 3 * rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    lt = torch.from_numpy(logits).requires_grad_()
    got = layers.softmax_xent(lt, torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    got.backward()
    got = got.detach()
    jm = None if mask is None else jnp.asarray(mask)
    want, jg = jax.value_and_grad(jlayers.softmax_xent)(
        jnp.asarray(logits), jnp.asarray(labels), jm)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("s,chunk", [(60, 256), (60, 16), (64, 32),
                                     (37, 8)])
def test_softmax_xent_chunked_matches_jax(s, chunk):
    """Chunks of ``chunk`` shrunk until they divide s (60 by 16: 15; 37
    by 8: 1); the loss and its gradients in the table and in x."""
    rng = np.random.default_rng(s + chunk)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    x = rng.normal(size=(2, s, 8)).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, s)).astype(np.int32)
    tt, xt = (torch.from_numpy(a).requires_grad_() for a in (table, x))
    got = layers.softmax_xent_chunked(tt, xt, torch.from_numpy(labels),
                                      chunk=chunk)
    got.backward()
    got = got.detach()
    want, (gt, gx) = jax.value_and_grad(
        functools.partial(jlayers.softmax_xent_chunked, chunk=chunk),
        argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x),
                        jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-7)
    # and the same as the unchunked loss over the whole logits
    whole = layers.softmax_xent(torch.from_numpy(x) @ torch.from_numpy(
        table).T, torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(whole), rel=1e-6)


# --------------------------------------------------------------------------
# loss_fn and the train step, every family, against the JAX step
# --------------------------------------------------------------------------

def _setup(name):
    jcfg = dataclasses.replace(jax_config(name, smoke=True),
                               **OVER.get(name, {}))
    tcfg = dataclasses.replace(get_config(name, smoke=True),
                               **OVER.get(name, {}))
    rng = np.random.default_rng(FAMILIES.index(name))
    seq = 32 if jcfg.family == "hybrid" else SEQ    # the op-by-op step
    tok = rng.integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    batch, jbatch = {"tokens": tok}, {"tokens": jnp.asarray(tok)}
    front = {"vlm": "patches", "audio": "frames"}.get(jcfg.family)
    if front:
        arr = rng.normal(size=(2, jcfg.n_frontend_tokens,
                               jcfg.d_model)).astype(np.float32)
        batch[front] = torch.from_numpy(arr).bfloat16()
        jbatch[front] = jnp.asarray(arr).astype(jnp.bfloat16)
    return jcfg, tcfg, batch, jbatch


def _port_model(tcfg, params):
    """The JAX params as a trainable float32 port model."""
    model = npz.params_from_numpy(tcfg, jnpz._flatten(params), device="cpu",
                                  dtype=torch.float32)
    return model.requires_grad_(True)


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """The JAX package's train step from seeded params: (params, new
    params, metrics, its gradients by flat path)."""
    jcfg, _, _, jbatch = _setup(name)
    _, jopt = _opt()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jax_adamw_init(params)
    fn = jsteps.make_train_step(jcfg, jopt)
    if jcfg.family == "hybrid":
        with jax.disable_jit():
            new, new_opt, metrics = fn(params, opt, jbatch)
    else:
        new, new_opt, metrics = jax.jit(fn)(params, opt, jbatch)
    metrics = {k: float(v) for k, v in metrics.items()}
    scale = min(1.0, jopt.clip_norm / (metrics["gnorm"] + 1e-9))
    grads = {k: np.asarray(m, np.float32) / ((1 - jopt.b1) * scale)
             for k, m in jnpz._flatten(new_opt["m"]).items()}
    return params, new, metrics, grads


def _port_grads(model, cfg, batch, dtype):
    params = dict(model.named_parameters())
    loss, (xent, aux) = model_lib.loss_fn(model, cfg, batch, dtype=dtype)
    grads = torch.autograd.grad(loss, list(params.values()))
    return ([float(t) for t in (loss, xent, aux)],
            npz._stacked(zip(params, grads)))


@pytest.mark.parametrize("name", FAMILIES, ids=FAMILY_IDS)
def test_loss_and_gradients_match_jax(name):
    jcfg, tcfg, batch, _ = _setup(name)
    params, _, metrics, jgrads = _jax_step(name)
    model = _port_model(tcfg, params)
    (loss, xent, aux), g16 = _port_grads(model, tcfg, batch, torch.bfloat16)
    _, g32 = _port_grads(model, tcfg, batch, torch.float32)
    assert abs(loss - metrics["loss"]) <= LOSS_TOL
    assert abs(xent - metrics["xent"]) <= LOSS_TOL
    assert abs(aux - metrics["aux"]) <= LOSS_TOL
    assert (aux > 0) == (jcfg.family == "moe")
    assert sorted(g16) == sorted(jgrads)
    for key, want in g32.items():
        port, jax_ = _rel_l2(g16[key], want), _rel_l2(jgrads[key], want)
        assert port <= GRAD_RATIO * jax_, (key, port, jax_)


@pytest.mark.parametrize("name", FAMILIES, ids=FAMILY_IDS)
def test_train_step_matches_jax(name):
    _, tcfg, batch, _ = _setup(name)
    params, new, metrics, _ = _jax_step(name)
    opt, _ = _opt()
    model = _port_model(tcfg, params)
    state = adamw_init(dict(model.named_parameters()))
    model, state, got = steps.make_train_step(tcfg, opt)(model, state, batch)
    assert int(state["step"]) == 1
    assert all(t.ndim == 0 and t.dtype == torch.float32
               for t in got.values())
    assert abs(float(got["loss"]) - metrics["loss"]) <= LOSS_TOL
    assert float(got["gnorm"]) == pytest.approx(metrics["gnorm"],
                                                rel=LOSS_TOL)
    want = jnpz._flatten(new)
    for key, arr in npz.to_numpy(model).items():
        np.testing.assert_allclose(arr, want[key], rtol=1e-6,
                                   atol=2 * LR * 1.001, err_msg=key)


def test_microbatched_step_matches_plain():
    cfg = get_config("glm4-9b", smoke=True)
    opt, _ = _opt(clip_norm=1e9)
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, SEQ))
    out = []
    for micro in (1, 2):
        model, state = steps.init_train_state(
            cfg, torch.Generator().manual_seed(0), opt, device="cpu")
        out.append(steps.make_train_step(cfg, opt, microbatches=micro)(
            model, state, {"tokens": tok}))
    (_, s1, m1), (_, s2, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    g1 = torch.cat([t.ravel() for t in s1["m"].values()])
    g2 = torch.cat([t.ravel() for t in s2["m"].values()])
    assert float((g1 - g2).abs().max()) < 5e-3 * float(g1.abs().max()) + 1e-7


def test_remat_runs_each_block_again_and_changes_nothing(monkeypatch):
    """``cfg.remat``: each decoder block runs twice a step (forward, then
    again in the backward) and the gradients are the same bits."""
    cfg = get_config("glm4-9b", smoke=True)
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, SEQ))
    calls = []
    real = model_lib.DecoderBlock.forward
    monkeypatch.setattr(model_lib.DecoderBlock, "forward",
                        lambda self, *a, **kw: calls.append(1)
                        or real(self, *a, **kw))
    grads = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model, _ = steps.init_train_state(
            c, torch.Generator().manual_seed(0), _opt()[0], device="cpu")
        calls.clear()
        grads[remat] = _port_grads(model, c, {"tokens": tok},
                                   torch.bfloat16)[1]
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
    for key, g in grads[True].items():
        np.testing.assert_array_equal(g, grads[False][key], err_msg=key)


@pytest.mark.parametrize("name", FAMILIES, ids=FAMILY_IDS)
def test_remat_checkpoints_where_the_jax_package_does(name, monkeypatch):
    """``cfg.remat``: one forward of the port calls ``torch.utils.
    checkpoint`` as often as the JAX package's forward, its layers
    unrolled, calls a body that ``_maybe_remat`` wrapped: each block of
    the dense, vlm and moe stacks, each audio encoder block and decoder
    layer, the mLSTM and Mamba2 layers, and not the sLSTM layer nor
    zamba2's shared attention block."""
    jcfg, tcfg, batch, jbatch = _setup(name)
    jcfg = dataclasses.replace(jcfg, remat=True, scan_layers=False)
    tcfg = dataclasses.replace(tcfg, remat=True)
    jax_calls, port_calls = [], []
    real_remat = jmodel._maybe_remat

    def counted_remat(fn, cfg):
        body = real_remat(fn, cfg)

        def call(*args):
            jax_calls.append(1)
            return body(*args)
        return call if cfg.remat else body
    monkeypatch.setattr(jmodel, "_maybe_remat", counted_remat)
    params = jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    jax.eval_shape(lambda p: jmodel.hidden(p, jcfg, jbatch), params)
    real_checkpoint = model_lib.checkpoint
    monkeypatch.setattr(model_lib, "checkpoint",
                        lambda fn, *a, **kw: port_calls.append(1)
                        or real_checkpoint(fn, *a, **kw))
    model, _ = steps.init_train_state(
        tcfg, torch.Generator().manual_seed(0), _opt()[0], device="cpu")
    x, _ = model.hidden(batch, cfg=tcfg)
    assert x.requires_grad
    assert len(jax_calls) > 0
    assert len(port_calls) == len(jax_calls)


def test_the_blockwise_path_trains_through_the_autograd_function():
    """``pallas`` sends attention through ``ops.flash_attention`` and its
    autograd function (the plain forward and backward here); in float32
    its gradients equal the naive path's within 1e-5 of the largest."""
    cfg = get_config("glm4-9b", smoke=True)
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 128))
    out = {}
    for impl in ("pallas", "xla_chunked"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        model, _ = steps.init_train_state(
            c, torch.Generator().manual_seed(0), _opt()[0], device="cpu")
        out[impl] = _port_grads(model, c, {"tokens": tok}, torch.float32)
    assert out["pallas"][0][0] == pytest.approx(out["xla_chunked"][0][0],
                                                rel=1e-6)
    for key, g in out["pallas"][1].items():
        want = out["xla_chunked"][1][key]
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


def test_parameters_are_trainable_only_in_a_train_state():
    cfg = get_config("internvl2-1b", smoke=True)
    served = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    model, state = steps.init_train_state(
        cfg, torch.Generator().manual_seed(0), _opt()[0], device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    assert set(state["m"]) == {n for n, _ in model.named_parameters()}
    logits = steps.make_prefill_step(cfg)(model, {
        "tokens": np.zeros((1, 8), np.int64),
        "patches": torch.zeros(1, cfg.n_frontend_tokens, cfg.d_model)})
    assert logits.grad_fn is None and logits.shape == (1, 8, cfg.vocab_size)


def test_full_width_train_state_shapes_match_jax():
    """internvl2-1b at full width, on the meta device and through
    ``jax.eval_shape``: the same paths and shapes, params and moments."""
    opt, jopt = _opt()
    model, state = steps.train_state_shapes(get_config("internvl2-1b"), opt)
    jparams, jstate = jsteps.train_state_shapes(jax_config("internvl2-1b"),
                                                jopt)
    jshapes = {"/".join(jnpz._key_str(k) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jparams)[0]}
    got: dict = {}
    for name, p in model.named_parameters():
        key, index = npz.flat_key(name)
        got.setdefault(key, []).append((index, tuple(p.shape)))
        assert p.device.type == "meta" and p.dtype == torch.float32
        assert state["m"][name].shape == p.shape
    shapes = {k: (tuple(max(i[a] for i, _ in v) + 1
                        for a in range(len(v[0][0])))
                  if v[0][0] is not None else ()) + v[0][1]
              for k, v in got.items()}
    assert shapes == jshapes
    assert sum(p.numel() for p in model.parameters()) == 494_583_808
    assert jax.tree.structure(jstate["m"]) == jax.tree.structure(jparams)


# --------------------------------------------------------------------------
# the token pipeline
# --------------------------------------------------------------------------

def test_token_pipeline_follows_the_jax_rules():
    """The JAX pipeline's rules, held by both: int32 ids in [0, V), every
    odd position a copy of the one before, ``u ** 3`` marginal (half the
    ids below V / 8, a mean near V / 4); a pure function of (seed,
    step)."""
    v, s, b = 1000, 64, 256
    for pipe in (TokenPipeline(v, s, b, seed=3), JaxTokenPipeline(v, s, b,
                                                                  seed=3)):
        tok = np.asarray(pipe.batch_at(7)["tokens"])
        assert tok.shape == (b, s) and tok.dtype == np.int32
        assert tok.min() >= 0 and tok.max() < v
        np.testing.assert_array_equal(tok[:, 1::2], tok[:, 0::2])
        even = tok[:, 0::2]
        assert abs((even < v / 8).mean() - 0.5) < 0.02
        assert abs(even.mean() / (v - 1) - 0.25) < 0.01
        np.testing.assert_array_equal(np.asarray(pipe.batch_at(7)["tokens"]),
                                      tok)
        assert not np.array_equal(np.asarray(pipe.batch_at(8)["tokens"]), tok)
        shard = np.asarray(pipe.shard_at(7, 1, 4)["tokens"])
        np.testing.assert_array_equal(shard, tok[64:128])
    other = TokenPipeline(v, s, b, seed=4).batch_at(7)["tokens"]
    assert not torch.equal(other, TokenPipeline(v, s, b, seed=3).batch_at(
        7)["tokens"])


# --------------------------------------------------------------------------
# the launcher and checkpoints shared with the JAX package
# --------------------------------------------------------------------------

def test_make_batch_fn_is_seeded_and_on_the_device():
    cfg = get_config("whisper-tiny", smoke=True)
    fn = train.make_batch_fn(cfg, 2, 16, device="cpu")
    a, b = fn(3), fn(3)
    assert set(a) == {"tokens", "frames"}
    assert a["frames"].dtype == torch.bfloat16
    assert a["frames"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(fn(4)["frames"], a["frames"])


def test_train_runs_on_the_card_unless_asked_for_the_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.train("glm4-9b", steps_n=1)
    train.main(["--arch", "internvl2-1b", "--smoke", "--device", "cpu",
                "--steps", "2", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "[train] done: first=" in out and "step=   1" in out


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_port_checkpoint_resumes_in_the_jax_launcher(tmp_path, capsys):
    """The port writes ``params/...`` and ``opt/...`` at step 2; the JAX
    launcher restores them bit for bit and trains on from step 2."""
    d = str(tmp_path)
    kw = dict(smoke=True, batch=2, seq=32, ckpt_dir=d, ckpt_every=2)
    train.train("glm4-9b", steps_n=2, device="cpu", **kw)
    assert npz.latest_step(d) == jnpz.latest_step(d) == 2
    saved = _arrays(os.path.join(d, "step_00000002.npz"))
    assert int(saved["opt/step"]) == 2 and saved["opt/step"].dtype == np.int32
    cfg = jax_config("glm4-9b", smoke=True)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tgt = {"params": params, "opt": jax_adamw_init(params)}
    restored = jnpz._flatten(jnpz.restore_checkpoint(
        os.path.join(d, "step_00000002.npz"), tgt))
    assert sorted(restored) == sorted(saved)
    for key, arr in saved.items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)
    losses = jtrain.train("glm4-9b", steps_n=3, **kw)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "restored step 2" in capsys.readouterr().out


def test_jax_checkpoint_resumes_in_the_port_launcher(tmp_path, capsys):
    d = str(tmp_path)
    kw = dict(smoke=True, batch=2, seq=32, ckpt_dir=d, ckpt_every=2)
    jtrain.train("internvl2-1b", steps_n=2, **kw)
    saved = _arrays(os.path.join(d, "step_00000002.npz"))
    cfg = get_config("internvl2-1b", smoke=True)
    model, state = steps.init_train_state(
        cfg, torch.Generator().manual_seed(1), _opt()[0], device="cpu")
    npz.restore_checkpoint(os.path.join(d, "step_00000002.npz"), model,
                           state)
    assert int(state["step"]) == 2
    for key, arr in npz.to_numpy(model).items():
        np.testing.assert_array_equal(arr, saved["params/" + key])
    for part in ("m", "v"):
        for key, arr in npz._stacked(state[part].items()).items():
            np.testing.assert_array_equal(arr, saved[f"opt/{part}/{key}"])
    losses = train.train("internvl2-1b", steps_n=3, device="cpu", **kw)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "restored step 2" in capsys.readouterr().out
    assert npz.latest_step(d) == 2        # no checkpoint at step 3


def test_restore_refuses_a_missing_or_misshapen_entry(tmp_path):
    cfg = get_config("glm4-9b", smoke=True)
    model, state = steps.init_train_state(
        cfg, torch.Generator().manual_seed(0), _opt()[0], device="cpu")
    path = npz.save_checkpoint(str(tmp_path), 1, model, state)
    flat = _arrays(path)
    del flat["opt/v/ln_f/scale"]
    np.savez(path, **flat)
    with pytest.raises(KeyError, match="opt/v/ln_f/scale"):
        npz.restore_checkpoint(path, model, state)
    flat["opt/v/ln_f/scale"] = np.zeros(3, np.float32)
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="shape"):
        npz.restore_checkpoint(path, model, state)
    assert npz.latest_step(str(tmp_path / "none")) is None


def test_lm_pretrain_resumes_from_its_checkpoint(tmp_path, capsys):
    """The pretraining entry point (SMOKE, 4 steps, a checkpoint every
    2): a second run from step 2 repeats the first run's last two losses
    and final parameters bit for bit."""
    d = str(tmp_path)
    kw = dict(steps_n=4, smoke=True, batch=2, seq=32, ckpt_dir=d,
              ckpt_every=2, device="cpu")
    first = lm_pretrain.pretrain(**kw)
    final = _arrays(os.path.join(d, "step_00000004.npz"))
    os.remove(os.path.join(d, "step_00000004.npz"))
    again = lm_pretrain.pretrain(**kw)
    assert again == first[2:]
    for key, arr in _arrays(os.path.join(d, "step_00000004.npz")).items():
        np.testing.assert_array_equal(arr, final[key], err_msg=key)
    lm_pretrain.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                      "32", "--ckpt-dir", str(tmp_path / "cli"),
                      "--device", "cpu"])
    assert "loss " in capsys.readouterr().out


def test_softplus_takes_jax_derivative_at_its_kink():
    """``softplus`` (and ``log_sigmoid``) differentiate as ``jnp.logaddexp``
    does: 1/2 at 0 exactly, where autograd through ``max(x, 0)`` and
    ``|x|`` would give 1; bf16 inputs reach 0 often (the Mamba2 step size
    ``softplus(dt + dt_bias)`` at a bf16 dt of 2.0)."""
    x = np.array([-30.0, -2.0, -0.5, 0.0, 0.5, 2.0, 30.0], np.float32)
    for fn, jfn in ((layers.softplus, jax.nn.softplus),
                    (layers.log_sigmoid, jax.nn.log_sigmoid)):
        t = torch.from_numpy(x).requires_grad_()
        fn(t).sum().backward()
        want = jax.grad(lambda a: jnp.sum(jfn(a)))(jnp.asarray(x))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-12)
    t = torch.zeros(3, dtype=torch.bfloat16, requires_grad=True)
    layers.softplus(t).sum().backward()
    assert torch.equal(t.grad, torch.full((3,), 0.5, dtype=torch.bfloat16))
