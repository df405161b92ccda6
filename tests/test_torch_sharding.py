"""The port's sharded step (``repro_torch.models.sharding``, the plan
applied by ``repro_torch.launch.{mesh, shardings}``) against the JAX
package's rules and against the port's own unsharded step, on the CPU.

* ``models.sharding.spec`` equals the JAX package's ``spec``, entry for
  entry, under both rule sets with ``seq_shard`` on and off, for every
  logical-axis tuple of the 11 ``constrain`` sites and for the rule that
  a mesh axis is used once a spec.
* ``launch.shardings.placements`` of every leaf of every arch at both pod
  meshes (a fake process group of 256 / 512 ranks) round-trips to the
  plan's spec tuple.
* On 4 spawned gloo ranks over a 2 x 2 (data, model) mesh, the sharded
  float32 prefill of one SMOKE config a family (and granite's MQA, whose
  kv heads stay whole on each rank), four decode steps of the dense one,
  and the sharded float32 train steps
  of the dense configs (glm4-9b with ``train_microbatches=2``, so that
  ``grad_shardings`` acts, and with ``seq_shard``; granite-20b) and of
  the moe one (its experts split over 'model'), two of them through the
  flash kernel's plain version on local heads, equal the unsharded port
  step within 1e-5 (the ranks' partial sums add in
  another order than one product does).  The bf16 dense prefill of the
  JAX package's parameters is held to the JAX step within the prefill
  contract (3e-2, argmax differing only at near ties).  The collective
  bytes each rank counts in the dense prefill and train step equal a
  fake-group meta count of the same steps.

One start of 4 ranks for the whole suite (``launch.distributed.run``,
``FileStore``), with a timeout of its own.
"""

import copy
import dataclasses
import multiprocessing.pool

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import npz
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.launch import distributed as dist_lib, mesh, roofline, \
    shardings, specs, steps
from repro_torch.models import init_params, model as model_lib, sharding
from repro_torch.optim import AdamWConfig

TOL = 1e-5
LOGIT_TOL = 3e-2
RANKS_TIMEOUT_S = 240
SEQ, BATCH = 64, 4

# the logical axes of the JAX package's 11 constrain sites
SITES = {
    "model.py:119,127,252": ("batch", "seq", "embed"),
    "model.py:284": ("batch", "seq", "vocab"),
    "layers.py:93 (3-d)": ("batch", "seq", "ff"),
    "layers.py:93 (2-d)": ("batch", "ff"),
    "layers.py:155": ("batch", None, "vocab"),
    "moe.py:55": ("experts", "expert_cap", None),
    "moe.py:111": ("batch", None, None),
    "moe.py:128,131": ("batch", "experts", "expert_cap", None),
    "attention.py:219": ("batch", "seq", "heads", None),
}
# a mesh axis once a spec: 'model' is taken by the first of these
REUSE = {"seq then vocab": ("seq", "vocab"), "heads twice":
         ("heads", "kv_heads"), "ff then experts": ("batch", "ff", "experts")}

PREFILL_CASES = {"glm4-9b": "dense", "granite-20b": "dense-mqa",
                 "deepseek-moe-16b": "moe", "xlstm-125m": "ssm",
                 "zamba2-2.7b": "hybrid", "internvl2-1b": "vlm",
                 "whisper-tiny": "audio"}
# (arch, config overrides, sequence): 128 tokens under "pallas" reach
# ops.flash_attention (on the CPU its plain version) in the local region
TRAIN_CASES = {"glm4-9b-microbatches": ("glm4-9b", dict(
                   train_microbatches=2), SEQ),
               "glm4-9b-seq-shard": ("glm4-9b", dict(seq_shard=True), SEQ),
               "glm4-9b-flash": ("glm4-9b", dict(attn_impl="pallas"), 128),
               "granite-20b-mqa": ("granite-20b", {}, SEQ),
               "granite-20b-mqa-flash": ("granite-20b", dict(
                   attn_impl="pallas"), 128),
               "deepseek-moe-16b": ("deepseek-moe-16b", {}, SEQ)}
DECODE_STEPS = 4
# on a 1 x 4 (data, model) mesh, heads that 'model' does not divide: split
# as DTensor splits them (2, 2, 2 and 0 of 6 query heads; 1, 1, 0, 0 of
# xlstm's 2), the last ranks running their regions on no head at all; the
# train step's vocabulary too (128, 128, 128 and 126 of 510 words)
UNEVEN_CASES = {"dense-prefill": ("prefill", "glm4-9b", dict(n_heads=6)),
                "ssm-prefill": ("prefill", "xlstm-125m", {}),
                "dense-train": ("train", "glm4-9b", dict(n_heads=6,
                                                         vocab_size=510))}


# --------------------------------------------------------------------------
# the rules and the placements
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq_shard", [False, True], ids=["tp", "seq-shard"])
@pytest.mark.parametrize("pods", [1, 2], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("site", [*SITES, *REUSE])
def test_spec_matches_jax(site, pods, seq_shard):
    from jax.sharding import AbstractMesh
    from repro.models import sharding as jax_sharding
    axes = SITES.get(site) or REUSE[site]
    shape = mesh.make_production_mesh(multi_pod=pods == 2)
    jmesh = AbstractMesh(tuple(shape.shape.values()), shape.axis_names)
    jrules = jax_sharding.rules_for_mesh(jmesh, seq_shard=seq_shard)
    rules = sharding.rules_for_mesh(shape, seq_shard=seq_shard)
    assert rules == jrules
    with jax_sharding.logical_rules(jrules), sharding.logical_rules(rules):
        assert sharding.spec(*axes) == tuple(jax_sharding.spec(*axes))
    assert sharding.spec(*axes) == () == tuple(jax_sharding.spec(*axes))


def test_constrain_is_the_identity_without_rules_or_a_dtensor():
    x = torch.ones(2, 3)
    assert sharding.constrain(x, "batch", "embed") is x
    with sharding.logical_rules(sharding.SINGLE_POD_RULES):
        assert sharding.constrain(x, "batch", "embed") is x


def _spec_of(placements: tuple, ndim: int, dm) -> tuple:
    """The spec tuple, one entry a tensor dim, of DTensor placements:
    launch.shardings.placements' inverse."""
    entries: list = [[] for _ in range(ndim)]
    for name, p in zip(dm.mesh_dim_names, placements):
        if p.is_shard():
            entries[p.dim] += name.split("+")
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def _all_leaves(arch):
    cfg = get_config(arch)
    model, opt = steps.train_state_shapes(cfg, AdamWConfig())
    return cfg, model, opt


@pytest.mark.parametrize("pods", [1, 2], ids=["pod16x16", "pod2x16x16"])
def test_placements_round_trip_the_plan(pods):
    shape = mesh.make_production_mesh(multi_pod=pods == 2)
    with mesh.fake_group(shape.size):
        dm = mesh.device_mesh(shape)
        for arch in ARCH_NAMES:
            cfg, model, opt = _all_leaves(arch)
            plan = {**shardings.param_shardings(shardings.param_leaves(
                model.named_parameters()), shape, cfg),
                **shardings.opt_shardings(shardings.opt_leaves(opt), shape,
                                          cfg)}
            leaves = {**shardings.param_leaves(model.named_parameters()),
                      **shardings.opt_leaves(opt)}
            for key, spec in plan.items():
                nd = leaves[key].ndim
                got = _spec_of(shardings.placements(spec, dm), nd,
                                        dm)
                assert got == spec + (None,) * (nd - len(spec)), (arch, key)


def test_shard_model_places_each_layer_by_its_stacked_leaf():
    """A per-layer tensor takes the stacked leaf's spec without the
    stacked axes; an AdamW moment takes the ZeRO-1 spec."""
    shape = mesh.make_debug_mesh(2, 2)
    cfg = get_config("glm4-9b", smoke=True)
    with mesh.fake_group(shape.size):
        dm = mesh.device_mesh(shape)
        model, opt = steps.train_state_shapes(cfg, AdamWConfig())
        plan = shardings.param_shardings(shardings.param_leaves(
            model.named_parameters()), shape, cfg)
        oplan = shardings.opt_shardings(shardings.opt_leaves(opt), shape,
                                        cfg)
        opt = shardings.shard_opt_state(opt, dm, cfg)
        shardings.shard_model(model, dm, cfg)
        wq = model.layers[1].attn.wq.w
        assert _spec_of(wq.placements, 2, dm) == \
            plan["layers/attn/wq/w"][1:] == (None, "model")
        m = opt["m"]["layers.1.attn.wq.w"]
        assert _spec_of(m.placements, 2, dm) == \
            oplan["m/layers/attn/wq/w"][1:] == ("data", "model")
        assert wq.requires_grad and wq.to_local().shape == (256, 128)
        assert shardings.grad_placements(opt)["layers.1.attn.wq.w"] == \
            m.placements


# --------------------------------------------------------------------------
# the sharded steps on 4 gloo ranks
# --------------------------------------------------------------------------

def _cfg(arch, **over):
    cfg = get_config(arch, smoke=True)
    if cfg.family == "moe":
        over.setdefault("moe_groups", 2)       # the data axis, as dryrun
    return dataclasses.replace(cfg, **over)


def _batch(cfg, seed, seq=SEQ):
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, seq),
                                   generator=gen, dtype=torch.int32)}
    if cfg.family in ("vlm", "audio"):
        key = "patches" if cfg.family == "vlm" else "frames"
        out[key] = torch.randn((BATCH, cfg.n_frontend_tokens, cfg.d_model),
                               generator=gen)
    return out


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _gap(got, want) -> float:
    return float((_full(got).detach().float() - want.detach().float())
                 .abs().max())


def _rules(dm, cfg, train):
    return sharding.logical_rules(sharding.rules_for_mesh(
        mesh.shape_of(dm), seq_shard=cfg.seq_shard and train), dm)


def _prefill_case(dm, arch, seed, seq=SEQ, **over):
    cfg = _cfg(arch, **over)
    model = init_params(cfg, generator=torch.Generator().manual_seed(seed),
                        device="cpu", dtype=torch.float32)
    batch = _batch(cfg, seed, seq)
    step = steps.make_prefill_step(cfg, dtype=torch.float32)
    want = step(model, batch)
    shardings.shard_model(model, dm, cfg)
    with _rules(dm, cfg, False):
        got = step(model, shardings.shard_batch(batch, dm))
    return {"gap": _gap(got, want), "scale": float(want.abs().max()),
            "spec": _spec_of(got.placements, got.ndim, dm)}


def _train_case(dm, arch, over, seed, seq=SEQ):
    cfg = _cfg(arch, **over)
    opt_cfg = AdamWConfig()
    model, opt = steps.init_train_state(
        cfg, torch.Generator().manual_seed(seed), opt_cfg, device="cpu")
    batch = _batch(cfg, seed, seq)
    sharded, sopt = copy.deepcopy(model), copy.deepcopy(opt)
    plain = steps.make_train_step(cfg, opt_cfg,
                                  microbatches=cfg.train_microbatches,
                                  dtype=torch.float32)
    _, opt, want = plain(model, opt, batch)
    shardings.shard_model(sharded, dm, cfg)
    sopt = shardings.shard_opt_state(sopt, dm, cfg)
    step = steps.make_train_step(
        cfg, opt_cfg, microbatches=cfg.train_microbatches,
        grad_shardings=(shardings.grad_placements(sopt)
                        if cfg.train_microbatches > 1 else None),
        dtype=torch.float32)
    with _rules(dm, cfg, True):
        _, sopt, got = step(sharded, sopt, shardings.shard_batch(batch, dm))
    gaps = {k: _gap(got[k], want[k]) / max(1.0, float(want[k].abs()))
            for k in ("loss", "xent", "gnorm")}
    params = dict(model.named_parameters())
    gaps["params"] = max(_gap(p, params[n])
                         for n, p in sharded.named_parameters())
    for part in ("m", "v"):
        gaps[part] = max(_gap(t, opt[part][n]) / max(
            float(opt[part][n].abs().max()), 1e-30)
            for n, t in sopt[part].items())
    return gaps


def _decode_case(dm, arch, seed):
    """DECODE_STEPS tokens from an empty cache through the serve step: the
    logits and the caches, sharded against unsharded."""
    cfg = _cfg(arch)
    model = init_params(cfg, generator=torch.Generator().manual_seed(seed),
                        device="cpu", dtype=torch.float32)
    shape = INPUT_SHAPES["decode_32k"]
    state = model_lib.init_decode_state(cfg, BATCH, 16, device="cpu",
                                        dtype=torch.float32)
    sstate = shardings.shard_decode_state(
        copy.deepcopy(state), specs.decode_state_shardings(
            cfg, dataclasses.replace(shape, global_batch=BATCH),
            mesh.shape_of(dm)), dm)
    step = steps.make_serve_step(cfg)
    tokens = _batch(cfg, seed, DECODE_STEPS)["tokens"]
    smodel = shardings.shard_model(copy.deepcopy(model), dm, cfg)
    gap = 0.0
    for t in range(DECODE_STEPS):
        tok = tokens[:, t:t + 1]
        pos = torch.full((BATCH,), t, dtype=torch.int32)
        want, state = step(model, state, tok, pos)
        with _rules(dm, cfg, False):
            got, sstate = step(smodel, sstate,
                               *shardings.shard_batch(
                                   {"t": tok, "p": pos}, dm).values())
        gap = max(gap, _gap(got, want) / max(1.0, float(want.abs().max())))
    caches = max(_gap(sstate["kv"][k], state["kv"][k])
                 / max(1.0, float(state["kv"][k].abs().max()))
                 for k in ("k", "v"))
    return {"logits": gap, "caches": caches}


def _jax_prefill(dm, flat, seed):
    """The bf16 sharded prefill of the JAX package's parameters."""
    cfg = _cfg("glm4-9b")
    model = npz.params_from_numpy(cfg, flat, device="cpu")
    batch = _batch(cfg, seed)
    shardings.shard_model(model, dm, cfg)
    with _rules(dm, cfg, False):
        got = steps.make_prefill_step(cfg)(model,
                                           shardings.shard_batch(batch, dm))
    return {"logits": _full(got).float(), "tokens": batch["tokens"]}


def _counted(dm, arch):
    """Collective bytes of this rank in the dense prefill and train step."""
    out = {}
    for kind, fn in (("prefill", _count_prefill), ("train", _count_train)):
        with roofline.CollectiveCounter() as c:
            fn(dm, arch)
        out[kind] = c.bytes
    return out


def _count_prefill(dm, arch):
    cfg = _cfg(arch)
    model = init_params(cfg, device="meta" if dm.device_type == "cuda"
                        else "cpu", dtype=torch.float32,
                        generator=torch.Generator())
    batch = _batch(cfg, 0)
    shardings.shard_model(model, dm, cfg)
    batch = shardings.shard_batch(
        {k: v.to(model.embed.table.device) for k, v in batch.items()}, dm)
    with _rules(dm, cfg, False):
        steps.make_prefill_step(cfg, dtype=torch.float32)(model, batch)


def _count_train(dm, arch):
    cfg = _cfg(arch, train_microbatches=2)
    device = "meta" if dm.device_type == "cuda" else "cpu"
    model, opt = steps.init_train_state(cfg, torch.Generator(),
                                        AdamWConfig(), device=device)
    shardings.shard_model(model, dm, cfg)
    opt = shardings.shard_opt_state(opt, dm, cfg)
    batch = shardings.shard_batch(
        {k: v.to(device) for k, v in _batch(cfg, 0).items()}, dm)
    step = steps.make_train_step(
        cfg, AdamWConfig(), microbatches=2,
        grad_shardings=shardings.grad_placements(opt), dtype=torch.float32)
    with _rules(dm, cfg, True):
        step(model, opt, batch)


def _suite(flat) -> dict:
    """Every case on this rank; rank 0's results come back."""
    torch.set_num_threads(1)
    dm = mesh.device_mesh(mesh.make_debug_mesh(2, 2), "cpu")
    out = {"prefill": {a: _prefill_case(dm, a, seed=i)
                       for i, a in enumerate(PREFILL_CASES)},
           "train": {name: _train_case(dm, arch, over, seed=7, seq=seq)
                     for name, (arch, over, seq) in TRAIN_CASES.items()},
           "decode": _decode_case(dm, "glm4-9b", seed=5),
           "jax_prefill": _jax_prefill(dm, flat, seed=3),
           "counted": _counted(dm, "glm4-9b")}
    uneven = mesh.device_mesh(mesh.make_debug_mesh(1, 4), "cpu")
    out["uneven"] = {
        name: (_prefill_case(uneven, arch, seed=11, **over) if kind ==
               "prefill" else _train_case(uneven, arch, over, seed=11))
        for name, (kind, arch, over) in UNEVEN_CASES.items()}
    # the gloo forms the card's ranks take (every tensor there is a CUDA
    # one): the same steps through them on the CPU's tensors
    with dist_lib.GlooCollectives():
        out["gloo_forms"] = {
            "prefill": _prefill_case(dm, "deepseek-moe-16b", seed=2),
            "train": _train_case(dm, "glm4-9b", dict(train_microbatches=2),
                                 seed=7)}
    return out


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.checkpoint import npz as jnpz
    from repro.configs import get_config as jax_config
    from repro.models import model as jmodel
    jcfg = jax_config("glm4-9b", smoke=True)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, params, {k: np.asarray(v)
                          for k, v in jnpz._flatten(params).items()}


@pytest.fixture(scope="module")
def ranks(jax_params):
    """The suite on 4 gloo ranks, within RANKS_TIMEOUT_S."""
    with multiprocessing.pool.ThreadPool(1) as pool:
        job = pool.apply_async(dist_lib.run, (_suite, 4, jax_params[2]),
                               dict(device="cpu"))
        return job.get(timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("arch", list(PREFILL_CASES),
                         ids=list(PREFILL_CASES.values()))
def test_sharded_prefill_equals_the_unsharded_step(ranks, arch):
    r = ranks["prefill"][arch]
    assert r["gap"] <= TOL * max(1.0, r["scale"]), r
    # the logits leave the step split over the batch and the vocabulary
    assert r["spec"] == ("data", None, "model"), r


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_equals_the_unsharded_step(ranks, case):
    gaps = ranks["train"][case]
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("case", list(UNEVEN_CASES))
def test_uneven_heads_equal_the_unsharded_step(ranks, case):
    """Heads that the 'model' axis does not divide are split, not kept
    whole on every rank: each rank attends (or runs its recurrence) with
    its share, a rank with none keeps its inputs in the graph, and the
    step equals the unsharded one within 1e-5."""
    r = ranks["uneven"][case]
    if UNEVEN_CASES[case][0] == "prefill":
        assert r["gap"] <= TOL * max(1.0, r["scale"]), r
    else:
        assert max(r.values()) <= TOL, r


def test_sharded_decode_matches_the_unsharded_step(ranks):
    """The serve step on the sharded decode state (each rank writes its
    rows' slots into its part of the caches, then attends over it).  The
    decode step's activations are bf16 (it takes no dtype): held to the
    bf16 prefill contract, relative to the largest value."""
    assert max(ranks["decode"].values()) <= LOGIT_TOL, ranks["decode"]


@pytest.mark.parametrize("step", ["prefill", "train"])
def test_gloo_forms_give_the_same_steps(ranks, step):
    """Through launch.distributed.GlooCollectives (its all-gather by
    gloo's list form, its mean as a sum over the group's size): the moe
    prefill (the router's means) and the dense train step with ZeRO-1
    gradients, as without them."""
    r = ranks["gloo_forms"][step]
    gap = r["gap"] / max(1.0, r["scale"]) if step == "prefill" else \
        max(r.values())
    assert gap <= TOL, r


def test_sharded_dense_prefill_matches_jax(ranks, jax_params):
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    jcfg, params, _ = jax_params
    r = ranks["jax_prefill"]
    want = np.asarray(jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(r["tokens"].numpy())}).astype(
            jnp.float32))
    got = r["logits"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    differ = a_got != a_want
    gap = (np.take_along_axis(want, a_want[..., None], -1)
           - np.take_along_axis(want, a_got[..., None], -1))[..., 0]
    assert (gap[differ] <= LOGIT_TOL).all(), gap[differ]


def test_ranks_count_what_the_meta_count_counts(ranks):
    """The collective bytes a gloo rank counted in the dense steps equal
    the count of the same steps on meta tensors in a fake group."""
    shape = mesh.make_debug_mesh(2, 2)
    with mesh.fake_group(shape.size):
        want = _counted(mesh.device_mesh(shape), "glm4-9b")
    assert ranks["counted"] == want
    assert want["prefill"]["all-reduce"] > 0
    assert want["train"]["reduce-scatter"] > 0
