"""The port's meta dry-run, roofline, report and hillclimb
(``repro_torch.launch.{dryrun, roofline, specs, report, hillclimb}``)
against the JAX package's on the CPU.

Parameter counts, 6ND, the decode windows and cache lengths, the input
and decode-state stand-ins, ``parse_override`` and the report tables must
equal the JAX package's exactly.  The JAX parameter trees come from
``steps.train_state_shapes`` (``jax.eval_shape``, no allocation); the JAX
dry-run itself is not run.  The counter is held to its own definitions at
SMOKE sizes: flash attention counted as the causal band, the 1- and
2-unit extrapolation equal to the full count, FLOPs equal to
``FlopCounterMode``'s, the peak following the live storages.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro.launch import report as jax_report
from repro.launch import roofline as jax_roofline
from repro.launch import specs as jax_specs
from repro.launch import steps as jax_steps
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro_torch.checkpoint.npz import flat_state
from repro_torch.configs import INPUT_SHAPES as TORCH_SHAPES
from repro_torch.configs import InputShape
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import dryrun, hillclimb, report, roofline, \
    shardings, specs
from repro_torch.launch import mesh as torch_mesh
from repro_torch.launch import steps as torch_steps
from repro_torch.models.sharding import logical_rules
from repro_torch.obs import PredictReport, TrainReport
from repro_torch.optim import AdamWConfig

# the JAX hillclimb imports the JAX dry-run, which sets XLA_FLAGS (512 host
# devices) when imported; no JAX backend starts here, and the flag is put
# back before one does
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import hillclimb as jax_hillclimb  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_params(arch):
    return jax_steps.train_state_shapes(get_config(arch),
                                        JaxAdamWConfig())[0]


def _port_leaves(arch):
    model, _ = torch_steps.train_state_shapes(torch_config(arch),
                                              AdamWConfig())
    return shardings.param_leaves(model.named_parameters())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_model_flops_match_jax(arch):
    """count_params and count_active_params exact at full CONFIG, and
    model_flops, decode_window and cache_len at every shape."""
    jp, leaves = _jax_params(arch), _port_leaves(arch)
    jcfg, cfg = get_config(arch), torch_config(arch)
    n, na = jax_roofline.count_params(jp), \
        jax_roofline.count_active_params(jcfg, jp)
    assert roofline.count_params(leaves) == n
    assert roofline.count_active_params(cfg, leaves) == na
    for name, shape in INPUT_SHAPES.items():
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        assert roofline.model_flops(cfg, n, na, tokens, shape.kind) == \
            jax_roofline.model_flops(jcfg, n, na, tokens, shape.kind), name
        assert specs.decode_window(cfg, shape) == \
            jax_specs.decode_window(jcfg, shape), name
        assert specs.cache_len(cfg, shape) == \
            jax_specs.cache_len(jcfg, shape), name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_and_decode_state_specs_match_jax(arch):
    """input_specs and decode_state_specs: the same shapes and dtypes, the
    decode state on the meta device under the JAX package's paths."""
    jcfg, cfg = get_config(arch), torch_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got = specs.input_specs(cfg, shape)
        want = jax_specs.input_specs(jcfg, shape)
        assert sorted(got) == sorted(want), name
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape, (name, k)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (name, k)
        if shape.kind != "decode" or not cfg.supports_shape(name):
            continue
        state = flat_state(specs.decode_state_specs(cfg, shape))
        jstate = {jax_roofline_path(p): l for p, l in
                  jax.tree_util.tree_flatten_with_path(
                      jax_specs.decode_state_specs(jcfg, shape))[0]}
        assert sorted(k.replace("#", "") for k in state) == sorted(jstate)
        for k, t in state.items():
            j = jstate[k.replace("#", "")]
            assert t.device.type == "meta"
            assert tuple(t.shape) == j.shape, (name, k)
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype), k


def jax_roofline_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def test_parse_override_matches_jax():
    for s in ["train_microbatches=1", "seq_shard=False", "remat=True",
              "capacity_factor=1.5", "moe_dispatch=sort", "lr=3e-4",
              "name=a=b", "x=-2", "y=1e3", "z=true", "w="]:
        assert hillclimb.parse_override(s) == jax_hillclimb.parse_override(s)
        got = hillclimb.parse_override(s)[1]
        assert type(got) is type(jax_hillclimb.parse_override(s)[1]), s


def _records():
    """Records that carry the JAX dry-run's fields and the port's with the
    same meaning (state = argument bytes, peak - state = temp bytes)."""
    recs = []
    for i, (arch, shape) in enumerate([("glm4-9b", "train_4k"),
                                       ("deepseek-moe-16b", "decode_32k"),
                                       ("xlstm-125m", "prefill_32k")]):
        arg, temp = (i + 1) * 3.3e9, (i + 2) * 7.7e10
        recs.append({
            "arch": arch, "shape": shape, "mesh": "pod16x16",
            "status": "ok", "lower_s": 1.5, "compile_s": 20.25,
            "run_s": 3.5 + i,
            "memory_analysis": {"argument_size_in_bytes": arg,
                                "temp_size_in_bytes": temp},
            "collective_bytes": {"all-reduce": 1e9 * i},
            "state_bytes": arg, "peak_bytes_estimate": arg + temp,
            "fits_one_card": (False, True, None)[i],
            "state_bytes_per_device": {"pod16x16": 2.5e9,
                                       "pod2x16x16": 1.25e9},
            "fsdp": {"pod16x16": i == 2, "pod2x16x16": False},
            "roofline": {"compute_s": 0.0123 * (i + 1),
                         "memory_s": 0.0456 / (i + 1),
                         "collective_s": 0.0007 * i,
                         "dominant": ("memory", "compute")[i % 2]},
            "useful_flops_ratio": 0.5 + 0.1 * i,
            "n_params": 8.77e9 / (i + 1)})
    recs.append({"arch": "whisper-tiny", "shape": "long_500k",
                 "mesh": "pod16x16", "status": "skipped",
                 "reason": "enc-dec full attention: no 500k decode "
                           "(DESIGN.md)"})
    return recs


def _columns(table: str) -> list[dict]:
    rows = [[c.strip() for c in line.strip("|").split("|")]
            for line in table.splitlines()]
    head = rows[0]
    return [dict(zip(head, r)) for r in rows[2:]]


def test_report_tables_match_jax():
    """The roofline table is the JAX package's string on the same records;
    the dry-run table's shared columns are the JAX package's cells, the
    collective cell too where the record counts collectives ('-' where it
    has no number)."""
    recs = _records()
    assert report.roofline_table(recs) == jax_report.roofline_table(recs)
    got, want = (_columns(t) for t in (report.dryrun_table(recs),
                                       jax_report.dryrun_table(recs)))
    assert len(got) == len(want) == len(recs)
    shared = (set(got[0]) & set(want[0])) - {"collective bytes/dev"}
    assert shared == {"arch", "shape", "mesh", "status", "arg GB/dev",
                      "temp GB/dev"}
    for g, w, r in zip(got, want, recs):
        assert {k: g[k] for k in shared} == {k: w[k] for k in shared}
        # a pod record's collective bytes as the JAX cell, '-' without
        assert g["collective bytes/dev"] == (
            w["collective bytes/dev"] if "collective_bytes" in r else "-")
    assert [g["meta run s"] for g in got] == ["3.5", "4.5", "5.5", "0"]
    assert [g["fits 80 GB"] for g in got] == ["no", "yes", "unknown", "-"]
    assert got[2]["state GB/dev pod16x16 / pod2x16x16"] == \
        "2.33 fsdp / 1.16"
    for r in recs:
        if "roofline" in r:
            r["roofline"]["collective_s"] = None
    rows = _columns(report.roofline_table(recs))
    assert [r["collective ms"] for r in rows] == ["-", "-", "-", "-"]
    assert report.fmt_bytes(None) == jax_report.fmt_bytes(None) == "-"
    assert report.fmt_bytes(3 * 2**30) == jax_report.fmt_bytes(3 * 2**30)


def test_telemetry_and_predict_tables_match_jax():
    """Over the summaries the port's obs/ writes (TrainReport,
    PredictReport), the same strings as the JAX package's tables."""
    rng = np.random.default_rng(0)
    cols = {f: torch.tensor(rng.random(5), dtype=torch.float32)
            for f in TrainReport._fields}
    cols["n_splits"] = torch.tensor([7, 6, 7, 5, 7], dtype=torch.int32)
    tel = {"telemetry": {"summary": TrainReport(**cols).summarize(),
                         "warm_fit_s": 1.25,
                         "overhead_pct_vs_scanned_warm": -3.25},
           "workload": {"n": 100000, "n_trees": 50, "max_depth": 6},
           "scatter_updates": {"direct_total": 1234.0,
                               "subtract_total": 617.0,
                               "reduction_ratio": 2.0}}
    assert report.telemetry_table(tel) == jax_report.telemetry_table(tel)
    del tel["scatter_updates"]
    assert report.telemetry_table(tel) == jax_report.telemetry_table(tel)
    variants = {}
    for name, base in (("forest_sum", 1e6), ("per_tree", 0.0)):
        pr = PredictReport(rng.random(16) * 1e-3, 4096,
                           {"n_trees": 500}, base)
        variants[name] = {"summary": pr.summarize()}
    pred = {"variants": variants,
            "workload": {"n_trees": 500, "max_depth": 6, "rows": 4096,
                         "n_features": 32, "tree_chunk": 25}}
    assert report.predict_table(pred) == jax_report.predict_table(pred)


def _smoke(arch, **kw):
    return dataclasses.replace(torch_config(arch, smoke=True), **kw)


def test_attention_pairs_against_the_mask():
    for sq, sk in [(1, 1), (7, 7), (64, 64), (130, 130), (40, 97)]:
        for causal in (False, True):
            if causal and sq != sk:
                continue
            for window in (0, 1, 5, 64):
                for kv_len in (None, 1, sk // 2, sk):
                    i = np.arange(sq)[:, None]
                    j = np.arange(sk)[None, :]
                    keep = (j < (sk if kv_len is None else kv_len)) & \
                        (i >= 0)
                    if causal:
                        keep = keep & (j <= i)
                    if window:
                        keep = keep & (j > i - window)
                    assert roofline.attention_pairs(
                        sq, sk, causal=causal, window=window,
                        kv_len=kv_len) == int(keep.sum()), \
                        (sq, sk, causal, window, kv_len)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_attention_counted_as_the_causal_band(kind):
    """Every flash call of a SMOKE dense step counted as the kernel does
    it: S(S+1)/2 pairs a head, 4d operations forward, 10d backward; with
    remat each layer's forward twice in training; its bytes as the
    kernel's bound reckons them."""
    cfg = _smoke("glm4-9b", n_layers=3)
    b, s = 2, 640
    fn, args = dryrun.build_step(cfg, InputShape("x", s, b, kind))
    c = roofline.count_step(fn, *args)
    attn = c["attention"]
    fwd = cfg.n_layers * (2 if kind == "train" else 1)
    bwd = cfg.n_layers if kind == "train" else 0
    assert (attn["forward_calls"], attn["backward_calls"]) == (fwd, bwd)
    d, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    pairs = b * hq * s * (s + 1) // 2
    assert attn["flops"] == pairs * d * (4 * fwd + 10 * bwd)
    assert attn["flops"] < (4 * fwd + 10 * bwd) * b * hq * s * s * d
    assert attn["bytes"] == 2 * d * (b * hq * s + b * hkv * s) * (
        2 * fwd + 4 * bwd)


@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "internvl2-1b", "whisper-tiny"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_unit_extrapolation_equals_the_full_count(arch, kind):
    """c1 + (n - 1)(c2 - c1) equals the full count exactly for a uniform
    stack of 3 units (every family; SMOKE widths)."""
    cfg = torch_config(arch, smoke=True)
    shape = InputShape("x", 32, 2, kind)
    c1, c2, full = (dryrun.count_cost(dryrun._delta_cfg(cfg, n), shape)
                    for n in (1, 2, 3))
    assert full["flops"] > 0 and full["bytes"] > 0
    assert {k: c1[k] + 2 * (c2[k] - c1[k]) for k in c1} == full


@pytest.mark.parametrize("arch,kind", [("glm4-9b", "train"),
                                       ("deepseek-moe-16b", "prefill"),
                                       ("zamba2-2.7b", "train"),
                                       ("glm4-9b", "decode")])
def test_flops_are_flop_counter_modes(arch, kind):
    """The aten FLOPs equal FlopCounterMode's over the same run, and the
    float32 share (decode attention, the scans) is part of them."""
    shape = InputShape("x", 512 if kind != "decode" else 64, 2, kind)
    fn, args = dryrun.build_step(_smoke(arch), shape)
    c = roofline.count_step(fn, *args)
    fn, args = dryrun.build_step(_smoke(arch), shape)
    with FlopCounterMode(display=False) as fc, \
            roofline._kernel_attention(roofline.StepCounter([])):
        fn(*args)
    assert c["flops"] - c["attention"]["flops"] == fc.get_total_flops()
    assert 0 <= c["flops_float32"] <= c["flops"]
    if kind == "decode" or arch == "zamba2-2.7b":
        assert c["flops_float32"] > 0


def test_peak_follows_the_live_storages():
    """The peak is the most bytes the run made that were alive at once;
    the arguments are the state, views and in-place results add
    nothing."""
    x = torch.empty(1000, dtype=torch.float32, device="meta")
    n = 4000

    def step(x):
        a = x * 2                     # a
        b = a[::2] * 3                # a, b (500 elements)
        del a
        c = b.view(10, 50) + 1        # b, c
        c.add_(1)
        x.mul_(2)
        return c

    got = roofline.count_step(step, x)
    assert got["state_bytes"] == n
    assert got["peak_bytes"] == n + n // 2
    assert got["peak_bytes_estimate"] == n + n + n // 2
    assert got["bytes"] == 2 * n + (n // 2) * 2 + (n // 2) * 2 + \
        (n // 2) * 2 + 2 * n
    assert got["flops"] == 0


def test_train_state_fits_one_card():
    """glm4-9b's float32 train state (params, m, v) does not fit one 80 GB
    card; internvl2-1b's does."""
    def state(arch):
        return roofline.state_bytes(torch_steps.train_state_shapes(
            torch_config(arch), AdamWConfig()))
    assert state("glm4-9b") > roofline.CARD_BYTES
    assert state("internvl2-1b") <= roofline.CARD_BYTES
    assert state("internvl2-1b") == 12 * 494583808 + 4


def test_fits_one_card_leaves_the_margin():
    """Yes up to (1 - PEAK_MARGIN) x 80 GB, no above 80 GB, unknown
    between."""
    edge = (1 - roofline.PEAK_MARGIN) * roofline.CARD_BYTES
    assert roofline.PEAK_MARGIN == 0.25 and edge == 60e9
    assert roofline.fits_one_card(0) is True
    assert roofline.fits_one_card(edge) is True
    assert roofline.fits_one_card(edge + 1) is None
    assert roofline.fits_one_card(roofline.CARD_BYTES) is None
    assert roofline.fits_one_card(roofline.CARD_BYTES + 1) is False


def test_roofline_terms():
    t = roofline.roofline_terms({"flops": 989e12 + 67e12,
                                 "flops_float32": 67e12,
                                 "bytes accessed": 3.35e12})
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] is None and t["dominant"] == "compute"
    assert roofline.roofline_terms({"bytes accessed": 1.0})["dominant"] == \
        "memory"


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "glm4-9b", "--shape", "decode_32k", "--out-dir", str(out)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


def test_cli_writes_an_ok_record(cli_run):
    out = cli_run
    (path,) = out.glob("*.json")
    assert path.name == "glm4-9b__decode_32k__h100x1.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec.get("error")
    jp = _jax_params("glm4-9b")
    assert rec["n_params"] == jax_roofline.count_params(jp)
    for k in ("n_active_params", "model_flops", "flops", "bytes_accessed",
              "state_bytes", "peak_bytes_estimate", "fits_one_card",
              "roofline", "useful_flops_ratio"):
        assert k in rec, k
    assert sorted(rec["state_bytes_per_device"]) == ["pod16x16",
                                                     "pod2x16x16"]
    assert "delta_detail" not in rec
    assert rec["roofline"]["collective_s"] is None
    assert rec["fits_one_card"] is False      # 128 x 32 768 bf16 K/V


def test_cli_report_and_hillclimb(cli_run, tmp_path, monkeypatch, capsys):
    """The report's and hillclimb's command lines over the record; hillclimb
    --fast with no override gives a zero change, its 1-unit count that of
    the 1-unit config."""
    out = cli_run
    monkeypatch.setattr(sys, "argv", ["report", "--dir", str(out)])
    report.main()
    table = capsys.readouterr().out
    assert "| glm4-9b | decode_32k | h100x1 | ok |" in table
    assert "**memory**" in table
    monkeypatch.setattr(sys, "argv", [
        "hillclimb", "--arch", "glm4-9b", "--shape", "decode_32k", "--tag",
        "same", "--fast", "--baseline-dir", str(out), "--out-dir",
        str(tmp_path)])
    hillclimb.main()
    assert "(+0.0%)" in capsys.readouterr().out
    rec = json.loads((tmp_path / "glm4-9b__decode_32k__same.json")
                     .read_text())
    assert rec["c1"] == rec["baseline_c1"] == dryrun.count_cost(
        dryrun._delta_cfg(torch_config("glm4-9b"), 1),
        TORCH_SHAPES["decode_32k"])


# --------------------------------------------------------------------------
# The sharded pass: the step under the plan, meta tensors in a fake group
# of a 2 x 2 (data, model) mesh (test_dryrun_mini.py's mesh and shapes).
# --------------------------------------------------------------------------

DEBUG_MESH = torch_mesh.make_debug_mesh(2, 2)
MINI_SHAPES = {"train_4k": InputShape("train_4k", 256, 8, "train"),
               "decode_32k": InputShape("decode_32k", 512, 8, "decode"),
               # one decode row, which the data axis splits unevenly
               "decode_row": InputShape("decode_row", 512, 1, "decode")}


@pytest.mark.parametrize("shape", list(MINI_SHAPES))
@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-moe-16b", "xlstm-125m",
                                  "zamba2-2.7b", "whisper-tiny"])
def test_sharded_mini_dryrun(arch, shape):
    """test_dryrun_mini.py's combos: every op's placement resolves
    (status ok), a dominant term among the three, FLOPs counted; the
    collective term is the counted bytes over the inter-node rate."""
    rec = dryrun.run_sharded(arch, shape, DEBUG_MESH,
                             cfg=torch_config(arch, smoke=True),
                             shape=MINI_SHAPES[shape], verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "pod2x2"
    rf = rec["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert sorted(rec["collective_bytes"]) == sorted(roofline.COLLECTIVES)
    assert rf["collective_s"] == sum(rec["collective_bytes"].values()) / \
        roofline.INTERNODE_BYTES_PER_S


def test_merged_pod_axes_against_three_dims():
    """The multi-pod mesh applied with 'pod' and 'data' as one DTensor dim
    (mesh.MERGED), against the same plan on a three-dim DeviceMesh, a 2 x
    2 x 2 (pod, data, model) dense train step: the same FLOPs, and no
    collective kind moves more bytes (on three dims DTensor reduces one
    dim at a time and gathers a batch split twice before a reshape)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = torch_mesh.MeshShape(("pod", "data", "model"),
                                 {"pod": 2, "data": 2, "model": 2})
    cfg = _smoke("glm4-9b", train_microbatches=2)
    step = InputShape("x", 64, 8, "train")
    merged = dryrun.count_sharded(cfg, step, shape)
    real = torch_mesh.device_mesh
    with pytest.MonkeyPatch.context() as mp:
        def three_dims(mesh, device_type="cuda"):
            dm = init_device_mesh(device_type, (2, 2, 2),
                                  mesh_dim_names=mesh.axis_names)
            dm.plan_shape = mesh
            return dm
        mp.setattr(dryrun, "device_mesh", three_dims)
        three = dryrun.count_sharded(cfg, step, shape)
    assert dryrun.device_mesh is real
    assert (merged["flops"], merged["flops_float32"]) == \
        (three["flops"], three["flops_float32"])
    assert all(merged["coll"][k] <= three["coll"][k]
               for k in roofline.COLLECTIVES)
    assert 0 < merged["coll"]["reduce-scatter"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_twice_the_batch_devices_move_no_more_bytes_a_device(arch, kind):
    """The ssm and hybrid steps at 2 x 2 x 2 (pod, data, model) against 2
    x 2: twice the batch devices halve each device's rows, so no
    collective kind moves more bytes a device, and the FLOPs a device
    fall (the recurrent layers' residual stream pinned as a decoder block
    leaves it; without the pin DTensor moves the batch onto 'model' and
    back, and xlstm-125m's train step moves more a device at 2 x 16 x 16
    than at 16 x 16)."""
    cfg = _smoke(arch)
    step = InputShape("x", 64, 8, kind)
    pods = torch_mesh.MeshShape(("pod", "data", "model"),
                                {"pod": 2, "data": 2, "model": 2})
    one, two = (dryrun.count_sharded(cfg, step, m)
                for m in (DEBUG_MESH, pods))
    assert all(two["coll"][k] <= one["coll"][k]
               for k in roofline.COLLECTIVES), (one["coll"], two["coll"])
    assert sum(two["coll"].values()) < sum(one["coll"].values())
    assert two["flops"] < one["flops"]


@pytest.mark.parametrize("n_heads,mine", [(8, 2), (6, 2), (3, 1)])
def test_a_device_counts_its_share_of_the_heads(n_heads, mine):
    """On a 1 x 4 (data, model) mesh the flash calls that rank 0 counts
    are its share of the query heads, ceil(H / 4) of H, whether or not 4
    divides H (XLA pads an uneven split; DTensor leaves the last ranks
    fewer or none): a device's attention work, not every head's."""
    cfg = _smoke("glm4-9b", n_heads=n_heads, n_kv_heads=1,
                 attn_impl="pallas")
    shape = InputShape("x", 128, 4, "prefill")
    fn, args = dryrun.build_step(cfg, shape)
    whole = roofline.count_step(fn, *args)["attention"]["flops"]
    four = torch_mesh.make_debug_mesh(1, 4)
    with torch_mesh.fake_group(four.size):
        dm = torch_mesh.device_mesh(four)
        fn, args, rules = dryrun.build_sharded(cfg, shape, dm)
        with logical_rules(rules, dm):
            got = roofline.count_step(fn, *args)["attention"]["flops"]
    assert whole > 0 and got * n_heads == whole * mine


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_a_device_counts_its_share_of_the_vocabulary(kind):
    """A vocabulary that 'model' does not divide (the plan leaves the
    table whole) still splits the logits: on a 1 x 4 mesh rank 0 makes
    ceil(510 / 4) = 128 columns, as many as of 512 words, so the FLOPs a
    device are the same."""
    four = torch_mesh.make_debug_mesh(1, 4)
    shape = InputShape("x", 64, 4, kind)
    even, uneven = (dryrun.count_sharded(_smoke("glm4-9b", vocab_size=v),
                                         shape, four)
                    for v in (512, 510))
    assert uneven["flops"] == even["flops"] > 0


def _block(cfg, kind, seq=64, batch=4) -> dict:
    """The collective bytes one more unit adds to the sharded step."""
    c1, c2 = (dryrun.count_sharded(dryrun._delta_cfg(cfg, n),
                                   InputShape("x", seq, batch, kind),
                                   DEBUG_MESH)["coll"] for n in (1, 2))
    return {k: c2[k] - c1[k] for k in c1}


def _none_but(**kinds) -> dict:
    return {k: kinds.get(k.replace("-", "_"), 0)
            for k in roofline.COLLECTIVES}


def test_dense_block_all_reduces_its_two_row_parallel_outputs():
    """A dense block's prefill moves two all-reduces of its (rows, seq,
    d_model) bf16 output, at the constraints after attention and after
    the MLP (the JAX package's model.py:119 and :127), and nothing
    else."""
    cfg = _smoke("glm4-9b")
    rows = 4 // DEBUG_MESH.shape["data"]
    assert _block(cfg, "prefill") == _none_but(
        all_reduce=2 * rows * 64 * cfg.d_model * 2)


def test_dense_block_reduce_scatters_its_zero1_gradients():
    """With train_microbatches = 2 each microbatch's gradient of every
    block parameter whose AdamW moments are split over 'data' (ZeRO-1) is
    reduce-scattered there once: its local float32 bytes, twice."""
    cfg = _smoke("glm4-9b", train_microbatches=2)
    with torch_mesh.fake_group(DEBUG_MESH.size):
        dm = torch_mesh.device_mesh(DEBUG_MESH)
        model, opt = torch_steps.train_state_shapes(
            dryrun._delta_cfg(cfg, 1), AdamWConfig())
        shardings.shard_model(model, dm, cfg)
        opt = shardings.shard_opt_state(opt, dm, cfg)
        data = dm.mesh_dim_names.index("data")
        zero1 = [p.to_local().numel() * 4
                 for n, p in model.named_parameters()
                 if n.startswith("layers.0.")
                 and opt["m"][n].placements[data].is_shard()]
    assert len(zero1) >= 7                  # the block's matrices, scales
    assert _block(cfg, "train")["reduce-scatter"] == 2 * sum(zero1)


def test_moe_block_dispatch_moves_no_bytes():
    """Under the plan's placements (tokens whole on every 'model' rank,
    experts split over it) each rank fills and runs its own experts'
    slots, and adds their outputs into the block's pending sum: a moe
    block's prefill moves the dense block's two all-reduces and the
    load-balance loss's two (E,) float32 means, no all-to-all."""
    cfg = _smoke("deepseek-moe-16b")
    rows = 4 // DEBUG_MESH.shape["data"]
    assert _block(cfg, "prefill") == _none_but(
        all_reduce=2 * rows * 64 * cfg.d_model * 2 + 2 * cfg.n_experts * 4)


def test_moe_train_under_seq_shard_counts_all_to_all():
    """deepseek-moe-16b trains with seq_shard (its CONFIG): the sequence
    split of the residual stream meets the heads' and the shared experts'
    split on 'model', one all-to-all each way."""
    assert torch_config("deepseek-moe-16b").seq_shard
    cfg = _smoke("deepseek-moe-16b", seq_shard=True)
    c = dryrun.count_sharded(cfg, InputShape("x", 64, 4, "train"),
                             DEBUG_MESH)
    assert c["coll"]["all-to-all"] > 0
    assert dryrun.count_sharded(_smoke("deepseek-moe-16b"), InputShape(
        "x", 64, 4, "train"), DEBUG_MESH)["coll"]["all-to-all"] == 0


@pytest.mark.parametrize("arch,kind", [("glm4-9b", "train"),
                                       ("deepseek-moe-16b", "prefill"),
                                       ("zamba2-2.7b", "train"),
                                       ("internvl2-1b", "prefill"),
                                       ("whisper-tiny", "decode")])
def test_sharded_unit_extrapolation_equals_the_full_count(arch, kind):
    """c1 + 2(c2 - c1) equals the sharded count of a 3-unit stack
    exactly: FLOPs, bytes and collective bytes by kind (in the ssm and
    hybrid families too, whose recurrent layers leave the residual stream
    placed as a decoder block does)."""
    cfg = _smoke(arch)
    shape = InputShape("x", 64, 4, kind)
    c1, c2, full = (dryrun.count_sharded(dryrun._delta_cfg(cfg, n), shape,
                                         DEBUG_MESH)
                    for n in (1, 2, 3))
    assert full["flops"] > 0
    assert dryrun._extrapolate(c1, c2, 2) == full


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_slstm_loop_extrapolation_equals_the_full_count(kind):
    """The sLSTM loop counted at 3 and 4 tokens and extrapolated to the
    sequence equals the count of the whole loop (every token step the
    same; the first and last apart, in both counted runs), and the whole
    method (units from the first, and the loop) that of a 4-unit
    stack."""
    cfg = _smoke("xlstm-125m")
    shape = InputShape("x", 64, 4, kind)
    full = dryrun.count_sharded(cfg, shape, DEBUG_MESH)
    a, b = (dryrun.count_sharded(cfg, shape, DEBUG_MESH, slstm_steps=k)
            for k in dryrun.SLSTM_STEPS)
    assert a != b and dryrun._extrapolate(a, b, 64 - 3) == full
    four = dryrun._delta_cfg(cfg, 4)
    assert dryrun.measure_sharded(four, shape, DEBUG_MESH) == \
        dryrun.count_sharded(four, shape, DEBUG_MESH)


def test_cli_writes_pod_records(tmp_path, monkeypatch, capsys):
    """``--both-meshes`` writes a record at each pod mesh; pod16x16's has
    the collective bytes, a numeric collective term and a device's
    counts, and the report prints them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "glm4-9b", "--shape", "decode_32k", "--both-meshes", "--out-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert sorted(recs) == ["glm4-9b__decode_32k__pod16x16.json",
                            "glm4-9b__decode_32k__pod2x16x16.json"]
    one, two = (recs[f"glm4-9b__decode_32k__{m}.json"]
                for m in ("pod16x16", "pod2x16x16"))
    assert one["status"] == two["status"] == "ok"
    assert one["roofline"]["collective_s"] > 0
    assert one["flops"] > 0 and "roofline" not in two
    assert two["collective_bytes"]["all-reduce"] > 0
    monkeypatch.setattr(sys, "argv", ["report", "--dir", str(tmp_path)])
    report.main()
    out = capsys.readouterr().out
    coll = f"{sum(one['collective_bytes'].values()):.3g}"
    assert f"| glm4-9b | decode_32k | pod16x16 | ok |" in out
    assert f"| {coll} |" in out
    assert f"{one['roofline']['collective_s'] * 1e3:.2f}" in out
