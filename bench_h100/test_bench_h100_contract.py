"""``BENCHMARK.json`` against the benchmark's contract, the files it names,
and what ``run.py`` does without a card or without the program."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert BENCH["paths"] == ["bench_h100"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + \
        [m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
        [c["source"] for c in BENCH["configs"]] + \
        [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        # every key cut from the source is named, with why
        assert sorted(c["reduced"]) == sorted(conf.get("reduced", {}))
        assert conf["rows"] >= conf["train_rows"] + conf["test_rows"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        cell = harness.load_cell(w["name"])
        assert cell["traffic"]["kind"] in ("fit", "score")
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        assert set(cell["limits"]) and all(
            v >= 0 for v in cell["limits"].values())
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in WORKLOADS
            assert w in e2e[m["moves"]].get("workloads", WORKLOADS)
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in METRICS:
        assert (ROOT / "bench_h100" / "metrics" / f"{m['name']}.py").exists()
        assert callable(harness.reader(m["name"]))


def test_environment_fixes_caches_inside_the_checkout(monkeypatch, tmp_path):
    names = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
             "PYTORCH_KERNEL_CACHE_PATH", "CUDA_CACHE_PATH",
             "PYTORCH_CUDA_ALLOC_CONF")
    for name in names:       # restored by monkeypatch after the test
        monkeypatch.setenv(name, "unset")
    harness.environment(tmp_path)
    for name in names[:-1]:
        path = Path(os.environ[name])
        assert path.is_relative_to(tmp_path / "build"), (name, path)
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
        "expandable_segments:True"


def test_run_seconds_fit_the_check_with_24_cells():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def _run(cwd, *extra, timeout=120):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", WORKLOADS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_run_without_a_card_gives_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_with_only_the_benchmark_files_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_unknown_workload_gives_no_result():
    p = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", "no.such.cell",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


IMPORT_CHECK = r"""
import sys
sys.path[:0] = [{root!r}, {src!r}]
from bench_h100 import harness, workloads
import repro_torch.core.boosting, repro_torch.checkpoint
for name in {metrics!r}:
    harness.reader(name)
bad = harness.forbidden_modules()
print("FORBIDDEN", bad)
"""

REFERENCE_CHECK = r"""
import sys
sys.path[:0] = [{root!r}]
from bench_h100 import compare, counts, forest, reference, synth
print("PROGRAM", sorted(m for m in sys.modules
                        if m.split(".")[0] == "repro_torch"))
"""


def test_run_imports_neither_jax_nor_the_jax_package():
    code = IMPORT_CHECK.format(root=str(ROOT), src=str(ROOT / "src"),
                               metrics=[m["name"] for m in METRICS])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "FORBIDDEN []" in p.stdout


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "reprox", "jax_utils", "torch"]
    ) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.tree", "jax.numpy", "jaxlib", "flax.linen"]
    ) == ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.tree"]


def test_reference_imports_nothing_of_the_program():
    code = REFERENCE_CHECK.format(root=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "PROGRAM []" in p.stdout
    for name in ("reference.py", "compare.py", "synth.py", "forest.py",
                 "counts.py"):
        tree = ast.parse((ROOT / "bench_h100" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module or ""]
                for m in mods:
                    assert m.split(".")[0] not in (
                        "repro_torch", "repro", "jax", "jaxlib", "flax"), \
                        (name, m)
