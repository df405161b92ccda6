"""The port's serving entry point against the JAX package's.

``synthetic_gbdt`` draws from ``default_rng(seed)`` in the JAX package's
order, so both packages build the same forest array for array; the
serving CLI at a tiny shape on the CPU returns a ``PredictReport/v1``
whose summary has the JAX report's keys.
"""

import json

import numpy as np
import pytest
import torch

from repro.launch import serve_gbdt as jserve
from repro_torch.launch import serve_gbdt
from repro_torch.obs import PredictReport

TINY = ["--trees", "7", "--depth", "3", "--features", "5",
        "--candidates", "6", "--microbatch", "33", "--requests", "3"]


@pytest.mark.parametrize("seed,passthrough_frac", [(0, 0.1), (7, 0.25)])
def test_synthetic_gbdt_same_arrays(seed, passthrough_frac):
    kw = dict(n_trees=11, max_depth=4, n_features=6, n_candidates=8,
              seed=seed, passthrough_frac=passthrough_frac)
    jm = jserve.synthetic_gbdt(**kw)
    tm = serve_gbdt.synthetic_gbdt(device="cpu", **kw)
    for name in ("feature", "split_bin", "threshold", "leaf_value"):
        want = np.asarray(getattr(jm.forest, name))
        got = getattr(tm.forest, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert np.array_equal(tm.candidates.numpy(), np.asarray(jm.candidates))
    assert tm.config.__dict__ == jm.config.__dict__
    assert tm.base_score == jm.base_score


@pytest.mark.parametrize("binned", [False, True])
def test_serve_main_report_matches_reference_schema(binned, tmp_path):
    flags = ["--binned"] if binned else []
    path = str(tmp_path / "report.json")
    report = serve_gbdt.main(TINY + flags + ["--device", "cpu",
                                             "--json", path])
    want = jserve.main(TINY + flags).summarize()
    got = report.summarize()
    assert isinstance(report, PredictReport)
    assert got.keys() == want.keys()
    assert got["latency_ms"].keys() == want["latency_ms"].keys()
    assert got["n_requests"] == 3 and got["rows_per_request"] == 33
    assert report.engine["binned"] is binned
    assert report.engine["device"] == "cpu"
    rec = json.loads(open(path).read())
    assert rec["schema"] == "repro.obs.PredictReport/v1"
    assert len(rec["latencies_s"]) == 3


def test_serve_checkpoint_of_the_reference(tmp_path):
    """--ckpt serves a checkpoint that the JAX package wrote."""
    from repro.checkpoint import save_gbdt
    path = str(tmp_path / "m.npz")
    save_gbdt(path, jserve.synthetic_gbdt(n_trees=4, max_depth=2,
                                          n_features=3, n_candidates=4))
    report = serve_gbdt.main(["--ckpt", path, "--device", "cpu",
                              "--microbatch", "8", "--requests", "2",
                              "--binned"])
    assert report.engine["n_trees"] == 4 and report.engine["n_features"] == 3


def test_cuda_default_raises_without_gpu():
    """Entry points run on the card unless asked for the CPU; with no GPU
    they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gbdt.synthetic_gbdt(n_trees=2, max_depth=2, n_features=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gbdt.main(TINY)


def test_report_summary_numbers():
    r = PredictReport(latencies_s=np.array([0.01, 0.03]),
                      rows_per_request=100, engine={})
    s = r.summarize()
    assert s["rows_per_s"] == pytest.approx(200 / 0.04)
    assert s["latency_ms"]["max"] == pytest.approx(30.0)
    with pytest.raises(ValueError):
        PredictReport(np.array([]), 1, {}).summarize()
