"""The reduction of a device trace: launches traced back to the program's
modules, busy time, idle gaps named by the host's work."""

import pytest

from bench_h100 import devtrace, harness, workloads


def _events():
    win = {"name": devtrace.WINDOW, "cat": "user_annotation", "ts": 100.0,
           "dur": 1000.0, "tid": 7}
    fit = {"name": "/c/src/repro_torch/core/boosting.py(250): _fit",
           "cat": "python_function", "ts": 100.0, "dur": 990.0, "tid": 7}
    binning = {"name": "/c/src/repro_torch/core/binning.py(20): bin_features",
               "cat": "python_function", "ts": 110.0, "dur": 50.0, "tid": 7}
    grow = {"name": "/c/src/repro_torch/core/tree.py(140): build_tree",
            "cat": "python_function", "ts": 200.0, "dur": 300.0, "tid": 7}
    hist = {"name": "/c/src/repro_torch/kernels/hist.py(70): hist_levels_cuda",
            "cat": "python_function", "ts": 210.0, "dur": 20.0, "tid": 7}
    sync = {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime",
            "ts": 600.0, "dur": 480.0, "tid": 7}
    launches = [
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 120.0,
         "dur": 5.0, "tid": 7, "args": {"correlation": 1}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 215.0,
         "dur": 5.0, "tid": 7, "args": {"correlation": 2}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 590.0,
         "dur": 5.0, "tid": 7, "args": {"correlation": 3}},
    ]
    kernels = [
        {"name": "elementwise_kernel<gt>", "cat": "kernel", "ts": 130.0,
         "dur": 100.0, "args": {"correlation": 1}},
        {"name": "_Z11hist_kernelPKiS0_", "cat": "kernel", "ts": 230.0,
         "dur": 200.0, "args": {"correlation": 2}},
        # runs past the window's end: clipped to it
        {"name": "add_kernel", "cat": "kernel", "ts": 1000.0, "dur": 300.0,
         "args": {"correlation": 3}},
    ]
    return [win, fit, binning, grow, hist, sync, *launches, *kernels]


def test_attribution_busy_and_gaps():
    t = devtrace.reduce_events(_events())
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((100 + 200 + 100) * 1e-6)
    mods = {a.name: a.modules for a in t.activities}
    assert mods["elementwise_kernel<gt>"] == ("core/binning.py",
                                              "core/boosting.py")
    assert mods["_Z11hist_kernelPKiS0_"] == (
        "kernels/hist.py", "core/tree.py", "core/boosting.py")
    assert mods["add_kernel"] == ("core/boosting.py",)
    assert devtrace.innermost_core(mods["_Z11hist_kernelPKiS0_"]) == \
        "core/tree.py"
    # gaps: 100-130 (_fit), 430-1000 (the host waits in the sync at 600+)
    assert sum(t.idle_by_host.values()) == pytest.approx(600e-6)
    assert t.idle_by_host["cudaDeviceSynchronize"] == pytest.approx(570e-6)
    assert t.top_ops(1)[0][0] == "_Z11hist_kernelPKiS0_"


def test_layer_readers_on_a_trace():
    t = devtrace.reduce_events(_events())
    run = workloads.Run(kind="fit", trace=t, traced_rounds=1)
    assert harness.reader("bin_ms")(run) == pytest.approx(0.1)
    assert harness.reader("grow_ms")(run) == pytest.approx(0.2)
    assert harness.reader("propose_ms")(run) == pytest.approx(0.0)
    assert harness.reader("idle_pct.fit")(run) == pytest.approx(60.0)
    assert harness.reader("idle_pct.score")(run) is None


def test_unattributed_trace_leaves_layers_silent():
    events = [e for e in _events() if e.get("cat") != "python_function"]
    t = devtrace.reduce_events(events)
    assert not t.attributed()
    run = workloads.Run(kind="fit", trace=t, traced_rounds=1)
    assert harness.reader("bin_ms")(run) is None
    assert harness.reader("idle_pct.fit")(run) == pytest.approx(60.0)


def test_trace_without_window_raises():
    with pytest.raises(ValueError):
        devtrace.reduce_events([e for e in _events()
                                if e["name"] != devtrace.WINDOW])
