#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (also printed as a line of their own);
2. build   -- every CUDA kernel built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, timed as set-up;
3. check   -- each kernel held against its plain PyTorch version on the
   card with ``torch.equal`` (bit-identical), raw and binned, with NaN
   rows, passthrough padding trees and out-of-range feature ids, over a
   sweep of shapes; then
   timed at the serving shape with CUDA events, beside the plain version;
4. serve   -- the serving entry point (``serve_gbdt.main``) on the
   500 trees x depth 6 x 32 features (k = 32) synthetic forest, 32
   requests of 4096 rows, raw and binned; the launch count is reset just
   before each run and read just after, and must be 20 per request;
   margins and bin ids checked bit for bit against the same model on the
   CPU, NaN rows included; a profile of raw requests by kernel;
5. kernels -- one line listing every ported kernel with its launches,
   error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits non-zero before any result.  Every check raises on failure.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores

TREES, DEPTH, FEATURES, CANDIDATES = 500, 6, 32, 32
MICROBATCH, REQUESTS, WARMUP_REQUESTS, TREE_CHUNK = 4096, 32, 2, 25


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 10) -> tuple[float, float]:
    """Time ``iters`` back-to-back calls of ``fn()`` with CUDA events.

    Returns (device ms, issue ms) per call.  For the device time the
    stream is first held by a ~0.2 s spin kernel while the host queues
    every call, so the events bracket the kernels alone and not the
    host's launch overhead; the issue time is the same loop with the
    stream free, where a call that is shorter than its launch waits on
    the host.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for hold in (True, False):
        torch.cuda.synchronize()
        if hold:
            torch.cuda._sleep(400_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out[0], out[1]


def make_chunk(rng, *, n, C, depth, binned, f=FEATURES, k=CANDIDATES,
               out_of_range=False, device="cuda"):
    """A random tree chunk and rows in the mode's dtype, with passthrough
    nodes, passthrough zero-leaf padding trees (the last C // 8) and, on
    the raw path, NaN cells and a NaN row; ``out_of_range`` puts feature
    ids past the last feature and below -1 into every third node."""
    n_inner = 2 ** depth - 1
    feature = rng.integers(0, f, size=(C, n_inner)).astype(np.int32)
    passthrough = rng.random(size=(C, n_inner)) < 0.15
    leaf = rng.normal(size=(C, n_inner + 1)).astype(np.float32)
    pad = C // 8
    if binned:
        values = rng.integers(0, k + 1, size=(n, f)).astype(np.int32)
        cmp = rng.integers(0, k, size=(C, n_inner)).astype(np.int32)
        cmp[passthrough] = k
        pad_cmp = 2 ** 20
    else:
        values = rng.normal(size=(n, f)).astype(np.float32)
        values[::7, 5] = np.nan
        values[n // 2, :] = np.nan
        cmp = rng.normal(size=(C, n_inner)).astype(np.float32)
        cmp[passthrough] = np.inf
        pad_cmp = np.inf
    feature[passthrough] = -1
    if out_of_range:
        feature[:, ::3] = rng.integers(f, f + 8, size=feature[:, ::3].shape)
        feature[:, 1::6] = -3
    if pad:
        feature[C - pad:] = -1
        cmp[C - pad:] = pad_cmp
        leaf[C - pad:] = 0.0
    return tuple(torch.from_numpy(a).to(device)
                 for a in (values, feature, cmp, leaf))


def traverse_bound_ms(n, f, C, depth) -> tuple[float, str]:
    """Least time of one traversal launch: each input read once and the
    output written once at the HBM rate, against one compare per
    (row, tree, level) at the float32 rate; the larger bounds it."""
    n_inner = 2 ** depth - 1
    nbytes = 4 * (n * f + 2 * C * n_inner + C * (n_inner + 1) + n * C)
    ops = n * C * depth
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 1

    from repro_torch.kernels import _build, ref, traverse
    from repro_torch.launch import serve_gbdt

    # 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit("device", kind=kind, nvidia_smi=smi_line,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in
                    (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in libs}
    emit("build", seconds=time.perf_counter() - t0, libraries=sorted(libs),
         ptxas=ptxas)

    # 3. check + time -----------------------------------------------------
    rng = np.random.default_rng(0)
    cases = [(binned, n, C, depth, False) for binned in (False, True)
             for n in (1, 4095, 4096, 50_000) for C in (1, 25)
             for depth in (1, 6)]
    cases += [(binned, 4096, 25, 0, False) for binned in (False, True)]
    cases += [(binned, 4096, 25, 6, True) for binned in (False, True)]
    max_err = {False: 0.0, True: 0.0}
    for binned, n, C, depth, out_of_range in cases:
        args = make_chunk(rng, n=n, C=C, depth=depth, binned=binned,
                          out_of_range=out_of_range)
        out = traverse.traverse_chunk_cuda(*args, max_depth=depth)
        exp = ref.traverse_chunk_ref(*args, max_depth=depth)
        torch.cuda.synchronize()
        check(out.shape == (n, C) and out.dtype == torch.float32,
              f"traverse output {tuple(out.shape)} {out.dtype}")
        err = float((out - exp).abs().max())
        max_err[binned] = max(max_err[binned], err)
        check(torch.equal(out, exp),
              f"traverse kernel != plain version (binned={binned}, n={n}, "
              f"C={C}, depth={depth}, out_of_range={out_of_range}, "
              f"max_abs_err={err})")
    emit("check", kernel="traverse_chunk", cases=len(cases),
         equal=True, max_abs_err={"f32": max_err[False],
                                  "i32": max_err[True]})

    timing = {}
    for binned in (False, True):
        args = make_chunk(rng, n=MICROBATCH, C=TREE_CHUNK, depth=DEPTH,
                          binned=binned)
        ms, issue_ms = cuda_ms(lambda: traverse.traverse_chunk_cuda(
            *args, max_depth=DEPTH), iters=500)
        plain_ms, plain_issue_ms = cuda_ms(lambda: ref.traverse_chunk_ref(
            *args, max_depth=DEPTH), iters=100)
        bound_ms, bound_by = traverse_bound_ms(MICROBATCH, FEATURES,
                                               TREE_CHUNK, DEPTH)
        timing[binned] = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                              plain_issue_ms=plain_issue_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    emit("time", kernel="traverse_chunk",
         shape=dict(n=MICROBATCH, f=FEATURES, C=TREE_CHUNK, depth=DEPTH),
         f32=timing[False], i32=timing[True])

    # 4. serve ------------------------------------------------------------
    argv = ["--device", "cuda", "--trees", str(TREES), "--depth", str(DEPTH),
            "--features", str(FEATURES), "--candidates", str(CANDIDATES),
            "--microbatch", str(MICROBATCH), "--requests", str(REQUESTS)]
    per_request = -(-TREES // TREE_CHUNK)
    launches = {}
    for binned in (False, True):
        traverse.launches = 0
        report = serve_gbdt.main(argv + (["--binned"] if binned else []))
        launches[binned] = traverse.launches
        check(launches[binned] == per_request * (REQUESTS + WARMUP_REQUESTS),
              f"binned={binned}: {launches[binned]} traversal launches for "
              f"{REQUESTS + WARMUP_REQUESTS} requests, want {per_request} "
              "per request")
        emit("serve", binned=binned, launches=launches[binned],
             launches_per_request=per_request, engine=report.engine,
             summary=report.summarize())

    model = serve_gbdt.synthetic_gbdt(
        n_trees=TREES, max_depth=DEPTH, n_features=FEATURES,
        n_candidates=CANDIDATES, seed=0, device="cuda")
    cpu_model = model.to("cpu")
    # the first request of serve(seed=0), and the same rows with NaNs
    xb = np.random.default_rng(0).normal(
        size=(MICROBATCH, FEATURES)).astype(np.float32)
    x_nan = xb.copy()
    x_nan[::97, 3] = np.nan
    x_nan[7, :] = np.nan
    for name, x in (("first_request", xb), ("nan_rows", x_nan)):
        bins = model.bin_features(x)
        check(torch.equal(bins.cpu(), cpu_model.bin_features(x)),
              f"{name}: bin ids differ from the CPU's")
        for binned in (False, True):
            m = model.predict(x, output="margin", binned=binned)
            m_cpu = cpu_model.predict(x, output="margin", binned=binned)
            check(m.shape == (MICROBATCH,) and bool(torch.isfinite(m).all()),
                  f"{name}: margins not finite of shape ({MICROBATCH},)")
            check(torch.equal(m.cpu(), m_cpu),
                  f"{name} binned={binned}: margins differ from the CPU "
                  f"model's (max_abs_err="
                  f"{float((m.cpu() - m_cpu).abs().max())})")
    emit("serve_check", margins_equal_cpu=True, bin_ids_equal_cpu=True,
         rows=MICROBATCH, nan_rows=True)

    # where a raw request's device time goes, by kernel
    x_dev = torch.from_numpy(xb).cuda()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            model.predict(x_dev, output="margin")
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue          # host ops; their kernels are listed below
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append({"name": ev.key[:60], "count": ev.count,
                     "device_us_per_request": dev_us / 4})
    rows.sort(key=lambda r: -r["device_us_per_request"])
    t0 = time.perf_counter()
    for _ in range(4):
        model.predict(x_dev, output="margin")
    torch.cuda.synchronize()
    emit("profile", requests=4, binned=False,
         wall_ms_per_request=(time.perf_counter() - t0) / 4 * 1e3,
         device_us_per_request=sum(r["device_us_per_request"] for r in rows),
         by_kernel=rows[:8])

    # 5. kernels ----------------------------------------------------------
    kernels = []
    for binned, suffix in ((False, "f32"), (True, "i32")):
        kernels.append({
            "name": f"traverse_chunk_{suffix}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/traverse.cu",
            "replaces": "src/repro/kernels/traverse.py:73",
            "launches": launches[binned],
            "launches_per_request": per_request,
            "max_abs_err": max_err[binned],
            "ms": timing[binned]["ms"],
            "plain_ms": timing[binned]["plain_ms"],
            "bound_ms": timing[binned]["bound_ms"],
            "bound_by": timing[binned]["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
