#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (also printed as a line of their own);
2. build   -- every CUDA kernel built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together),
   timed as set-up;
3. check   -- each kernel held against its plain PyTorch version on the
   card over a sweep of shapes: traversal and split gain with
   ``torch.equal`` (bit-identical; NaN rows, passthrough padding trees,
   out-of-range feature ids, empty bins, NaN gains); the histogram
   (direct and child mode) with ``torch.equal`` on integer-valued g/h,
   whose float sums are exact in any order below 2^24, and within
   ``ref.hist_rounding_bound`` (twice the worst-case float32 error of a
   sum of the bucket's rows) on real g/h, since atomics add in no fixed
   order, child mode's row counts with ``torch.equal``; the exact inputs
   that phase 4 times are checked too;
4. time    -- each kernel timed with CUDA events at the shape its path
   gives it (serving: 4096 rows x 32 features, 25 trees of depth 6;
   training: 1M rows x 28 features, 32 nodes, 33 bins, one level),
   beside the plain version, one library call where one computes the
   same function, and the least time the card could take (bound);
5. serve   -- the serving entry point (``serve_gbdt.main``) on the
   500 trees x depth 6 x 32 features (k = 32) synthetic forest, 32
   requests of 4096 rows, raw and binned; the launch count is reset just
   before each run and read just after, and must be 20 per request;
   margins and bin ids checked bit for bit against the same model on the
   CPU, NaN rows included; a profile of raw requests by kernel;
6. train   -- ``repro_torch.fit(device="cuda")`` on the higgs-like
   ``gaussian_classification`` (28 features, 1M training rows, 100k held
   out; HIGGS has 11M rows, the one cut), ``GBDTConfig(n_trees=20,
   max_depth=6, n_candidates=32)``, direct and ``subtract=True``; the
   launch counts are reset just before each fit and read just after, and
   must be max_depth histogram and max_depth split-gain launches a tree;
   fit wall-clock, first and last train logloss, holdout accuracy
   through the traversal kernel, and a profile of a fit by kernel;
7. train_check -- a 4000 x 6 fit (6 trees, depth 4, k = 16) on the card
   and on the CPU from one injected grid, direct and subtract: structure
   exact, leaves within 1e-5;
8. kernels -- one line listing every ported kernel with its launches,
   error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits non-zero before any result.  Every check raises on failure.
"""

import dataclasses
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

# training: higgs-like rows (HIGGS has 28 features and 11M rows)
TRAIN_ROWS, HOLDOUT_ROWS, TRAIN_FEATURES = 1_000_000, 100_000, 28
TRAIN_TREES, TRAIN_DEPTH, TRAIN_CANDIDATES = 20, 6, 32
TRAIN_NODES = 2 ** (TRAIN_DEPTH - 1)          # frontier width
TRAIN_BINS = TRAIN_CANDIDATES + 1


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


def bound_ms(nbytes, ops) -> tuple[float, str]:
    """The least time of a launch: its bytes at the HBM rate against its
    float32 operations at the card's rate; the larger bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traverse_bound_ms(n, f, C, depth) -> tuple[float, str]:
    """Each input read once and the output written once, against one
    compare per (row, tree, level)."""
    n_inner = 2 ** depth - 1
    nbytes = 4 * (n * f + 2 * C * n_inner + C * (n_inner + 1) + n * C)
    return bound_ms(nbytes, n * C * depth)


def hist_bound_ms(bins, node, n_nodes, nbins, child) -> tuple[float, str]:
    """What these inputs need: every node id read once; the bin ids and
    g/h of the rows that add (every valid row; in child mode the rows
    routed left), two adds per (level, row, feature) and, in child mode,
    one count; the panel (and the counts) written once."""
    n, f = bins.shape
    L = node.shape[0]
    adds = (node >= 0) & (node % 2 == 0) if child else (
        (node >= 0) & (node < n_nodes))
    rows_read = int(adds.any(dim=0).sum())
    per_bucket = 12 if child else 8
    nbytes = (4 * L * n + rows_read * (4 * f + 8)
              + per_bucket * L * n_nodes * f * nbins)
    return bound_ms(nbytes, (3 if child else 2) * int(adds.sum()) * f)


def split_gain_bound_ms(rows, nbins) -> tuple[float, str]:
    """The histogram read once and (gain, bin) written once, against ~14
    float operations a bin (two prefix adds, two subtractions, two
    scores of three operations, the gain's four)."""
    return bound_ms(8 * rows * nbins + 8 * rows, 14 * rows * nbins)


def hist_case(gen, *, n, f, nbins, n_nodes, L, child):
    """Bin ids, node ids with masked (-1) rows (child frontier ids in
    child mode), integer-valued g/h and real g/h, made on the card."""
    dev = "cuda"
    bins = torch.randint(0, nbins, (n, f), generator=gen, device=dev,
                         dtype=torch.int32)
    hi = 2 * n_nodes if child else n_nodes
    node = torch.randint(-1, hi, (L, n), generator=gen, device=dev,
                         dtype=torch.int32)
    gh_int = torch.randint(-3, 4, (n, 2), generator=gen,
                           device=dev).to(torch.float32)
    gh_real = torch.randn((n, 2), generator=gen, device=dev)
    for gh in (gh_int, gh_real):
        gh[:, 1].abs_()
    return bins, node, gh_int, gh_real


def gain_case(gen, n_nodes, f, nbins):
    """A histogram with 30 % empty bins and an all-empty node."""
    h = torch.randn((n_nodes, f, nbins, 2), generator=gen, device="cuda")
    h[..., 1].abs_()
    empty = torch.rand((n_nodes, f, nbins), generator=gen,
                       device="cuda") < 0.3
    h[empty] = 0.0
    h[0] = 0.0
    return h


def by_kernel(prof, per: int, key: str, ops: bool = False) -> list[dict]:
    """Device time of each kernel of a profile, per ``key`` unit; with
    ``ops``, of each host op (``aten::sum``, ...) by the kernels it
    launched itself."""
    want = (torch.autograd.DeviceType.CPU if ops
            else torch.autograd.DeviceType.CUDA)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != want:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if ops and not dev_us:
            continue
        rows.append({"name": ev.key[:60], "count": ev.count,
                     f"device_us_per_{key}": dev_us / per})
    rows.sort(key=lambda r: -r[f"device_us_per_{key}"])
    return rows


def logloss(margin, y) -> float:
    return float(torch.nn.functional.binary_cross_entropy_with_logits(
        margin, y))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 1

    from repro_torch import GBDTConfig, accuracy, fit
    from repro_torch.core import proposal, tree as tree_lib
    from repro_torch.data import tabular
    from repro_torch.kernels import _build, hist, ref, split_gain, traverse
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

    # 3. check + 4. time -----------------------------------------------------
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    hist_err = {False: 0.0, True: 0.0}
    err_share = {False: 0.0, True: 0.0}   # largest |kernel - plain| / bound

    def check_hist(child, bins, node, gh_int, gh_real, *, n_nodes, nbins,
                   case):
        """The kernel against its plain version: equal on integer g/h (or
        on none, given None), within the rounding bound on real g/h; in
        child mode the row counts equal."""
        kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
        plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
        kw = dict(n_nodes=n_nodes, nbins=nbins)
        shape = (node.shape[0], n_nodes, bins.shape[1], nbins)
        for gh in (gh_int, gh_real):
            if gh is None:
                continue
            got = kernel(bins, node, gh, **kw)
            want = plain(bins, node, gh, **kw)
            torch.cuda.synchronize()
            if child:
                check(torch.equal(got[1], want[1]),
                      f"hist kernel's row counts != plain version's ({case})")
                got, want = got[0], want[0]
            check(got.shape == shape + (2,),
                  f"hist output {tuple(got.shape)}, {case}")
            if gh is gh_int:
                check(torch.equal(got, want), f"hist kernel != plain "
                      f"version on integer g/h ({case})")
                continue
            bound = ref.hist_rounding_bound(bins, node, gh, child=child, **kw)
            diff = (got.double() - want.double()).abs()
            torch.cuda.synchronize()
            check(bool((diff <= bound).all()),
                  f"hist kernel beyond the rounding bound on real g/h "
                  f"({case}, max_abs_err={float(diff.max())})")
            hist_err[child] = max(hist_err[child], float(diff.max()))
            nz = bound > 0
            if bool(nz.any()):
                err_share[child] = max(err_share[child],
                                       float((diff[nz] / bound[nz]).max()))

    n_hist_cases = 0
    for child in (False, True):
        for n in (1, 4097, TRAIN_ROWS):
            for f in (1, TRAIN_FEATURES):
                for nbins in (2, TRAIN_BINS, 257):
                    for L in (1, TRAIN_DEPTH):
                        # 16: the parent panel of the subtraction fit
                        for n_nodes in ((1, TRAIN_NODES // 2, TRAIN_NODES)
                                        if child else (1, TRAIN_NODES)):
                            bins, node, gh_int, gh_real = hist_case(
                                gen, n=n, f=f, nbins=nbins, n_nodes=n_nodes,
                                L=L, child=child)
                            check_hist(
                                child, bins, node, gh_int, gh_real,
                                n_nodes=n_nodes, nbins=nbins,
                                case=f"child={child} n={n} f={f} "
                                     f"nbins={nbins} L={L} n_nodes={n_nodes}")
                            n_hist_cases += 1

    gain_err = 0.0

    def check_gain(h, case, **kw):
        """The kernel against its plain version, bit for bit: gains (NaN
        where NaN, -inf where -inf) and bins."""
        nonlocal gain_err
        g, i = split_gain.split_gain_cuda(h, **kw)
        gw, iw = ref.split_gain_ref(h, **kw)
        torch.cuda.synchronize()
        both = (g == gw) | (torch.isnan(g) & torch.isnan(gw))
        diff = torch.where(both, 0.0, (g - gw).abs().nan_to_num(float("inf")))
        err = float(diff.max()) if diff.numel() else 0.0
        gain_err = max(gain_err, err)
        check(bool(both.all()) and torch.equal(i, iw),
              f"split_gain kernel != plain version ({case}, params={kw}, "
              f"max_abs_err={err})")

    n_gain_cases = 0
    params = [(1.0, 0.0, 1e-6), (1.0, 0.1, 1.0), (0.0, 0.0, 0.0),
              (0.5, 0.3, 0.5)]
    for n_nodes, f in ((1, 1), (5, 3), (TRAIN_NODES, TRAIN_FEATURES)):
        for nbins in (1, 2, 9, TRAIN_BINS, 65, 257):
            h = gain_case(gen, n_nodes, f, nbins)
            for l2, gamma, mcw in params:
                check_gain(h, f"n_nodes={n_nodes}, f={f}, nbins={nbins}",
                           l2=l2, gamma=gamma, min_child_weight=mcw)
                n_gain_cases += 1

    # the training shape: the deepest level of a depth-6 tree (every row
    # in one of 32 nodes); child mode as the subtraction fit calls it:
    # a panel of 16 parents, about half the rows routed left, with counts
    train_timing = {}
    for child in (False, True):
        n_nodes = TRAIN_NODES // 2 if child else TRAIN_NODES
        bins, _, _, gh = hist_case(gen, n=TRAIN_ROWS, f=TRAIN_FEATURES,
                                   nbins=TRAIN_BINS, n_nodes=1, L=1,
                                   child=False)
        node = torch.randint(0, TRAIN_NODES, (1, TRAIN_ROWS), generator=gen,
                             device="cuda", dtype=torch.int32)
        kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
        plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
        kw = dict(n_nodes=n_nodes, nbins=TRAIN_BINS)
        # the inputs timed here, held against the plain version first
        check_hist(child, bins, node, None, gh, **kw,
                   case=f"the timed training shape, child={child}")
        n_hist_cases += 1
        ms, issue_ms = cuda_ms(lambda: kernel(bins, node, gh, **kw), iters=50)
        plain_ms, _ = cuda_ms(lambda: plain(bins, node, gh, **kw), iters=5,
                              warmup=2)
        # the library call: one index_add_ over the precomputed flat index
        # (in child mode of [g, h, 1], the counts riding as a third column)
        adds = ((node[0] % 2 == 0) if child else (node[0] >= 0))
        key = (((node[0].long() // 2 if child else node[0].long())[:, None]
                * TRAIN_FEATURES
                + torch.arange(TRAIN_FEATURES, device="cuda")[None, :])
               * TRAIN_BINS + bins.long())[adds].reshape(-1)
        cols = torch.cat([gh, torch.ones_like(gh[:, :1])], 1) if child else gh
        vals = cols[adds][:, None, :].expand(
            -1, TRAIN_FEATURES, cols.shape[1]).reshape(
            -1, cols.shape[1]).contiguous()
        size = n_nodes * TRAIN_FEATURES * TRAIN_BINS
        library_ms, _ = cuda_ms(lambda: torch.zeros(
            (size, cols.shape[1]), device="cuda").index_add_(0, key, vals),
            iters=20, warmup=3)
        b_ms, b_by = hist_bound_ms(bins, node, n_nodes, TRAIN_BINS, child)
        train_timing[child] = dict(ms=ms, issue_ms=issue_ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=b_ms, bound_by=b_by)
        if not child:
            panel = kernel(bins, node, gh, **kw)[0]
    emit("check", kernel="hist_levels", cases=n_hist_cases,
         integer_gh_equal=True, real_gh_within_bound=True,
         left_counts_equal=True,
         max_abs_err={"direct": hist_err[False], "left": hist_err[True]},
         max_err_over_bound={"direct": err_share[False],
                             "left": err_share[True]})
    check_gain(panel, "the timed training panel")
    emit("check", kernel="split_gain", cases=n_gain_cases + 1, equal=True,
         max_abs_err=gain_err)
    emit("time", kernel="hist_levels",
         shape=dict(n=TRAIN_ROWS, f=TRAIN_FEATURES, n_nodes=TRAIN_NODES,
                    nbins=TRAIN_BINS, levels=1, left_panel_nodes=
                    TRAIN_NODES // 2),
         direct=train_timing[False], left=train_timing[True])

    ms, issue_ms = cuda_ms(lambda: split_gain.split_gain_cuda(panel),
                           iters=200)
    plain_ms, _ = cuda_ms(lambda: ref.split_gain_ref(panel), iters=20)
    b_ms, b_by = split_gain_bound_ms(TRAIN_NODES * TRAIN_FEATURES, TRAIN_BINS)
    gain_timing = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit("time", kernel="split_gain",
         shape=dict(n_nodes=TRAIN_NODES, f=TRAIN_FEATURES, nbins=TRAIN_BINS),
         **gain_timing)

    # 5. serve ------------------------------------------------------------
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
    rows = by_kernel(prof, 4, "request")
    t0 = time.perf_counter()
    for _ in range(4):
        model.predict(x_dev, output="margin")
    torch.cuda.synchronize()
    emit("profile", requests=4, binned=False,
         wall_ms_per_request=(time.perf_counter() - t0) / 4 * 1e3,
         device_us_per_request=sum(r["device_us_per_request"] for r in rows),
         by_kernel=rows[:8])

    # 6. train ------------------------------------------------------------
    x, y = tabular.gaussian_classification(TRAIN_ROWS + HOLDOUT_ROWS,
                                           TRAIN_FEATURES, seed=0)
    x_dev, y_dev = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    x_tr, y_tr = x_dev[:TRAIN_ROWS], y_dev[:TRAIN_ROWS]
    x_ho, y_ho = x_dev[TRAIN_ROWS:], y_dev[TRAIN_ROWS:]
    counters = (hist, "launches"), (hist, "left_launches"), \
        (split_gain, "launches"), (traverse, "launches")

    def reset():
        for mod, name in counters:
            setattr(mod, name, 0)

    def read():
        return [getattr(mod, name) for mod, name in counters]

    train_launches = {}
    forests = {}
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, subtract=subtract)
        # warm-up: the allocator's first growth and the first launches
        fit(x_tr, y_tr, dataclasses.replace(cfg, n_trees=1),
            torch.Generator(device="cuda").manual_seed(1), device="cuda")
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        model = fit(x_tr, y_tr, cfg,
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
        wall = time.perf_counter() - t0
        n_hist, n_left, n_gain, n_trav = read()
        per_fit = TRAIN_TREES * TRAIN_DEPTH
        check((n_left if subtract else n_hist) == per_fit
              and (n_hist if subtract else n_left) == 0
              and n_gain == per_fit and n_trav == 0,
              f"subtract={subtract}: launches hist {n_hist}, hist_left "
              f"{n_left}, split_gain {n_gain}, traverse {n_trav}; want "
              f"{per_fit} of the fit's histogram mode and {per_fit} "
              "split_gain")
        train_launches[subtract] = dict(hist=n_left if subtract else n_hist,
                                        split_gain=n_gain)
        forests[subtract] = model.forest
        check(all(bool(torch.isfinite(a).all()) for a in
                  (model.forest.leaf_value, model.candidates)),
              f"subtract={subtract}: non-finite leaves or candidates")
        first = dataclasses.replace(model, forest=tree_lib.Forest(
            *(a[:1] for a in model.forest)))
        loss_first = logloss(first.predict(x_tr, output="margin"), y_tr)
        loss_last = logloss(model.predict(x_tr, output="margin"), y_tr)
        traverse.launches = 0
        acc = accuracy(model, x_ho, y_ho)
        check(traverse.launches > 0, "holdout predict launched no traversal")
        check(loss_last < loss_first and acc > 0.6,
              f"subtract={subtract}: logloss {loss_first} -> {loss_last}, "
              f"holdout accuracy {acc}")
        emit("train", subtract=subtract, rows=TRAIN_ROWS,
             holdout_rows=HOLDOUT_ROWS, features=TRAIN_FEATURES,
             n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
             n_candidates=TRAIN_CANDIDATES, reduced=["rows: 11M -> 1M"],
             fit_seconds=wall, model_fit_seconds=model.fit_seconds,
             ms_per_round=wall / TRAIN_TREES * 1e3,
             launches=dict(hist_levels=n_hist, hist_levels_left=n_left,
                           split_gain=n_gain),
             train_logloss_first=loss_first, train_logloss_last=loss_last,
             holdout_accuracy=acc, holdout_traverse_launches=traverse.launches)
    same = float((forests[False].feature == forests[True].feature)
                 .to(torch.float32).mean())

    # where a fit's device time goes, by kernel and by host op
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=2, max_depth=TRAIN_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, subtract=subtract)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fit(x_tr, y_tr, cfg,
                torch.Generator(device="cuda").manual_seed(0), device="cuda")
        rows = by_kernel(prof, cfg.n_trees, "round")
        t0 = time.perf_counter()
        fit(x_tr, y_tr, cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        wall_ms = (time.perf_counter() - t0) / cfg.n_trees * 1e3
        busy_ms = sum(r["device_us_per_round"] for r in rows) / 1e3
        emit("train_profile", rounds=cfg.n_trees, subtract=subtract,
             wall_ms_per_round=wall_ms, device_ms_per_round=busy_ms,
             device_idle_share=1 - busy_ms / wall_ms, by_kernel=rows[:10],
             by_op=by_kernel(prof, cfg.n_trees, "round", ops=True)[:12])
    emit("train_compare", direct_vs_subtract_same_features=same)

    # 7. train_check --------------------------------------------------------
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4000, 6)).astype(np.float32)
    ys = (xs @ rng.normal(size=6) > 0).astype(np.float32)
    g_cpu = torch.Generator().manual_seed(0)
    grid = torch.stack([proposal.random_candidates(
        g_cpu, torch.from_numpy(xs), 16) for _ in range(6)])
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                         subtract=subtract)
        on_card = fit(xs, ys, cfg, candidates=grid, device="cuda").forest
        on_cpu = fit(xs, ys, cfg, candidates=grid, device="cpu").forest
        leaf_err = float((on_card.leaf_value.cpu() - on_cpu.leaf_value)
                         .abs().max())
        check(torch.equal(on_card.feature.cpu(), on_cpu.feature)
              and torch.equal(on_card.split_bin.cpu(), on_cpu.split_bin)
              and torch.equal(on_card.threshold.cpu(), on_cpu.threshold)
              and leaf_err <= 1e-5,
              f"subtract={subtract}: the card's forest differs from the "
              f"CPU's (leaf max_abs_err={leaf_err})")
        emit("train_check", subtract=subtract, rows=4000, features=6,
             n_trees=6, max_depth=4, n_candidates=16, structure_equal=True,
             leaf_max_abs_err=leaf_err)

    # 8. kernels ----------------------------------------------------------
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
    for child, name, line in ((False, "hist_levels", 65),
                              (True, "hist_levels_left", 123)):
        t = train_timing[child]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hist.cu",
            "replaces": f"src/repro/kernels/hist.py:{line}",
            "launches": train_launches[child]["hist"],
            "launches_per_tree": TRAIN_DEPTH,
            "max_abs_err": hist_err[child],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    kernels.append({
        "name": "split_gain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/split_gain.cu",
        "replaces": "src/repro/kernels/split_gain.py:51",
        "launches": sum(v["split_gain"] for v in train_launches.values()),
        "launches_per_tree": TRAIN_DEPTH,
        "max_abs_err": gain_err,
        "ms": gain_timing["ms"],
        "plain_ms": gain_timing["plain_ms"],
        "bound_ms": gain_timing["bound_ms"],
        "bound_by": gain_timing["bound_by"],
        "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
