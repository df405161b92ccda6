#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (also printed as a line of their own);
2. build   -- every CUDA kernel built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together),
   timed as set-up; the Hopper flash kernel's registers, spills and any
   ptxas warning about it (``-Xptxas -v``), and the ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA load) instructions in ``cuobjdump -sass`` of
   ``libflash_attention.so``; the atomic instructions in the SASS of
   ``libhist.so`` by kind (native ``ATOMS.ADD`` / ``REDG`` or a
   compare-and-swap loop, ``ATOMS.CAS*``, of which there must be none)
   (the SASS counts are null where ``cuobjdump`` is missing);
3. check   -- each kernel held against its plain PyTorch version on the
   card over a sweep of shapes: traversal and split gain with
   ``torch.equal`` (bit-identical; NaN rows, passthrough padding trees,
   out-of-range feature ids, empty bins, NaN gains); the histogram
   (direct and child mode, up to 257 bins at 32 nodes and 6 levels)
   with ``torch.equal`` against ``ref.hist_levels_fixed`` (the kernel's
   fixed-point arithmetic in plain PyTorch, run on the card) on every
   case, with ``torch.equal`` against the plain version on integer-valued
   g/h, and within ``ref.hist_rounding_bound(..., quantum=ref.
   hist_quanta(gh))`` of it on real g/h (the worst share of the bound is
   printed), child mode's row counts with ``torch.equal``; the exact
   inputs that phase 4 times are checked too.  Each kernel is launched
   twice on one input and the two results held with ``torch.equal``:
   that is its ``deterministic`` flag in the kernels line;
4. time    -- each kernel timed with CUDA events at the shape its path
   gives it (serving: 4096 rows x 32 features, 25 trees of depth 6;
   training: 1M rows x 28 features, 32 nodes, 33 bins, one level),
   beside the plain version, one library call where one computes the
   same function, and the least time the card could take (bound); the
   histogram also beside its fixed-point emulation and the times of the
   float-atomic kernel it replaced (a constant of this script, from the
   kernel table in PERF.md);
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
   train_repeat: the same fit again from the same seed, every forest
   field ``torch.equal`` to the first (the histogram and the leaf sums
   add in fixed point);
7. train_check -- a 4000 x 6 fit (6 trees, depth 4, k = 16) on the card
   and on the CPU from one injected grid, direct and subtract: structure
   exact; leaves within 1e-5 of the CPU's beyond the CPU's own rounding
   (``boosting.leaf_rounding``: the distance of its row-order float32
   leaf sums from the exact sums, which the card's fixed-point sums do
   not share), and the card's leaves within 1e-6 of their exact sums;
   train_vs_cpu (reported, not checked: the
   CPU sums in row order, the card in fixed point, so near-ties may
   split apart): two depth-6 trees at 1M rows from one injected grid on
   the card and on the CPU, the share of equal split features and, at
   each tree's first differing node, the gap between the two choices'
   gains on the CPU's histogram;
8. attn_check -- the flash-attention kernels held against their plain
   version (``ref.attention_ref``) on the card: MHA, GQA and MQA; causal,
   window 128, window 200 (not a tile multiple) and none; head dims 32,
   64, 80, 128; 128 and 384 tokens, and 2048 (16 K/V tiles); ragged
   causal lengths through ``ops.flash_attention(..., ragged=True)`` (the
   ``xla_chunked`` path: padded to a multiple of 128, sliced back): 1000
   and 1500 tokens, GQA, float32 and bf16, and window 200 at 1000, and a
   ragged length with no mask must raise; float32
   within 2e-4 abs and rel (the JAX package's tolerance) and bf16 within
   that plus one bf16 rounding step (2^-7 of the value) plus
   ``ref.attention_rounding_bound`` (the Hopper kernel rounds P to bf16
   before its product with V); and the prefill's own shape, q (2, 32,
   4096, 128), k/v (2, 2, 4096, 128), causal, bf16;
9. attn_time -- the kernel at that shape with CUDA events, beside the
   plain version, ``F.scaled_dot_product_attention`` (the library
   yardstick, never called by the port) and the bound; its TFLOP/s and
   its share of the bound;
10. prefill -- glm4-9b at full width and depth (40 layers, random bf16
   weights from a seeded generator on the card) through
   ``make_prefill_step``: one warm-up request, then 4 requests of 2 x
   4096 tokens; p50 ms, tokens/s, peak memory, 40 flash launches a
   request, all of the Hopper kernel (counts reset just before, read
   just after), the greedy next token;
11. prefill_profile -- one request's device time by kernel (flash,
   GEMMs, the rest) and the device's idle share;
12. prefill_check -- glm4-9b at full width with 2 layers, 1 x 256 tokens,
   ``attn_impl="pallas"``, the card against the port on the CPU with the
   same weights.  With float32 activations (the same modules, no bf16
   rounding between them) the logits agree within 2e-4 abs and rel.  The
   prefill step itself (bf16) rounds differently on the two sides, so
   each side is measured against the CPU's float32 logits: the card's
   bf16 logits lie within twice the CPU's own bf16 error of the CPU's,
   the card's own error is at most 1.25 times the CPU's, and a position
   whose argmax differs is a near tie (within twice that error in the
   float32 logits); the bf16 step on the Hopper kernel, the float32 one
   on the CUDA-core kernel; and a ragged case, 1 x 1000 tokens through
   ``xla_chunked`` (blockwise, padded on the card), float32 activations,
   card against CPU within 2e-4 abs and rel;
13. kernels -- one line listing every ported kernel with its launches,
   error, times, bound and ``deterministic`` flag (and for flash
   attention the variant and its SASS counts).

The new phases print their seconds.  Precision: float32 matrix products
in full float32 (``allow_tf32`` off) and bf16 products reduced in float32
(``allow_bf16_reduced_precision_reduction`` off), set and printed first.

The last line is ``{"ok": true, "device": {...}}``.  Without a GPU the
script exits non-zero before any result.  Every check raises on failure.
"""

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense

TREES, DEPTH, FEATURES, CANDIDATES = 500, 6, 32, 32
MICROBATCH, REQUESTS, WARMUP_REQUESTS, TREE_CHUNK = 4096, 32, 2, 25

# training: higgs-like rows (HIGGS has 28 features and 11M rows)
TRAIN_ROWS, HOLDOUT_ROWS, TRAIN_FEATURES = 1_000_000, 100_000, 28
TRAIN_TREES, TRAIN_DEPTH, TRAIN_CANDIDATES = 20, 6, 32
TRAIN_NODES = 2 ** (TRAIN_DEPTH - 1)          # frontier width
TRAIN_BINS = TRAIN_CANDIDATES + 1

# prefill: glm4-9b; the dry-run's prefill_32k shape (32 x 32768) cut to
# 2 x 4096, since its bf16 logits alone would be 318 GB
LM_ARCH, LM_BATCH, LM_SEQ, LM_REQUESTS = "glm4-9b", 2, 4096, 4
ATTN_F32_TOL = 2e-4               # the JAX package's flash-attention test
BF16_STEP = 2.0 ** -7             # one bf16 rounding: at most 2^-7 of x
SASS_OPS = ("HGMMA", "UTMALDG")   # wgmma and TMA loads in cuobjdump -sass
# the times of the float-atomic histogram kernel this one replaced, direct
# and child mode, at the timed shape (this script on an H100 80GB HBM3 at
# 700 W; PERF.md, kernel table)
REPLACED_HIST_MS = {"direct": 0.3170, "left": 0.2552}


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


def attn_bound_ms(b, hq, hkv, sq, sk, d, itemsize, causal) -> tuple:
    """The unmasked (query, key) pairs at 4d operations each over the
    tensor cores' bf16 rate, against q, k, v read once and o written
    once over the HBM rate."""
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * sk)
    t_ops = pairs * 4 * d / BF16_OPS_PER_S * 1e3
    nbytes = itemsize * d * (2 * b * hq * sq + 2 * b * hkv * sk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_within(got, q, k, v, **mask) -> tuple[bool, float, float]:
    """Kernel against plain version on the same inputs: float32 within
    2e-4 abs and rel; bf16 within that plus one bf16 rounding step of the
    value, since both round a float32 result (of their own order of adds)
    to bf16, plus ``ref.attention_rounding_bound``, since the Hopper
    kernel rounds P to bf16 before its product with V.  Returns (within,
    max abs error, largest share of the tolerance used)."""
    from repro_torch.kernels import ref
    want = ref.attention_ref(q, k, v, **mask).float()
    tol = ATTN_F32_TOL + ATTN_F32_TOL * want.abs()
    if got.dtype == torch.bfloat16:
        tol += BF16_STEP * want.abs() + ref.attention_rounding_bound(
            q, k, v, **mask)
    diff = (got.float() - want).abs()
    return (bool((diff <= tol).all()), float(diff.max()),
            float((diff / tol).max()))


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel (by mangled name) from
    ``-Xptxas -v`` output, and the ptxas warnings that name it
    (``setmaxnreg ignored``, ``wgmma ... serialized``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"warnings": []}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    for line in log.splitlines():
        if "arning" in line or "C75" in line:
            for n in out:
                if n in line:
                    out[n]["warnings"].append(line.strip())
    return out


def sass_text(lib: Path) -> str | None:
    """``cuobjdump -sass`` of ``lib``; None where the toolkit has no
    ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_counts(lib: Path) -> dict | None:
    """Instructions of ``SASS_OPS`` in the SASS of ``lib``."""
    sass = sass_text(lib)
    if sass is None:
        return None
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def sass_atomics(lib: Path) -> dict | None:
    """Atomic instructions in the SASS of ``lib`` by their full opcode
    (``ATOMS.ADD``, ``ATOMS.CAST.SPIN.64``, ``REDG.E.ADD.64...``)."""
    sass = sass_text(lib)
    if sass is None:
        return None
    ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass)
    return {op: ops.count(op) for op in sorted(set(ops))}


def float32_logits(model, cfg, tokens) -> torch.Tensor:
    """The prefill's logits with float32 activations: the same modules and
    weights (bf16 weights widen exactly), no bf16 rounding in between."""
    with torch.inference_mode():
        t = torch.as_tensor(tokens, device=model.embed.table.device)
        x = model.embed(t, dtype=torch.float32)
        positions = torch.arange(t.shape[1], device=x.device).expand(*t.shape)
        x, _ = model.backbone(cfg, x, positions)
        return model.embed.unembed(model.ln_f(x)).float().cpu()


def argmax_agreement(got, want) -> tuple[float, torch.Tensor, torch.Tensor]:
    """Share of positions whose argmax agrees, and where they differ the
    gap in ``want`` between its top token and ``got``'s."""
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    differ = a_got != a_want
    gap = (want.gather(-1, a_want[..., None])
           - want.gather(-1, a_got[..., None]))[..., 0]
    return 1.0 - float(differ.float().mean()), differ, gap


def split_gains64(h, *, l2, gamma, min_child_weight) -> torch.Tensor:
    """(f, nbins) gain of every split bin of a one-node histogram
    (f, nbins, 2), in float64, -inf where illegal: the formula of
    ``ref.split_gain_ref`` without its float32 association."""
    h = h.double()
    gl, hl = h[..., 0].cumsum(-1), h[..., 1].cumsum(-1)
    g, hh = gl[..., -1:], hl[..., -1:]
    gain = 0.5 * (gl ** 2 / (hl + l2) + (g - gl) ** 2 / (hh - hl + l2)
                  - g ** 2 / (hh + l2)) - gamma
    ok = (hl >= min_child_weight) & (hh - hl >= min_child_weight)
    ok[..., -1] = False
    return torch.where(ok, gain, float("-inf"))


def first_difference(card, model, t, x, y) -> dict:
    """Where tree ``t`` of the card's forest first departs from the CPU
    model's (heap order), and how far apart the two choices' gains lie
    there: both evaluated on the CPU's rows and g/h at that node, with the
    CPU's row-order histogram and with the fixed-point one."""
    from repro_torch.core import binning, boosting, tree as tree_lib
    from repro_torch.kernels import ref
    cpu = model.forest
    differ = ((card.feature[t] != cpu.feature[t])
              | (card.split_bin[t] != cpu.split_bin[t]))
    if not bool(differ.any()):
        return {"tree": t, "equal": True}
    i = int(differ.to(torch.uint8).argmax())
    depth = (i + 1).bit_length() - 1
    cfg = model.config
    margin = torch.full((x.shape[0],), model.base_score)
    for s in range(t):
        one = tree_lib.Tree(*(a[s] for a in cpu))
        margin = margin + cfg.learning_rate * tree_lib.predict_raw(
            one, x, max_depth=cfg.max_depth)
    g, h = boosting.grad_hess(margin, y, cfg.objective)
    gh = torch.stack([g, h], 1)
    bins = binning.bin_features(x, model.candidates[min(
        t, model.candidates.shape[0] - 1)])
    node = torch.zeros(x.shape[0], dtype=torch.long)
    for d in range(depth):                 # the same ancestors on both sides
        heap = 2 ** d - 1 + node
        go_left = (torch.gather(bins, 1, cpu.feature[t][heap].clamp(min=0)
                                .long()[:, None])[:, 0]
                   <= cpu.split_bin[t][heap])
        node = 2 * node + (~go_left).long()
    at = torch.where(node == i - (2 ** depth - 1), 0, -1).to(torch.int32)
    kw = dict(l2=cfg.l2, gamma=cfg.gamma,
              min_child_weight=cfg.min_child_weight)
    out = {"tree": t, "equal": False, "heap_node": i, "depth": depth,
           "rows": int((at == 0).sum()),
           "card": [int(card.feature[t][i]), int(card.split_bin[t][i])],
           "cpu": [int(cpu.feature[t][i]), int(cpu.split_bin[t][i])]}
    nbins = model.candidates.shape[-1] + 1
    for name, panel in (
            ("row_order", ref.hist_ref(bins, at, gh, n_nodes=1,
                                       nbins=nbins)[0]),
            ("fixed_point", ref.hist_levels_fixed(bins, at[None], gh,
                                                  n_nodes=1,
                                                  nbins=nbins)[0, 0])):
        gains = split_gains64(panel, **kw)

        def gain(f, b):
            return 0.0 if f < 0 else float(gains[f, b])
        g_cpu, g_card = gain(*out["cpu"]), gain(*out["card"])
        out[f"gain_{name}"] = {"cpu_choice": g_cpu, "card_choice": g_card,
                               "gap": g_cpu - g_card}
    return out


def logloss(margin, y) -> float:
    return float(torch.nn.functional.binary_cross_entropy_with_logits(
        margin, y))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 1

    from repro_torch import GBDTConfig, accuracy, fit
    from repro_torch.core.boosting import leaf_rounding
    from repro_torch.configs import get_config
    from repro_torch.core import proposal, tree as tree_lib
    from repro_torch.data import tabular
    from repro_torch.kernels import _build, hist, ops, ref, split_gain, \
        traverse
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import serve_gbdt
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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
         cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         allow_bf16_reduced_precision_reduction=(
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction))

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(
        (_build.BUILD_DIR / f"{name}.log").read_text()) for name in libs}
    wgmma_ptxas = {k: v for k, v in ptxas["flash_attention"].items()
                   if "flash_kernel_wgmma" in k}
    flash_sass = sass_counts(_build.BUILD_DIR / "libflash_attention.so")
    check(len(wgmma_ptxas) == len(flash.WGMMA_HEAD_DIMS),
          f"ptxas reported {sorted(wgmma_ptxas)}, want one Hopper flash "
          f"kernel a head dim of {flash.WGMMA_HEAD_DIMS}")
    check(flash_sass is None or all(flash_sass[op] > 0 for op in SASS_OPS),
          f"libflash_attention.so lacks wgmma or TMA instructions: "
          f"{flash_sass}")
    hist_atomics = sass_atomics(_build.BUILD_DIR / "libhist.so")
    cas_loops = None if hist_atomics is None else sum(
        c for op, c in hist_atomics.items() if ".CAS" in op)
    check(not cas_loops, f"libhist.so adds with compare-and-swap loops: "
          f"{hist_atomics}")
    emit("build", seconds=build_seconds, libraries=sorted(libs),
         ptxas=ptxas, flash_sass_counts=flash_sass,
         hist_sass_atomics=hist_atomics, hist_cas_loops=cas_loops,
         sass_note=None if flash_sass is not None else
         "cuobjdump not found: SASS not counted")

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
    repeats = {}          # each kernel launched twice on one input
    for binned in (False, True):
        args = make_chunk(rng, n=MICROBATCH, C=TREE_CHUNK, depth=DEPTH,
                          binned=binned, out_of_range=True)
        repeats[f"traverse_{binned}"] = torch.equal(
            traverse.traverse_chunk_cuda(*args, max_depth=DEPTH),
            traverse.traverse_chunk_cuda(*args, max_depth=DEPTH))
    emit("check", kernel="traverse_chunk", cases=len(cases),
         equal=True, max_abs_err={"f32": max_err[False],
                                  "i32": max_err[True]},
         repeat_equal={"f32": repeats["traverse_False"],
                       "i32": repeats["traverse_True"]})

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
        """The kernel against its fixed-point emulation (equal, counts
        too) and against its plain version: equal on integer g/h (or on
        none, given None), within the restated rounding bound on real g/h;
        in child mode the row counts equal."""
        kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
        plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
        kw = dict(n_nodes=n_nodes, nbins=nbins)
        shape = (node.shape[0], n_nodes, bins.shape[1], nbins)
        for gh in (gh_int, gh_real):
            if gh is None:
                continue
            got = kernel(bins, node, gh, **kw)
            emul = ref.hist_levels_fixed(bins, node, gh, **kw, child=child)
            want = plain(bins, node, gh, **kw)
            torch.cuda.synchronize()
            if child:
                check(torch.equal(got[1], want[1])
                      and torch.equal(got[1], emul[1]),
                      f"hist kernel's row counts != plain version's ({case})")
                got, want, emul = got[0], want[0], emul[0]
            check(got.shape == shape + (2,),
                  f"hist output {tuple(got.shape)}, {case}")
            check(torch.equal(got, emul), f"hist kernel != its fixed-point "
                  f"emulation ({case}, max_abs_err="
                  f"{float((got - emul).abs().max())})")
            if gh is gh_int:
                check(torch.equal(got, want), f"hist kernel != plain "
                      f"version on integer g/h ({case})")
                continue
            bound = ref.hist_rounding_bound(bins, node, gh, child=child, **kw,
                                            quantum=ref.hist_quanta(gh))
            diff = (got.double() - want.double()).abs()
            torch.cuda.synchronize()
            check(bool((diff <= bound).all()),
                  f"hist kernel beyond the restated rounding bound on real "
                  f"g/h ({case}, max_abs_err={float(diff.max())})")
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
        # the inputs timed here, held against the plain version first,
        # and the launch repeated: the same bits
        check_hist(child, bins, node, None, gh, **kw,
                   case=f"the timed training shape, child={child}")
        n_hist_cases += 1
        first, again = kernel(bins, node, gh, **kw), kernel(bins, node, gh,
                                                            **kw)
        repeats[f"hist_{child}"] = (
            torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                            again[1])
            if child else torch.equal(first, again))
        check(repeats[f"hist_{child}"], f"hist kernel (child={child}) "
              "differs from itself on a repeated launch")
        del first, again
        ms, issue_ms = cuda_ms(lambda: kernel(bins, node, gh, **kw), iters=50)
        plain_ms, _ = cuda_ms(lambda: plain(bins, node, gh, **kw), iters=5,
                              warmup=2)
        emulation_ms, _ = cuda_ms(lambda: ref.hist_levels_fixed(
            bins, node, gh, **kw, child=child), iters=5, warmup=2)
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
                                   bound_ms=b_ms, bound_by=b_by,
                                   emulation_ms=emulation_ms,
                                   replaced_kernel_ms=REPLACED_HIST_MS[
                                       "left" if child else "direct"])
        if not child:
            panel = kernel(bins, node, gh, **kw)[0]
    emit("check", kernel="hist_levels", cases=n_hist_cases,
         equal_to_fixed_point_emulation=True, integer_gh_equal=True,
         real_gh_within_bound=True, left_counts_equal=True,
         bound="ref.hist_rounding_bound(..., quantum=ref.hist_quanta(gh))",
         repeat_equal={"direct": repeats["hist_False"],
                       "left": repeats["hist_True"]},
         max_abs_err={"direct": hist_err[False], "left": hist_err[True]},
         max_err_over_bound={"direct": err_share[False],
                             "left": err_share[True]})
    check_gain(panel, "the timed training panel")
    repeats["split_gain"] = all(
        torch.equal(a, b) for a, b in zip(split_gain.split_gain_cuda(panel),
                                          split_gain.split_gain_cuda(panel)))
    emit("check", kernel="split_gain", cases=n_gain_cases + 1, equal=True,
         max_abs_err=gain_err, repeat_equal=repeats["split_gain"])
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
        (split_gain, "launches"), (traverse, "launches"), (flash, "launches")

    def reset():
        for mod, name in counters:
            setattr(mod, name, 0)
        for name in flash.launches_by_variant:
            flash.launches_by_variant[name] = 0

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
        n_hist, n_left, n_gain, n_trav, n_flash = read()
        per_fit = TRAIN_TREES * TRAIN_DEPTH
        check((n_left if subtract else n_hist) == per_fit
              and (n_hist if subtract else n_left) == 0
              and n_gain == per_fit and n_trav == 0 and n_flash == 0,
              f"subtract={subtract}: launches hist {n_hist}, hist_left "
              f"{n_left}, split_gain {n_gain}, traverse {n_trav}; want "
              f"{per_fit} of the fit's histogram mode and {per_fit} "
              "split_gain")
        train_launches[subtract] = dict(hist=n_left if subtract else n_hist,
                                        split_gain=n_gain)
        forests[subtract] = model.forest
        # the same fit again from the same seed: the same forest, bit for
        # bit (fixed-point histogram and leaf sums)
        again = fit(x_tr, y_tr, cfg,
                    torch.Generator(device="cuda").manual_seed(0),
                    device="cuda").forest
        equal_fields = {name: torch.equal(a, b) for name, a, b in
                        zip(model.forest._fields, model.forest, again)}
        check(all(equal_fields.values()), f"subtract={subtract}: two fits "
              f"from one seed differ on the card: {equal_fields}")
        emit("train_repeat", subtract=subtract, rows=TRAIN_ROWS,
             n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
             fields_equal=equal_fields)
        del again
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
        card_model = fit(xs, ys, cfg, candidates=grid, device="cuda")
        cpu_model = fit(xs, ys, cfg, candidates=grid, device="cpu")
        on_card, on_cpu = card_model.forest, cpu_model.forest
        # the leaf contract: within 1e-5 of the CPU's leaves beyond the
        # CPU's own rounding (its row-order float32 sums' distance from the
        # exact sums, which the card's fixed-point sums do not share); and
        # the card's leaves within 1e-6 of their own exact sums
        cpu_rounding = leaf_rounding(cpu_model, xs, ys)
        card_rounding = float(leaf_rounding(card_model, xs, ys).max())
        leaf_diff = (on_card.leaf_value.cpu() - on_cpu.leaf_value).abs()
        leaf_err = float(leaf_diff.max())
        check(torch.equal(on_card.feature.cpu(), on_cpu.feature)
              and torch.equal(on_card.split_bin.cpu(), on_cpu.split_bin)
              and torch.equal(on_card.threshold.cpu(), on_cpu.threshold)
              and bool((leaf_diff.double() <= 1e-5 + cpu_rounding).all())
              and card_rounding <= 1e-6,
              f"subtract={subtract}: the card's forest differs from the "
              f"CPU's (leaf max_abs_err={leaf_err}, the CPU's own leaf "
              f"rounding up to {float(cpu_rounding.max())}, the card's "
              f"{card_rounding})")
        emit("train_check", subtract=subtract, rows=4000, features=6,
             n_trees=6, max_depth=4, n_candidates=16, structure_equal=True,
             leaf_max_abs_err=leaf_err,
             leaf_tolerance="1e-5 + the CPU's own leaf rounding",
             cpu_leaf_rounding_max=float(cpu_rounding.max()),
             card_leaf_rounding_max=card_rounding)

    # train_vs_cpu: the training cell's rows, two trees from one grid
    t_phase = time.perf_counter()
    x_cpu, y_cpu = torch.from_numpy(x[:TRAIN_ROWS]), torch.from_numpy(
        y[:TRAIN_ROWS])
    g_cpu = torch.Generator().manual_seed(3)
    grid = torch.stack([proposal.random_candidates(
        g_cpu, x_cpu, TRAIN_CANDIDATES) for _ in range(2)])
    for subtract in (False, True):
        cfg = GBDTConfig(n_trees=2, max_depth=TRAIN_DEPTH,
                         n_candidates=TRAIN_CANDIDATES, subtract=subtract)
        on_card = fit(x_tr, y_tr, cfg, candidates=grid, device="cuda")
        on_cpu = fit(x_cpu, y_cpu, cfg, candidates=grid, device="cpu")
        card_forest = tree_lib.Forest(*(a.cpu() for a in on_card.forest))
        trees = [first_difference(card_forest, on_cpu, t, x_cpu, y_cpu)
                 for t in range(cfg.n_trees)]
        emit("train_vs_cpu", subtract=subtract, rows=TRAIN_ROWS,
             features=TRAIN_FEATURES, n_trees=cfg.n_trees,
             max_depth=TRAIN_DEPTH, n_candidates=TRAIN_CANDIDATES,
             checked=False, same_split_features=float(
                 (card_forest.feature == on_cpu.forest.feature)
                 .to(torch.float32).mean()),
             same_trees=[t["equal"] for t in trees], trees=trees,
             leaf_max_abs_err=float((card_forest.leaf_value
                                     - on_cpu.forest.leaf_value)
                                    .abs().max()),
             seconds=time.perf_counter() - t_phase)

    # 8. attn_check -------------------------------------------------------
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def attn_case(b, hq, hkv, sq, d, dtype):
        return [torch.randn((b, h, sq, d), generator=gen, device="cuda")
                .to(dtype) for h in (hq, hkv, hkv)]

    attn_err = dict.fromkeys(flash.VARIANTS, 0.0)
    attn_share = dict.fromkeys(flash.VARIANTS, 0.0)   # of the tolerance
    cases = [(2, hq, hkv, sq, causal, window)
             for hq, hkv in ((4, 4), (8, 2), (8, 1))   # MHA, GQA, MQA
             for causal, window in ((True, 0), (True, 128), (True, 200),
                                    (False, 0))
             for sq in (128, 384)]
    cases += [(1, 4, 2, 2048, True, 0), (1, 4, 2, 2048, True, 200)]
    n_attn = 0
    for b, hq, hkv, sq, causal, window in cases:
        for d in flash.HEAD_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = attn_case(b, hq, hkv, sq, d, dtype)
                name = flash.variant(dtype, d)
                before = flash.launches_by_variant[name]
                got = flash.flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window)
                torch.cuda.synchronize()
                ok, err, share = attn_within(got, q, k, v, causal=causal,
                                             window=window)
                check(ok and got.dtype == dtype and got.shape == q.shape
                      and flash.launches_by_variant[name] == before + 1,
                      f"flash kernel ({name}) != plain version (heads "
                      f"{hq}:{hkv}, causal={causal}, window={window}, "
                      f"d={d}, s={sq}, {dtype}, max_abs_err={err}, "
                      f"share of tolerance {share})")
                attn_err[name] = max(attn_err[name], err)
                attn_share[name] = max(attn_share[name], share)
                n_attn += 1
    # ragged causal lengths, as xla_chunked's blockwise path gives them:
    # padded to a multiple of 128 around one launch, sliced back
    ragged_err, ragged_share = {}, {}
    for sq, window in ((1000, 0), (1500, 0), (1000, 200)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_case(1, 8, 2, sq, 128, dtype)
            name = flash.variant(dtype, 128)
            before = flash.launches_by_variant[name]
            got = ops.flash_attention(q, k, v, causal=True, window=window,
                                      ragged=True)
            torch.cuda.synchronize()
            ok, err, share = attn_within(got, q, k, v, causal=True,
                                         window=window)
            case = f"s={sq} window={window} {str(dtype)[6:]}"
            check(ok and got.shape == q.shape and got.dtype == dtype
                  and flash.launches_by_variant[name] == before + 1,
                  f"ragged flash ({name}, {case}) != plain version "
                  f"(max_abs_err={err}, share of tolerance {share})")
            ragged_err[case], ragged_share[case] = err, share
            n_attn += 1
    try:
        ops.flash_attention(q, k, v, causal=False, ragged=True)
        raise RuntimeError("chip_smoke: a ragged length with no mask ran "
                           "on the card; it must raise")
    except ValueError as e:
        ragged_refusal = str(e)
    lm_cfg = get_config(LM_ARCH)
    hq, hkv, d = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.head_dim
    q, k, v = attn_case(LM_BATCH, hq, hkv, LM_SEQ, d, torch.bfloat16)
    lm_variant = flash.variant(q.dtype, d)
    check(lm_variant == "wgmma_bf16", f"the prefill's attention would run "
          f"on {lm_variant}, not the Hopper kernel")
    got = flash.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    ok, slice_err, slice_share = attn_within(got, q, k, v, causal=True)
    check(ok, f"flash kernel != plain version at the prefill shape "
          f"(max_abs_err={slice_err}, share of tolerance {slice_share})")
    repeats["flash_attention"] = torch.equal(
        got, flash.flash_attention_cuda(q, k, v, causal=True))
    del got
    emit("attn_check", cases=n_attn + 1, within_tolerance=True,
         tolerance={"f32": {"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL},
                    "bf16": {"abs": ATTN_F32_TOL,
                             "rel": ATTN_F32_TOL + BF16_STEP,
                             "plus": "ref.attention_rounding_bound"}},
         max_abs_err={**attn_err, "prefill_shape_wgmma_bf16": slice_err},
         max_share_of_tolerance={**attn_share,
                                 "prefill_shape_wgmma_bf16": slice_share},
         ragged={"max_abs_err": ragged_err,
                 "share_of_tolerance": ragged_share,
                 "no_mask_raises": ragged_refusal},
         seconds=time.perf_counter() - t_phase)

    # 9. attn_time --------------------------------------------------------
    t_phase = time.perf_counter()
    ms, issue_ms = cuda_ms(lambda: flash.flash_attention_cuda(
        q, k, v, causal=True), iters=10, warmup=2)
    plain_ms, _ = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True),
                          iters=3, warmup=1)
    library_ms, _ = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=10, warmup=2)
    b_ms, b_by = attn_bound_ms(LM_BATCH, hq, hkv, LM_SEQ, LM_SEQ, d, 2, True)
    attn_flops = LM_BATCH * hq * LM_SEQ * (LM_SEQ + 1) // 2 * 4 * d
    attn_timing = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit("attn_time", kernel="flash_attention", variant=lm_variant,
         shape=dict(q=list(q.shape), kv=list(k.shape), causal=True,
                    dtype="bf16"),
         kernel_us=ms * 1e3, **attn_timing,
         tflops=attn_flops / (ms * 1e-3) / 1e12,
         library_tflops=attn_flops / (library_ms * 1e-3) / 1e12,
         share_of_bound=b_ms / ms, seconds=time.perf_counter() - t_phase)
    del q, k, v
    torch.cuda.empty_cache()

    # 10. prefill ---------------------------------------------------------
    t_phase = time.perf_counter()
    model = init_params(lm_cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t_phase
    step = make_prefill_step(lm_cfg)
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, lm_cfg.vocab_size, size=(LM_BATCH, LM_SEQ))
                for _ in range(LM_REQUESTS + 1)]
    torch.cuda.reset_peak_memory_stats()
    live_before = torch.cuda.memory_allocated()        # weights and leftovers
    logits = step(model, {"tokens": requests[0]})       # warm-up
    torch.cuda.synchronize()
    del logits
    walls, next_tokens = [], []
    reset()
    for tokens in requests[1:]:
        t0 = time.perf_counter()
        logits = step(model, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(logits.shape == (LM_BATCH, LM_SEQ, lm_cfg.vocab_size)
              and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} {logits.dtype}, or "
              "not finite")
        next_tokens.append(logits[:, -1].argmax(-1).tolist())
        del logits
    n_hist, n_left, n_gain, n_trav, n_flash = read()
    lm_launches = n_flash
    lm_by_variant = dict(flash.launches_by_variant)
    check(n_flash == lm_cfg.n_layers * LM_REQUESTS
          and lm_by_variant[lm_variant] == n_flash
          and n_hist + n_left + n_gain + n_trav == 0,
          f"{n_flash} flash launches for {LM_REQUESTS} requests ("
          f"{lm_by_variant}), want {lm_cfg.n_layers} a request, all "
          f"{lm_variant} (and no other kernel: hist {n_hist}, hist_left "
          f"{n_left}, split_gain {n_gain}, traverse {n_trav})")
    p50 = float(np.median(walls))
    emit("prefill", arch=LM_ARCH, n_layers=lm_cfg.n_layers,
         d_model=lm_cfg.d_model, n_heads=hq, n_kv_heads=hkv, head_dim=d,
         d_ff=lm_cfg.d_ff, vocab_size=lm_cfg.vocab_size,
         params=sum(p.numel() for p in model.parameters()),
         weights="random bf16, seed 0", batch=LM_BATCH, seq=LM_SEQ,
         reduced=["shape: prefill_32k 32 x 32768 -> 2 x 4096 tokens"],
         requests=LM_REQUESTS, warmup_requests=1, attn_impl=lm_cfg.attn_impl,
         init_seconds=init_seconds, request_ms=[w * 1e3 for w in walls],
         p50_ms=p50 * 1e3, tokens_per_s=LM_BATCH * LM_SEQ / p50,
         memory_allocated_before_gb=live_before / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         flash_launches=n_flash, flash_launches_per_request=n_flash
         / LM_REQUESTS, flash_launches_by_variant=lm_by_variant,
         next_tokens=next_tokens,
         seconds=time.perf_counter() - t_phase)

    # 11. prefill_profile ---------------------------------------------------
    t_phase = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        logits = step(model, {"tokens": requests[1]})
        torch.cuda.synchronize()
    del logits
    rows = by_kernel(prof, 1, "request")
    groups = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for r in rows:
        name = r["name"].lower()
        group = ("flash_attention" if "flash_kernel" in name else "gemm"
                 if any(t in name for t in ("gemm", "xmma", "cutlass",
                                            "nvjet", "sm90")) else "other")
        groups[group] += r["device_us_per_request"] / 1e3
    busy_ms = sum(groups.values())
    emit("prefill_profile", requests=1, wall_ms_per_request=p50 * 1e3,
         device_ms_per_request=busy_ms,
         device_idle_share=1 - busy_ms / (p50 * 1e3),
         by_group_ms=groups,
         by_group_share={g: t / busy_ms for g, t in groups.items()},
         by_kernel=rows[:10], seconds=time.perf_counter() - t_phase)
    del model, prof
    torch.cuda.empty_cache()

    # 12. prefill_check ---------------------------------------------------
    t_phase = time.perf_counter()
    check_cfg = dataclasses.replace(lm_cfg, n_layers=2, attn_impl="pallas")
    model = init_params(check_cfg, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    tokens = rng.integers(0, check_cfg.vocab_size, size=(1, 256))
    step2 = make_prefill_step(check_cfg)
    reset()
    card = step2(model, {"tokens": tokens}).float().cpu()
    card_f32 = float32_logits(model, check_cfg, tokens)
    card_launches = flash.launches
    check_by_variant = dict(flash.launches_by_variant)
    check(card_launches == 2 * check_cfg.n_layers
          and check_by_variant["wgmma_bf16"] == check_cfg.n_layers
          and check_by_variant["cuda_core_f32"] == check_cfg.n_layers,
          f"prefill_check: {card_launches} flash launches on the card "
          f"({check_by_variant}), want {check_cfg.n_layers} a run: the bf16 "
          "run on the Hopper kernel, the float32 one on the CUDA-core one")
    # a ragged length through xla_chunked's blockwise path (1000 x 1000
    # pairs > 512^2), float32 activations: padded to 1024 on the card
    ragged_cfg = dataclasses.replace(check_cfg, attn_impl="xla_chunked")
    ragged_tokens = rng.integers(0, check_cfg.vocab_size, size=(1, 1000))
    before = flash.launches_by_variant["cuda_core_f32"]
    card_ragged = float32_logits(model, ragged_cfg, ragged_tokens)
    ragged_launches = flash.launches_by_variant["cuda_core_f32"] - before
    check(ragged_launches == check_cfg.n_layers,
          f"prefill_check (1000 tokens, xla_chunked): {ragged_launches} "
          f"float32 flash launches, want {check_cfg.n_layers}")
    card_total = flash.launches
    model.to("cpu")
    t_cpu = time.perf_counter()
    on_cpu = step2(model, {"tokens": tokens}).float()
    cpu_f32 = float32_logits(model, check_cfg, tokens)
    cpu_ragged = float32_logits(model, ragged_cfg, ragged_tokens)
    cpu_seconds = time.perf_counter() - t_cpu
    check(flash.launches == card_total,
          "prefill_check: the CPU run launched the flash kernel")
    ragged_logit_err = float((card_ragged - cpu_ragged).abs().max())
    check(card_ragged.shape == (1, 1000, check_cfg.vocab_size)
          and bool(torch.isfinite(card_ragged).all())
          and bool(((card_ragged - cpu_ragged).abs()
                    <= ATTN_F32_TOL + ATTN_F32_TOL * cpu_ragged.abs()).all()),
          f"prefill_check (1000 tokens, xla_chunked): float32 logits on the "
          f"card differ from the CPU's beyond {ATTN_F32_TOL} (max_abs_err="
          f"{ragged_logit_err})")
    check(bool(torch.isfinite(card).all()), "prefill_check: card logits "
          "not finite")
    # float32 activations: the kernel's path against the plain one
    f32_err = float((card_f32 - cpu_f32).abs().max())
    check(bool(((card_f32 - cpu_f32).abs()
                <= ATTN_F32_TOL + ATTN_F32_TOL * cpu_f32.abs()).all()),
          f"prefill_check: float32 logits on the card differ from the "
          f"CPU's beyond {ATTN_F32_TOL} (max_abs_err={f32_err})")
    # bf16, the prefill step itself: each side against the float32 logits
    cpu_err = float((on_cpu - cpu_f32).abs().max())
    card_err = float((card - cpu_f32).abs().max())
    logit_err = float((card - on_cpu).abs().max())
    agree, differ, _ = argmax_agreement(card, on_cpu)
    card_vs_f32, _, gap_f32 = argmax_agreement(card, cpu_f32)
    ties_ok = bool((gap_f32[differ].abs() <= 2 * cpu_err).all()) \
        if bool(differ.any()) else True
    check(logit_err <= 2 * cpu_err and card_err <= 1.25 * cpu_err
          and ties_ok,
          f"prefill_check: bf16 logits on the card differ from the CPU's "
          f"by {logit_err} (bound {2 * cpu_err}: twice the CPU's own bf16 "
          f"error {cpu_err}); the card's error {card_err} (bound "
          f"{1.25 * cpu_err}); argmax agreement {agree}, near ties "
          f"{ties_ok}")
    emit("prefill_check", arch=LM_ARCH, n_layers=check_cfg.n_layers,
         tokens=list(tokens.shape), attn_impl=check_cfg.attn_impl,
         flash_launches=card_launches,
         flash_launches_by_variant=check_by_variant,
         f32_logits_max_abs_err=f32_err,
         f32_tolerance={"abs": ATTN_F32_TOL, "rel": ATTN_F32_TOL},
         logits_max_abs_err=logit_err,
         tolerance={"abs": 2 * cpu_err,
                    "rule": "twice the CPU's bf16 error against its "
                            "float32 logits"},
         bf16_err_vs_f32={"card": card_err, "cpu": cpu_err,
                          "card_bound": 1.25 * cpu_err},
         argmax_agreement=agree,
         argmax_agreement_vs_f32={
             "card": card_vs_f32,
             "cpu": argmax_agreement(on_cpu, cpu_f32)[0]},
         max_argmax_tie_gap_f32=float(gap_f32[differ].abs().max())
         if bool(differ.any()) else 0.0,
         ragged={"tokens": list(ragged_tokens.shape),
                 "attn_impl": ragged_cfg.attn_impl,
                 "flash_launches_cuda_core_f32": ragged_launches,
                 "f32_logits_max_abs_err": ragged_logit_err},
         cpu_seconds=cpu_seconds, seconds=time.perf_counter() - t_phase)
    del model, card, on_cpu, card_f32, cpu_f32, card_ragged, cpu_ragged

    # 13. kernels ---------------------------------------------------------
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
            "deterministic": repeats[f"traverse_{binned}"],
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
            "deterministic": repeats[f"hist_{child}"],
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
        "deterministic": repeats["split_gain"],
    })
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:70",
        "variant": lm_variant,
        "sass_counts": flash_sass,
        "launches": lm_launches,
        "launches_per_request": lm_cfg.n_layers,
        "max_abs_err": slice_err,
        "ms": attn_timing["ms"],
        "plain_ms": attn_timing["plain_ms"],
        "bound_ms": attn_timing["bound_ms"],
        "bound_by": attn_timing["bound_by"],
        "library_ms": attn_timing["library_ms"],
        "deterministic": repeats["flash_attention"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
