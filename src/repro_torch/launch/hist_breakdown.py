"""Where the histogram kernel's time goes: it timed with parts taken out.

    PYTHONPATH=src python -m repro_torch.launch.hist_breakdown [--json out]

Builds copies of ``kernels/csrc/hist.cu`` (one ``nvcc`` each, all started
together, into ``build/repro_torch_kernels/breakdown/``) in which a part
of the main loop is cut:

* ``kernel``: the source as it is;
* ``low_words``: each element adds only the low 32-bit words of g and h
  (two shared atomics instead of four, no carries);
* ``no_atomics``: no shared-memory adds at all (the bin ids are still
  loaded and range-checked);
* ``no_bin_loads``: neither adds nor bin loads (staging, the loop and the
  flush remain).

Only ``kernel`` computes the histogram; it is held to
``ref.hist_levels_fixed`` before anything is timed.  Each variant is
timed with CUDA events at the training shape of ``chip_smoke.py`` (1M
rows x 28 features, 33 bins; direct mode with 32 nodes, child mode with
16 parents), rows spread over every node, and with every row in node 0
(a tree's root level).  Needs a CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..kernels import _build, ref

ADDS = """          add_i64(g_lo + bucket, g_hi + bucket, s.qg);
          add_i64(h_lo + bucket, h_hi + bucket, s.qh);"""
LOAD = "load_bins<V>(bins + ws[r].bin_off + g * V, b[u]);"
CUTS = {
    "kernel": [],
    "low_words": [(ADDS, "          atomicAdd(g_lo + bucket, "
                         "static_cast<unsigned>(s.qg));\n"
                         "          atomicAdd(h_lo + bucket, "
                         "static_cast<unsigned>(s.qh));")],
    "no_atomics": [(ADDS, "          if (s.qg == 1) g_lo[bucket] = 1u;")],
    "no_bin_loads": [(ADDS, "          if (s.qg == 1) g_lo[bucket] = 1u;"),
                     (LOAD, "for (int v = 0; v < V; ++v) b[u][v] = "
                            "static_cast<int>(ws[r].bin_off + g) & 31;")],
}
ROWS, FEATURES, NBINS, NODES = 1_000_000, 28, 33, 32


def build() -> dict:
    """The variants' ``hist_levels`` entry points, by name."""
    src = (_build.CSRC / "hist.cu").read_text()
    out_dir = _build.BUILD_DIR / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"hist_breakdown: {name}: the source no "
                                   f"longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"hist_breakdown: {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).hist_levels
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, bins, node, gh, *, n_nodes, child):
    """One call of a variant, as ``kernels.hist`` makes it."""
    n, f = bins.shape
    shape = (node.shape[0], n_nodes, f, NBINS)
    out = torch.empty(shape + (2,), device=bins.device)
    acc = torch.empty(shape + (2,), dtype=torch.int64, device=bins.device)
    parts = torch.empty(2048, dtype=torch.int32, device=bins.device)
    cnt = torch.empty(shape, dtype=torch.int32, device=bins.device)
    err = fn(bins.data_ptr(), node.data_ptr(), gh.data_ptr(), out.data_ptr(),
             acc.data_ptr(), parts.data_ptr(), cnt.data_ptr(), n, f,
             node.shape[0], n_nodes, NBINS, int(child),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"hist_breakdown: launch failed, cudaError_t {err}")
    return out, cnt


def device_us(fn, iters: int = 30) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls
    queued behind a spin kernel (so the host's issue time is not in it)."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(300_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hist_breakdown needs a CUDA device")
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bins = torch.randint(0, NBINS, (ROWS, FEATURES), generator=gen,
                         device="cuda", dtype=torch.int32)
    gh = torch.randn((ROWS, 2), generator=gen, device="cuda")
    spread = torch.randint(0, NODES, (1, ROWS), generator=gen, device="cuda",
                           dtype=torch.int32)
    root = torch.zeros_like(spread)
    for child in (False, True):
        got = launch(fns["kernel"], bins, spread, gh,
                     n_nodes=NODES // 2 if child else NODES, child=child)
        want = ref.hist_levels_fixed(bins, spread, gh, child=child,
                                     n_nodes=NODES // 2 if child else NODES,
                                     nbins=NBINS)
        if child:
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        else:
            same = torch.equal(got[0], want)
        if not same:
            raise RuntimeError(f"hist_breakdown: the kernel (child={child}) "
                               "differs from ref.hist_levels_fixed")
    result = {"device": torch.cuda.get_device_name(0), "rows": ROWS,
              "features": FEATURES, "nbins": NBINS, "us": {}}
    for name, fn in fns.items():
        times = {}
        for child in (False, True):
            mode = "left" if child else "direct"
            kw = dict(n_nodes=NODES // 2 if child else NODES, child=child)
            for where, node in (("spread", spread), ("root", root)):
                times[f"{mode}_{where}"] = device_us(
                    lambda: launch(fn, bins, node, gh, **kw))
        result["us"][name] = times
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
