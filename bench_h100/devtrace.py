"""A device trace of part of a run, reduced to what the per-layer metrics
read.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities, Python stacks on) inside a ``record_function`` range that
marks the traced window, writes the Chrome trace to a temporary file,
reads it back and deletes it.  :func:`reduce_events` turns the trace's
events into a :class:`Trace`:

* every device activity (kernel, memcpy, memset) in the window, with its
  seconds and the ``repro_torch`` modules on the Python stack of the host
  call that launched it, innermost first (the launch found by the
  activity's correlation id);
* the seconds in which any activity ran (``busy_s``) and the window's
  length (``window_s``);
* the idle gaps of the device, each named by the innermost host event
  running at its middle, summed by name.

It reads the program without changing it: the kernels that the program
launches through ``ctypes`` are found the same way as torch's own.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import sys
import tempfile

WINDOW = "bench_h100.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("python_function", "cpu_op", "cuda_runtime", "cuda_driver",
             "user_annotation")
_MODULE = re.compile(r"repro_torch/([\w/]+\.py)\(\d+\): (\w+)")


@dataclasses.dataclass
class Activity:
    name: str
    seconds: float
    modules: tuple[str, ...]      # repro_torch modules, innermost first


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    activities: list[Activity]
    idle_by_host: dict[str, float]

    def seconds(self, pick) -> float:
        """Summed seconds of the activities for which ``pick(a)`` holds."""
        return sum(a.seconds for a in self.activities if pick(a))

    def count(self, pick) -> int:
        return sum(1 for a in self.activities if pick(a))

    def attributed(self) -> bool:
        """Whether any activity was traced back to a program module."""
        return any(a.modules for a in self.activities)

    def top_ops(self, limit: int = 10) -> list:
        by = collections.Counter()
        for a in self.activities:
            by[a.name] += a.seconds
        return [[name, s] for name, s in by.most_common(limit)]

    def top_idle(self, limit: int = 10) -> list:
        by = collections.Counter(self.idle_by_host)
        return [[name, s] for name, s in by.most_common(limit)]


def innermost_core(modules: tuple[str, ...]) -> str | None:
    """The innermost ``core/`` module of a launch's stack."""
    for m in modules:
        if m.startswith("core/"):
            return m
    return None


def profiled(fn):
    """``fn()`` under the profiler; returns (its result, a :class:`Trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        print(f"bench_h100: the trace took {os.path.getsize(path)} bytes",
              file=sys.stderr)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return out, reduce_events(events)


def _label(e: dict) -> str:
    m = _MODULE.search(e.get("name", ""))
    if m:
        return f"{m.group(1)}: {m.group(2)}"
    return e.get("name", "?")[:80]


def reduce_events(events: list[dict]) -> Trace:
    """Reduce Chrome-trace events (``ts``/``dur`` in microseconds) to a
    :class:`Trace` of the :data:`WINDOW` range."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} range")
    w = win[0]
    w0, w1, tid = w["ts"], w["ts"] + w["dur"], w.get("tid")

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    frames = sorted((e for e in events if e.get("cat") == "python_function"
                     and _MODULE.search(e.get("name", ""))),
                    key=lambda e: (e["ts"], -e.get("dur", 0)))
    stacks = _stacks_at(frames, sorted(
        (e["ts"], e.get("tid"), c) for c, e in launches.items()))

    acts, spans = [], []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b <= a:
            continue
        corr = e.get("args", {}).get("correlation")
        acts.append(Activity(e.get("name", "?"), (b - a) * 1e-6,
                             stacks.get(corr, ())))
        spans.append((a, b))
    busy, gaps = _union(spans, w0, w1)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("tid") == tid and e.get("name") != WINDOW
                   and "dur" in e),
                  key=lambda e: (e["ts"], -e["dur"]))
    idle = collections.Counter()
    starts = [e["ts"] for e in host]
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "none"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            e = host[j]
            if e["ts"] + e["dur"] >= mid:
                name = _label(e)
                break
            if mid - e["ts"] > 60e6:   # nothing older can still be open
                break
        idle[name] += (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                 activities=acts, idle_by_host=dict(idle))


def _stacks_at(frames: list[dict], points: list[tuple]) -> dict:
    """For each launch (ts, tid, correlation), the program modules of the
    Python frames open at ts on its thread, innermost first."""
    by_tid = collections.defaultdict(list)
    for e in frames:
        by_tid[e.get("tid")].append(e)
    out = {}
    open_ = collections.defaultdict(list)
    idx = collections.defaultdict(int)
    for ts, tid, corr in points:
        fs, stack = by_tid.get(tid, []), open_[tid]
        while idx[tid] < len(fs) and fs[idx[tid]]["ts"] <= ts:
            e = fs[idx[tid]]
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            stack.append(e)
            idx[tid] += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < ts:
            stack.pop()
        out[corr] = tuple(_MODULE.search(e["name"]).group(1)
                          for e in reversed(stack)
                          if e["ts"] + e.get("dur", 0) >= ts)
    return out


def _union(spans, w0, w1):
    """(covered length, the gaps) of ``spans`` inside [w0, w1]."""
    covered, gaps, at = 0.0, [], w0
    for a, b in sorted(spans):
        if a > at:
            gaps.append((at, a))
        if b > at:
            covered += b - max(a, at)
            at = b
    if at < w1:
        gaps.append((at, w1))
    return covered, gaps
