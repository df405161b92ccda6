"""The histogram kernel's share of its roofline, in per cent: the least
time of the traced fit's histogram levels (``counts.hist_tree``: at each
depth d of a tree, bin ids, node ids and (g, h) read once and the 2^d
node panel written once, over 3.35 TB/s) over the device time of the
launches of ``repro_torch/kernels/hist.py`` (its prologue, kernel and
finalize, and the buffers it fills).  One kernel launch is one level."""

import re

LEVEL = re.compile(r"hist_kernel")


def read(run):
    trace = run.trace
    if run.kind != "fit" or trace is None:
        return None
    from bench_h100.counts import least_seconds, share_pct
    levels = trace.count(lambda a: LEVEL.search(a.name))
    if not levels:
        return None
    spent = trace.seconds(lambda a: "kernels/hist.py" in a.modules
                          or LEVEL.search(a.name) is not None)
    tree = run.work["hist_tree"]
    least = sum(least_seconds(w) for w in tree) * levels / len(tree)
    return share_pct(least, spent)
