"""The forest-sum kernel's share of its roofline, in per cent: the least
time of a request's counted work (``counts.forest_request``: the rows and
the forest read once, the margins written once, against a compare a
(row, tree, level) and an add a (row, tree) over 67 TFLOP/s) over the
kernel's device time a launch in the traced requests."""

import re

KERNEL = re.compile(r"forest_sum_kernel")


def read(run):
    trace = run.trace
    if run.kind != "score" or trace is None:
        return None
    from bench_h100.counts import least_seconds, share_pct
    launches = trace.count(lambda a: KERNEL.search(a.name))
    if not launches:
        return None
    spent = trace.seconds(lambda a: KERNEL.search(a.name) is not None)
    return share_pct(launches * least_seconds(run.work["request"]), spent)
