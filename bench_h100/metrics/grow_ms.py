"""Device milliseconds a round of the traced fit in tree growth: the
kernels, copies and fills whose launch has ``core/tree.py`` as the innermost
``repro_torch/core`` module on its Python stack."""

MODULES = ('core/tree.py',)


def read(run):
    trace = run.trace
    if run.kind != "fit" or trace is None or not trace.attributed():
        return None
    from bench_h100.devtrace import innermost_core
    s = trace.seconds(lambda a: innermost_core(a.modules) in MODULES)
    return 1e3 * s / run.traced_rounds
