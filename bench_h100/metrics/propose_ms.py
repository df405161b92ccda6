"""Device milliseconds a round of the traced fit in the proposal layer: the
kernels, copies and fills whose launch has ``core/proposal.py`` or ``core/sketch.py`` as the innermost
``repro_torch/core`` module on its Python stack."""

MODULES = ('core/proposal.py', 'core/sketch.py')


def read(run):
    trace = run.trace
    if run.kind != "fit" or trace is None or not trace.attributed():
        return None
    from bench_h100.devtrace import innermost_core
    s = trace.seconds(lambda a: innermost_core(a.modules) in MODULES)
    return 1e3 * s / run.traced_rounds
