"""The device's idle share of the traced window, in per cent: the time in
which no kernel, copy or fill ran, over the window's length."""


def read(run):
    if run.kind != "fit" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
