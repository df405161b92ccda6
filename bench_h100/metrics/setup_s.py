"""Seconds from the start of the process to the start of the window:
imports, the card, the data, loading (or building) the kernels, warm-up."""


def read(run):
    return run.setup_s
