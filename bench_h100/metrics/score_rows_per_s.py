"""Rows scored over the whole window, a second of it (host clock)."""


def read(run):
    if run.kind != "score" or run.window_s <= 0:
        return None
    return run.window_rows / run.window_s
