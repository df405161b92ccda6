"""The 95th percentile of the window's request latencies (host clock, each
request waited for), in milliseconds."""

import numpy as np


def read(run):
    if run.kind != "score" or not run.latencies:
        return None
    return 1e3 * float(np.percentile(run.latencies, 95))
