"""The whole request's share of the card's peak, in per cent: the least
time of a request's counted work (``counts.forest_request``) over the
window's mean host-clock request (each one waited for)."""


def read(run):
    if run.kind != "score" or not run.latencies:
        return None
    from bench_h100.counts import least_seconds, share_pct
    mean_s = sum(run.latencies) / len(run.latencies)
    return share_pct(least_seconds(run.work["request"]), mean_s)
