"""The whole round's share of the card's peak, in per cent: the least time
of a round's counted work (``counts.fit_round``: x, labels and margin read
once and the margin written once over 3.35 TB/s, against its operations
over 67 TFLOP/s) over the window's measured host-clock round.  A round is
bound by bytes: it does a few operations a byte."""


def read(run):
    if run.kind != "fit" or not run.fit_seconds:
        return None
    from bench_h100.counts import least_seconds, share_pct
    round_s = sum(run.fit_seconds) / (run.rounds * len(run.fit_seconds))
    return share_pct(least_seconds(run.work["round"]), round_s)
