"""Host-clock milliseconds a boosting round: the window's whole fits, their
seconds summed over their rounds."""


def read(run):
    if run.kind != "fit" or not run.fit_seconds:
        return None
    return 1e3 * sum(run.fit_seconds) / (run.rounds * len(run.fit_seconds))
