"""Share of the traced window in which nothing runs on the card (no kernel,
copy or set: the union of the profiler's device intervals), in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
