"""Device milliseconds a training step: the profiled busy time of the
traced window (the union of its device intervals) over the steps in it."""


def read(run):
    if run.kind != "train" or run.trace is None or not run.counts["steps"]:
        return None
    return 1e3 * run.trace.busy_s() / run.counts["steps"]
