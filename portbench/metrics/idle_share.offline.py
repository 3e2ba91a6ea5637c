"""The device's idle share of the traced window, in percent: 1 - the union
of the profiled device intervals over the window."""


def read(run):
    if run.kind != "offline" or run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
