"""CUDA kernels a training step: the profiled kernels of the traced window
(copies and fills left out) over its steps, each of which the window ran
to its end."""

from portbench.devtrace import NOT_KERNELS


def read(run):
    if run.kind != "train" or run.trace is None or not run.counts["steps"]:
        return None
    return run.trace.count(exclude=NOT_KERNELS) / run.counts["steps"]
