"""The port's own kernels against their roofline, in percent: the least
time the card needs for every kernel launch of the traced window (each
wrapper's frozen work at the cell's sizes, ``portbench/roofline/
launches.py``) over the profiled device time of the port's kernels in that
window.  None when the window launched none, or launched a wrapper whose
work the table cannot give."""

from portbench.devtrace import PORT_KERNEL_MARK
from portbench.roofline import launches


def read(run):
    if run.kind != "offline" or run.trace is None or not run.launches:
        return None
    spent = run.trace.kernel_s(PORT_KERNEL_MARK)
    least = launches.least_time_s(run.launches, run.sizes, run.dtype)
    if spent <= 0 or least is None:
        return None
    return 100.0 * least / spent
