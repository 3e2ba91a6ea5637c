"""The whole XE step's share of the card's peak, in percent: the frozen
FLOPs of a step's forward and backward (``portbench/roofline/counts.py``)
times the steps of the window, over the window's seconds, over the compute
dtype's published peak."""

from portbench.roofline import counts


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    rate = run.counts["flops_per_step"] * run.counts["steps"] / run.window_s
    return 100.0 * rate / counts.peaks()["flops_per_s"][run.dtype]
