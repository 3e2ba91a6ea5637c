"""The whole decode's share of the card's peak, in percent: the frozen
model FLOPs a caption (``portbench/roofline/counts.py``) times the
captions the window finished, over the window's seconds, over the
compute dtype's published peak."""

from portbench.roofline import counts


def read(run):
    if run.kind != "offline" or not run.window_s:
        return None
    rate = run.counts["flops_per_caption"] * run.counts["captions"]
    peak = counts.peaks()["flops_per_s"][run.dtype]
    return 100.0 * rate / run.window_s / peak
