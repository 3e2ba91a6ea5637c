"""Device milliseconds a batch in the NA decode's greedy head: the
program's span ``bfc.na.head`` (CUDA events around #3 and the masks after
it), over the window's batches."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.device_ms(run, "bfc.na.head")
