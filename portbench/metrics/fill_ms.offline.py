"""Device milliseconds a batch in the NA decode's fill: the program's span
``bfc.na.fill`` (CUDA events around the fill's decoder stack, #2 a layer),
over the window's batches."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.device_ms(run, "bfc.na.fill")
