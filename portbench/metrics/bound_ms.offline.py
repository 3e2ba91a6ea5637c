"""Device milliseconds a batch in the NA decode's bounding loop: the
program's span ``bfc.na.bound`` (CUDA events around ``bound_plan`` in
``na_decode``), over the window's batches."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.device_ms(run, "bfc.na.bound")
