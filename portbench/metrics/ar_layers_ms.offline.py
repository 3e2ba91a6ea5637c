"""Device milliseconds a batch in the AR decode's cached decoder layers:
the program's span ``bfc.ar.layers`` (CUDA events around the embedding and
the layers in ``ar_step``, #9 among them), summed over the steps, over the
window's batches."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.device_ms(run, "bfc.ar.layers")
