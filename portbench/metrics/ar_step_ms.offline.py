"""Device milliseconds a batch in the AR decode's steps: the program's span
``bfc.ar.step`` (CUDA events around each step of ``ar_sample``), summed over
the steps, over the window's batches.  Less ``ar_layers_ms.offline``, the
vocabulary work: projection, log-softmax, choice, entropy."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.device_ms(run, "bfc.ar.step")
