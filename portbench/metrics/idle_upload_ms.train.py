"""Device idle milliseconds a training step that began while the host was in
the program's span ``bfc.xe.upload``, the batch's copy to the device
(``to_device``): each gap of the traced window put down to the span open
when it began (``portbench/progspans.py``)."""

from portbench import progspans


def read(run):
    if run.kind != "train":
        return None
    return progspans.idle_ms(run, "bfc.xe.upload")
