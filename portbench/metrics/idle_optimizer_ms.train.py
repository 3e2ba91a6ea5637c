"""Device idle milliseconds a training step that began while the host was in
the program's span ``bfc.xe.optimizer``, the clip and the noam Adam update:
each gap of the traced window put down to the span open when it began
(``portbench/progspans.py``)."""

from portbench import progspans


def read(run):
    if run.kind != "train":
        return None
    return progspans.idle_ms(run, "bfc.xe.optimizer")
