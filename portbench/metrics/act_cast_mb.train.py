"""MB a training step written by the forward's casts of activations to
another dtype: the program's counter ``cast_bytes.act`` over the window's
steps (autograd's backward casts are not the program's sites)."""

from portbench import progspans


def read(run):
    if run.kind != "train":
        return None
    return progspans.counter_mb(run, "cast_bytes.act")
