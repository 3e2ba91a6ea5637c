"""MB a batch written by casts of parameters to the compute dtype
(``Dense``'s weight and bias, every call): the program's counter
``cast_bytes.param`` over the window's batches, encode and decode."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.counter_mb(run, "cast_bytes.param")
