"""MB a batch written by casts of activations to another dtype (inputs,
looked-up rows, float32 scores' operands and probabilities, attention
outputs, norms, logits): the program's counter ``cast_bytes.act`` over the
window's batches, encode and decode."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    return progspans.counter_mb(run, "cast_bytes.act")
