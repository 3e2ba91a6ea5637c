"""Calls a batch of ``MultiHeadAttention.attend`` that took the plain path
(float32 scores over operands widened from the compute dtype), not the
attention core: the program's counter ``attend_calls.plain`` over the
window's batches, encode and decode.  None where the program counts no
``attend`` call by branch (a checkout from before the counters)."""

from portbench import progspans


def read(run):
    if run.kind != "offline":
        return None
    snap, n = progspans.snapshot(), progspans.units(run)
    counts = (snap or {}).get("counts", {})
    if not n or not any(k.startswith("attend_calls.") for k in counts):
        return None
    return counts.get("attend_calls.plain", 0) / n
