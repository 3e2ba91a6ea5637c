"""Host milliseconds a batch to enqueue the decode: the host clock from the
benchmark's call into ``na_decode`` or ``ar_sample`` to its return, before
any synchronize; the mean over the window's batches."""


def read(run):
    return run.mean("decode_host") if run.kind == "offline" else None
