"""Device milliseconds a batch in the decode (``na_decode`` or
``ar_sample``): CUDA events around the benchmark's call, the mean over the
window's batches (the stream's time between them, so a decode the host
paces reads its pacing)."""


def read(run):
    return run.mean("decode") if run.kind == "offline" else None
