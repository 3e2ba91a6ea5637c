"""Device milliseconds a batch in the model's encode (``fused_encode``):
CUDA events around the benchmark's call, the mean over the window's
batches."""


def read(run):
    return run.mean("encode") if run.kind == "offline" else None
