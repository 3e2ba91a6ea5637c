"""Host milliseconds a training step in the batch's copy to the device:
the program's span ``bfc.xe.upload`` (``to_device`` in ``run_xe_step``),
over the window's steps."""

from portbench import progspans


def read(run):
    if run.kind != "train":
        return None
    return progspans.host_ms(run, "bfc.xe.upload")
