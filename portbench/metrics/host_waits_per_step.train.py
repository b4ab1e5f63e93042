"""Host waits a training step: the program's ``cuembed::wait.*`` spans in the
traced window (each a host read of a size or mask the device computes) over
the window's steps. Layer: train."""

from portbench import program_spans


def read(ctx):
    waits = program_spans.waits(ctx)
    return None if waits is None else len(waits) / len(ctx["records"])
