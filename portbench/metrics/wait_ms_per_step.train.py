"""Host milliseconds a training step inside the program's ``cuembed::wait.*``
spans, the host's reads of sizes and masks the device computes (traced
window). Layer: train."""

from portbench import program_spans


def read(ctx):
    waits = program_spans.waits(ctx)
    if waits is None:
        return None
    return program_spans.total(waits) / 1e3 / len(ctx["records"])
