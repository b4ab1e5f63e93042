"""Device-idle milliseconds a training step in the gaps that begin while the
host is inside a ``cuembed::wait.*`` span: the queue a wait drained, idle
until the host refills it (``tracing.idle_gaps``, traced window). Layer:
train."""

from portbench import program_spans


def read(ctx):
    waits = program_spans.waits(ctx)
    if waits is None:
        return None
    return program_spans.wait_idle_us(ctx["events"], waits) / 1e3 / len(ctx["records"])
