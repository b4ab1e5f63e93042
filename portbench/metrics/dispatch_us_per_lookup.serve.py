"""Host microseconds a lookup in ``ops/dispatch.py`` and the kernel
wrapper's checks: the program's ``cuembed::dispatch.forward`` spans less the
``cuembed::launch.k1`` / ``launch.k2`` spans inside them (traced window: the
profiler's cost included). Layer: dispatch."""

from portbench import program_spans


def read(ctx):
    split = program_spans.serve_split(ctx)
    return None if split is None else split["dispatch"]
