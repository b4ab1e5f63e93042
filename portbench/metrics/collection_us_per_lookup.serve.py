"""Host microseconds a lookup in the collection's own code, outside the
lookups it calls: the program's ``cuembed::collection.apply`` spans less the
``cuembed::api.lookup`` spans inside them, over the window's lookups (traced
window: the profiler's cost included). Layer: collection."""

from portbench import program_spans


def read(ctx):
    split = program_spans.serve_split(ctx)
    return None if split is None else split["collection"]
