"""Host microseconds a lookup in ``ops/api.py``: index preparation, the
checks and the ``autograd.Function``, the program's ``cuembed::api.lookup``
spans less the ``cuembed::dispatch.forward`` spans inside them (traced
window: the profiler's cost included). Layer: api."""

from portbench import program_spans


def read(ctx):
    split = program_spans.serve_split(ctx)
    return None if split is None else split["api"]
