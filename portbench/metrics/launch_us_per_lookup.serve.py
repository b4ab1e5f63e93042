"""Host microseconds a lookup in the kernel's launch: the launch plan, the
ctypes call and its error check, the program's ``cuembed::launch.k1`` /
``launch.k2`` spans (traced window: the profiler's cost included). Layer:
launch."""

from portbench import program_spans


def read(ctx):
    split = program_spans.serve_split(ctx)
    return None if split is None else split["launch"]
