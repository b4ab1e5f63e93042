"""Device time a step of the COO transpose: what the program's
``cuembed::launch.k5`` spans launched (K5's zero fill, digit count and digit
passes), or, for a program without that span, what ``aten::sort`` launched
(the stable sort of each table's ids). Layer: transforms."""

from portbench import readers

K5_SPAN = "cuembed::launch.k5"


def read(ctx):
    ev = ctx["events"]
    if ctx["loop"] != "train" or ev is None or not readers.linked(ev):
        return None
    ops = (readers.launched_by_op(ev, K5_SPAN)
           or readers.launched_by_op(ev, readers.SORT_OP))
    if not ops:
        return None
    return readers.device_s(ops) / len(ctx["records"]) * 1e3
