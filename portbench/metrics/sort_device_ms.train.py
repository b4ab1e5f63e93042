"""Device time a step of the kernels ``aten::sort`` launches (the stable sort
of each table's ids by row). Layer: transforms."""

from portbench import readers


def read(ctx):
    ev = ctx["events"]
    if ctx["loop"] != "train" or ev is None or not readers.linked(ev):
        return None
    ops = readers.launched_by_op(ev, readers.SORT_OP)
    if not ops:
        return None
    return readers.device_s(ops) / len(ctx["records"]) * 1e3
