"""Device time a step of what ``adagrad_update`` launches besides K3 and the
sort: flattening, gathers, the accumulator and table updates, fills. Layer:
train."""

from portbench import readers


def read(ctx):
    ev = ctx["events"]
    if ctx["loop"] != "train" or ev is None or not readers.linked(ev):
        return None
    sort = {id(d) for d in readers.launched_by_op(ev, readers.SORT_OP)}
    ops = [d for d in readers.launched_in_span(ev, "adagrad_update")
           if id(d) not in sort and not readers.is_kernel(d[0], readers.K3)]
    if not ops:
        return None
    return readers.device_s(ops) / len(ctx["records"]) * 1e3
