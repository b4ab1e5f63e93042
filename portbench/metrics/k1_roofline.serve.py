"""K1's share of its roofline over the window: the sum of each launch's least
time (``bounds.k1_bound_s``: distinct rows, ids and output once at 3.35 TB/s)
over K1's device time in the trace. Layer: kernels."""

from portbench import readers


def read(ctx):
    return readers.k1_share(ctx)
