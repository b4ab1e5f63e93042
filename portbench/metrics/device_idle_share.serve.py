"""Share of the serving window in which no kernel, copy or memset ran on the
card (1 - the union of device intervals over the window). Layer: device."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
