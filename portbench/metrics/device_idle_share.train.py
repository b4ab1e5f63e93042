"""Share of the training window in which no kernel, copy or memset ran on the
card. Layer: device."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
