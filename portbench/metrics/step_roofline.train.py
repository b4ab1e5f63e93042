"""The steps' share of the HBM roofline: their least bytes (each table's
lookup, ``grad_y`` once, each touched row written once and its accumulator
read and written once; not the sort's streams) over 3.35 TB/s times their
wall time, summed over the traced run's untraced window (the profiler slows
the host). Layer: device."""

from portbench import bounds


def read(ctx):
    rec = ctx["host_records"]
    if ctx["loop"] != "train" or not rec:
        return None
    least = sum(ctx["least_bytes"][r[0]] for r in rec)
    wall = sum(r[4] - r[1] for r in rec)
    return 100.0 * least / bounds.HBM_BYTES_PER_S / wall
