"""The requests' share of the HBM roofline: their least bytes (each table's
distinct rows, ids and pooled output once) over 3.35 TB/s times their wall
time, call to the synchronize's return, summed over the traced run's
untraced window (the profiler slows the host). It reckons the work from the
inputs, whatever kernels do it. Layer: device."""

from portbench import bounds


def read(ctx):
    rec = ctx["host_records"]
    if ctx["loop"] != "serve" or not rec:
        return None
    least = sum(ctx["least_bytes"][r[0]] for r in rec)
    wall = sum(r[3] - r[1] for r in rec)
    return 100.0 * least / bounds.HBM_BYTES_PER_S / wall
