"""Mean host time a training step inside ``apply`` and ``adagrad_update``,
before the synchronize, over the traced run's untraced window (the profiler
slows the host); it includes the update's host waits on sizes that depend on
the data. Layer: collection and api."""


def read(ctx):
    rec = ctx["host_records"]
    if ctx["loop"] != "train" or not rec:
        return None
    return sum(t2 - t0 for _, t0, _, t2, _ in rec) / len(rec) * 1e3
