"""Mean host time inside ``EmbeddingCollection.apply`` a request, from the call
to its return, before the synchronize (the benchmark's span around the call),
over the traced run's untraced window: the profiler slows the host. Layer:
collection and api."""


def read(ctx):
    rec = ctx["host_records"]
    if ctx["loop"] != "serve" or not rec:
        return None
    return sum(t1 - t0 for _, t0, t1, _ in rec) / len(rec) * 1e3
