"""Spans and counters of the port's host path.

**Spans** are ranges on ``torch.profiler``'s clock named
``cuembed::<layer>.<what>``, recorded only while a profiler is recording:
tracing is on exactly then (:func:`on`), and nothing else switches it. The
switch is torch's own flag for fast checks,
``torch.autograd.profiler._is_profiler_enabled``, set when a profiler starts
recording and cleared when it stops. A span site reads it first and does
nothing more when it is off. The per-lookup sites read the flag in place and
open and close their span by hand, so that a switched-off site costs two
attribute reads and two comparisons, and no call::

    span = (trace.begin("api.lookup")
            if trace.torch_profiler._is_profiler_enabled else None)
    try:
        ...
    finally:
        if span is not None:
            trace.end(span)

The other sites take ``with trace.span(...)``. A span is a profiler op
(``torch._C._profiler._RecordFunctionFast``): the range
``torch.profiler.record_function`` makes, in the profiler's op scope rather
than its user-annotation scope. So a kernel launched through ctypes inside a
``launch.*`` span links to it by correlation id, as a kernel launched by an
``aten::`` op links to that op, and the profiler draws no copy of the span on
the device's timeline.

The spans, from the entry point down:

* ``collection.apply``, ``collection.adagrad_update``: one call of
  :class:`~cuembed_tpu_torch.collection.EmbeddingCollection`'s method.
* ``api.lookup``: one ``embedding_lookup`` / ``embedding_lookup_csr`` (index
  preparation, the checks, the ``autograd.Function``).
* ``dispatch.forward``, ``dispatch.backward_compressed``: the routing.
* ``launch.k1``, ``launch.k2``, ``launch.k3``, ``launch.k4``, ``launch.k5``:
  a kernel's launch (``ops/_build.py::launch``): the device guard, the
  stream handle, the ctypes call and its error check.
* ``launch.k1_batch``: the same for the one ctypes call of a list-form
  forward (``api.embedding_lookup_many``, ``collection.apply``'s route for
  its fixed-hotness tables on the card), which launches K1 for every lookup
  it serves; those make no ``api.lookup``, ``dispatch.forward`` or
  ``launch.k1`` span.
* ``train.row_sums``, ``train.adagrad``: a row-wise AdaGrad update's
  per-row gradient sums and its update of the touched rows (K4).
* ``wait.<site>``: a read on the host of a size or mask that the device
  computes (:func:`wait`), which waits for the device's queue to drain.
* ``build``: the library's compile (``ops/_build.py``).

**Counters** are plain integers in :data:`COUNTS`, always on, each
incremented in place where it happens. :func:`counters` returns a snapshot;
compare two snapshots for the counts in between. There is no reset.

* ``launch.k1``, ``launch.k2``, ``launch.k3_full``, ``launch.k3_compressed``,
  ``launch.k4``: kernel launches (a CUDA graph counts its captures, not its
  replays), the batched forward's K1 launches among them;
* ``launch.k5``: COO transposes K5 served, one a call of its wrapper (its
  zero fill, digit count and digit passes);
* ``launch.k1_batch``: calls of the list-form forward into the library,
  one a device;
* ``collection.batched_tables``: lookups the list-form forward served,
  those without work among them (the fixed-hotness tables
  ``EmbeddingCollection.apply`` served that way; a caller of
  ``api.embedding_lookup_many`` counts as well);
* ``wait.num_unique``, ``wait.keep_mask``: the host reads of :func:`wait`
  (SGD's and Adam's updates; row-wise AdaGrad's makes none);
* ``build``: compiles of the library in this process (a process that only
  loaded a library built before reads 0).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as torch_profiler

PREFIX = "cuembed::"

COUNTS = dict.fromkeys(
    ("launch.k1", "launch.k2", "launch.k3_full", "launch.k3_compressed", "launch.k4",
     "launch.k5", "launch.k1_batch", "collection.batched_tables", "wait.num_unique",
     "wait.keep_mask", "build"), 0)
_OFF = contextlib.nullcontext()



def on() -> bool:
    """Whether a profiler is recording."""
    return torch_profiler._is_profiler_enabled


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def begin(name: str):
    """Open the span ``cuembed::<name>``; close it with :func:`end`."""
    span = _range(PREFIX + name)
    span.__enter__()
    return span


def end(span):
    span.__exit__(None, None, None)


def span(name: str):
    """The span ``cuembed::<name>`` while tracing is on, else a context that
    does nothing."""
    return _range(PREFIX + name) if on() else _OFF


def counters() -> dict:
    """A snapshot of every counter, by name."""
    return dict(COUNTS)


def wait(site: str, read, *args):
    """``read(*args)``, a read on the host of something the device computes:
    counted as ``wait.<site>`` and spanned ``cuembed::wait.<site>``."""
    name = "wait." + site
    COUNTS[name] += 1
    with span(name):
        return read(*args)
