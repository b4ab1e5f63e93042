"""Host input pipeline: remap and prefetch off the device's critical path,
the counterpart of ``cuembed_tpu/utils/pipeline.py``.

A background thread pulls raw batches from a source, applies the id->row
remap of a frequency-ordered layout (:mod:`cuembed_tpu_torch.native`, the
C++ kernel when it is built), optionally moves them to the device, and keeps
``depth`` batches in flight so the card does not wait on the host.

Copies to the card: :func:`to_device` gives a ``device_put`` that pins each
array in page-locked memory and copies it with ``non_blocking=True``
(without pinned memory a non-blocking copy is a synchronous one). The
worker runs ``device_put`` on a side CUDA stream and records an event after
it; :meth:`InputPipeline.get` makes the caller's current stream wait on
that event and marks each CUDA tensor of the batch as used on that stream
(``record_stream``), so the caching allocator does not hand its memory to
the next copy before the caller's kernels have read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from cuembed_tpu_torch import native

Batch = Union[np.ndarray, Dict[str, np.ndarray]]


def to_device(device: torch.device | str) -> Callable[[Batch], object]:
    """A ``device_put`` for :class:`InputPipeline`: an array, or each array
    of a dict, as a tensor on ``device``; on a CUDA device from pinned
    memory, without blocking the host."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put_one(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def put(batch):
        if isinstance(batch, dict):
            return {k: put_one(v) for k, v in batch.items()}
        return put_one(batch)
    return put


def _cuda_tensors(batch):
    items = batch.values() if isinstance(batch, dict) else (batch,)
    return [t for t in items if isinstance(t, torch.Tensor) and t.is_cuda]


class InputPipeline:
    """Background prefetcher with id->row remapping.

    Args:
      source: callable returning the next raw batch: one index array or a
        dict of named arrays (multi-table). Called from the worker thread;
        ``StopIteration`` ends the stream.
      remap: optional remap vector, or dict of per-name remap vectors
        (names missing from the dict pass through).
      depth: number of prepared batches to keep in flight.
      device_put: optional callable applied to each prepared batch on the
        worker thread (e.g. :func:`to_device`); None leaves batches as
        numpy. With a card it runs on a side stream (see the module doc).
    """

    def __init__(
        self,
        source: Callable[[], Batch],
        *,
        remap: Optional[Union[np.ndarray, Dict[str, np.ndarray]]] = None,
        depth: int = 2,
        device_put: Optional[Callable] = None,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._source = source
        self._remap = remap
        self._device_put = device_put
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _apply_remap(self, batch: Batch) -> Batch:
        if self._remap is None:
            return batch
        if isinstance(batch, dict):
            rm = self._remap if isinstance(self._remap, dict) else None
            out = {}
            for name, arr in batch.items():
                r = rm.get(name) if rm is not None else self._remap
                out[name] = (
                    native.remap_indices(arr, r) if r is not None else arr
                )
            return out
        return native.remap_indices(batch, self._remap)

    def _put(self, batch, stream):
        """``device_put`` on the side stream, and the event after it."""
        if stream is None:
            return self._device_put(batch), None
        with torch.cuda.stream(stream):
            batch = self._device_put(batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        return batch, ready

    def _worker(self):
        try:
            stream = None
            if self._device_put is not None and torch.cuda.is_available():
                stream = torch.cuda.Stream()
            while not self._stop.is_set():
                batch, ready = self._apply_remap(self._source()), None
                if self._device_put is not None:
                    batch, ready = self._put(batch, stream)
                while not self._stop.is_set():
                    try:
                        self._queue.put((batch, ready), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the next get()
            self._error = e

    def _ready(self, item) -> Batch:
        batch, ready = item
        if ready is not None:
            current = torch.cuda.current_stream()
            current.wait_event(ready)
            for t in _cuda_tensors(batch):
                t.record_stream(current)
        return batch

    def get(self, timeout: Optional[float] = 30.0) -> Batch:
        """Next prepared batch (blocks until the worker has one).

        Already-prepared batches are drained before a worker error (or a
        source ``StopIteration``) is surfaced.
        """
        while True:
            try:
                return self._ready(self._queue.get_nowait())
            except queue.Empty:
                pass
            if self._error is not None:
                raise self._error
            try:
                return self._ready(self._queue.get(timeout=0.1))
            except queue.Empty:
                if timeout is not None:
                    timeout -= 0.1
                    if timeout <= 0:
                        raise TimeoutError("input pipeline starved")

    def __iter__(self) -> Iterator[Batch]:
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
