"""Host-offloaded embedding table: a device hot head and a host-RAM cold
tail, the counterpart of ``cuembed_tpu/offload.py``.

Serves tables larger than the card's memory:

* rows ``[0, hot)``, the frequency-ordered hot head, live on the card and
  serve the bulk of power-law traffic;
* rows ``[hot, V)`` stay in host RAM (an fp32 master). Per batch, the host
  gathers the *unique* cold rows the batch touches (:meth:`prepare`, made
  to run on the input pipeline's thread, :mod:`cuembed_tpu_torch.utils.
  pipeline`) and ships them with the batch from pinned memory on a side
  stream: ``O(unique_cold * width)`` bytes a step, whatever the tail's
  size.
* The lookup is ONE K1 launch in position order: the head sits at the top
  of a device buffer of ``hot + cold_cap`` rows, the batch's shipped rows
  are copied (stream-ordered, on the card) into its last ``cold_cap``
  rows, and a cold position's id becomes ``hot + slot``. It equals K1 on
  the resident table bit for bit: the same rows in the same order.
* The sparse updates split the same way: the head's rows update on the card
  (K3 compressed, :mod:`cuembed_tpu_torch.train`), and the cold rows'
  gradient sums ship back to update the host tail.

Exactness: the hot/cold split is a placement, not an approximation.
Overflowing the static ``cold_cap`` raises at :meth:`prepare` time on the
host; size it from the calibrated cold fraction
(:func:`cuembed_tpu_torch.utils.frequency.tier_fractions`) with margin.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cuembed_tpu_torch import native
from cuembed_tpu_torch.ops.api import embedding_lookup
from cuembed_tpu_torch.train import rowwise_adagrad_sparse_update, sgd_sparse_update
from cuembed_tpu_torch.types import CombineMode, combine_coefficients, default_device


@dataclass(frozen=True)
class OffloadBatch:
    """One prepared batch: device-ready indices and the shipped cold rows."""

    idx_hot: torch.Tensor      # [B, H] ids, cold ones set to 0
    slot_of_pos: torch.Tensor  # [B, H] index into cold_rows (0 where hot)
    is_cold: torch.Tensor      # [B, H] bool
    cold_rows: torch.Tensor    # [cold_cap, W] shipped tail rows, head dtype
    uniq_cold: np.ndarray      # [n_cold] HOST tail-relative unique rows
    weights: Optional[torch.Tensor] = None
    #: the side stream's copies are done once this event is (None: the
    #: tensors were made on the current stream, or on the CPU)
    ready: Optional[torch.cuda.Event] = None


def _split_grads(idx_hot, slot_of_pos, is_cold, grad_y, weights, mode, cap):
    """Per-position gradient split into (head coefficients, cold sums): the
    head keeps each hot position's combine coefficient (0 where cold), and
    the cold positions' gradient rows are summed per shipped slot."""
    b, h = idx_hot.shape
    coeff = combine_coefficients(weights, mode, b, h, device=grad_y.device)
    flat_cold = is_cold.reshape(-1)
    zero = torch.zeros_like(coeff)
    pos = torch.arange(b * h, device=grad_y.device)
    gy_rows = grad_y.to(torch.float32).index_select(0, pos // h)
    cold_grads = torch.zeros((cap, grad_y.shape[1]), dtype=torch.float32,
                             device=grad_y.device)
    cold_grads.index_add_(0, slot_of_pos.reshape(-1).long(),
                          gy_rows * torch.where(flat_cold, coeff, zero)[:, None])
    head_coeff = torch.where(flat_cold, zero, coeff).reshape(b, h)
    return head_coeff, cold_grads


class HostOffloadTable:
    """Stateful wrapper: a device head and a host numpy tail.

    ``table`` must be frequency-ordered (hot categories in the lowest rows,
    :mod:`cuembed_tpu_torch.utils.frequency`); ids at lookup time are the
    remapped rows, as the tiered engine takes them. The head lives on
    ``device`` (default: the card; pass ``device="cpu"`` for the CPU) in
    ``device_dtype`` (default: the table's).
    """

    def __init__(
        self,
        table: np.ndarray,
        hot_rows: int,
        *,
        cold_cap: int = 4096,
        device_dtype: Optional[torch.dtype] = None,
        device: torch.device | str | None = None,
    ):
        table = np.asarray(table)
        if not 0 < hot_rows < table.shape[0]:
            raise ValueError("need 0 < hot_rows < num_categories")
        self.num_categories, self.width = table.shape
        self.hot = int(hot_rows)
        self.cold_cap = int(cold_cap)
        self.device = default_device(device)
        dtype = device_dtype or torch.from_numpy(table[:1]).dtype
        # The lookup buffer: the head in its first rows, a batch's shipped
        # cold rows in the last cold_cap.
        self._buf = torch.zeros((self.hot + self.cold_cap, self.width), dtype=dtype,
                                device=self.device)
        self._buf[: self.hot] = torch.from_numpy(table[: self.hot]).to(self.device, dtype)
        self.head = self._buf[: self.hot]
        # fp32 host master for exact accumulation regardless of the device
        # serving dtype
        self.tail = table[self.hot:].astype(np.float32).copy()
        self.tail_accum: Optional[np.ndarray] = None  # AdaGrad state
        self.head_accum: Optional[torch.Tensor] = None
        # prepare() may run on the input-pipeline thread while training
        # updates mutate the tail on the main thread; the lock keeps a
        # shipped row from being read mid-update (torn floats). Held for
        # the gather / the scatter only.
        self._tail_lock = threading.Lock()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # -- host side (input-pipeline thread) ------------------------------
    def _ship(self, tensors):
        """Host tensors to the device: from pinned memory on the side stream
        with the event after the copies, or plainly without a card."""
        if self._stream is None:
            return [t.to(self.device) for t in tensors], None
        with torch.cuda.stream(self._stream):
            out = [t.pin_memory().to(self.device, non_blocking=True) for t in tensors]
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def prepare(self, indices: np.ndarray, weights=None) -> OffloadBatch:
        """Gather this batch's unique cold rows from the host tail and ship
        them with the batch.

        Served by the multithreaded C++ kernel when built
        (``native/cuembed_host.cpp:cuembed_offload_prepare``); numpy
        otherwise, with the same results.
        """
        with self._tail_lock:
            idx_hot, slot, is_cold, uniq, rows = native.offload_prepare(
                np.asarray(indices), self.hot, self.tail, self.cold_cap
            )
        host = [torch.from_numpy(a) for a in (idx_hot, slot, is_cold)]
        host.append(torch.from_numpy(rows).to(self.head.dtype))  # cast on the host
        if weights is not None:
            host.append(torch.from_numpy(np.ascontiguousarray(weights, np.float32)))
        shipped, ready = self._ship(host)
        return OffloadBatch(
            idx_hot=shipped[0], slot_of_pos=shipped[1], is_cold=shipped[2],
            cold_rows=shipped[3], uniq_cold=uniq,
            weights=shipped[4] if weights is not None else None, ready=ready,
        )

    # -- device side -----------------------------------------------------
    def _wait(self, batch: OffloadBatch) -> None:
        """Order the current stream after the batch's copies."""
        if batch.ready is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(batch.ready)
        for t in (batch.idx_hot, batch.slot_of_pos, batch.is_cold, batch.cold_rows,
                  batch.weights):
            if t is not None:
                t.record_stream(current)

    def lookup(self, batch: OffloadBatch, *, mode: CombineMode = CombineMode.SUM
               ) -> torch.Tensor:
        """The pooled lookup ``[B, W]`` in the head's dtype: one K1 launch on
        the head and the batch's shipped rows, with ``combine_coefficients``'
        per-position coefficients (weighted SUM; no coefficients under an
        unweighted SUM)."""
        if mode == CombineMode.CONCAT:
            raise ValueError("offload pools rows; CONCAT unsupported")
        if batch.weights is not None and mode != CombineMode.SUM:
            raise ValueError("weights are only supported with SUM")
        self._wait(batch)
        b, h = batch.idx_hot.shape
        self._buf[self.hot:].copy_(batch.cold_rows)
        ids = torch.where(batch.is_cold, self.hot + batch.slot_of_pos.to(torch.int64),
                          batch.idx_hot.to(torch.int64))
        coeff = None
        if batch.weights is not None or mode != CombineMode.SUM:
            coeff = combine_coefficients(batch.weights, mode, b, h,
                                         device=ids.device).view(b, h)
        return embedding_lookup(self._buf, ids, coeff, mode=CombineMode.SUM)

    # -- training --------------------------------------------------------
    def _cold_grads(self, batch, grad_y, mode):
        head_coeff, cold_grads = _split_grads(
            batch.idx_hot, batch.slot_of_pos, batch.is_cold, grad_y, batch.weights,
            mode, self.cold_cap)
        k = batch.uniq_cold.shape[0]
        return head_coeff, cold_grads[:k].cpu().numpy()

    def sgd_update(self, batch: OffloadBatch, grad_y: torch.Tensor, *, lr: float,
                   mode: CombineMode = CombineMode.SUM) -> None:
        """Sparse SGD: the head on the card, the shipped-back cold rows on
        the host."""
        self._wait(batch)
        head_coeff, g = self._cold_grads(batch, grad_y, mode)
        sgd_sparse_update(self.head, batch.idx_hot, grad_y, lr=lr, weights=head_coeff,
                          mode=CombineMode.SUM)
        with self._tail_lock:
            self.tail[batch.uniq_cold] -= lr * g

    def adagrad_init(self) -> None:
        self.head_accum = torch.zeros((self.hot,), dtype=torch.float32,
                                      device=self.device)
        self.tail_accum = np.zeros((self.num_categories - self.hot,), np.float32)

    def adagrad_update(self, batch: OffloadBatch, grad_y: torch.Tensor, *, lr: float,
                       eps: float = 1e-8, mode: CombineMode = CombineMode.SUM) -> None:
        """Row-wise AdaGrad, its state kept beside each part."""
        if self.head_accum is None or self.tail_accum is None:
            raise ValueError("call adagrad_init() first")
        self._wait(batch)
        head_coeff, g = self._cold_grads(batch, grad_y, mode)
        rowwise_adagrad_sparse_update(self.head, self.head_accum, batch.idx_hot, grad_y,
                                      lr=lr, eps=eps, weights=head_coeff,
                                      mode=CombineMode.SUM)
        with self._tail_lock:
            acc = self.tail_accum[batch.uniq_cold] + np.mean(g * g, axis=1)
            self.tail_accum[batch.uniq_cold] = acc
            self.tail[batch.uniq_cold] -= lr * g / np.sqrt(acc + eps)[:, None]

    # -- export ----------------------------------------------------------
    def full_table(self) -> np.ndarray:
        """Logical ``[V, W]`` fp32 copy (the head downloaded, the host tail)."""
        return np.concatenate([self.head.to(torch.float32).cpu().numpy(), self.tail])
