"""EmbeddingTable: one table plus the state of its hot-first layout, the
counterpart of ``cuembed_tpu/table.py``.

The JAX package's tiered engine needs three pieces of ceremony: frequency
statistics, a frequency-ordered table layout, and the id->row remap applied
to incoming indices. This wrapper owns all three, with the JAX package's
API and results:

    t = EmbeddingTable.create(gen, num_categories=10_000_000, width=256,
                              dtype=torch.bfloat16)
    t.observe(calibration_indices)      # host-side frequency counting
    t.refresh_layout()                  # reorder + remap + capacities
    out = t.lookup(indices)             # the same values as before

On the card every lookup runs on K1 (fixed hotness) or K2 (CSR), with or
without a calibrated config: the reorder, the remap and the config change
the stored row order and no result. The reorder gathers on the table's
device (``index_select``), as the JAX package's does; a 5 GB table needs a
second 5 GB for a moment, where a round trip through the host would cost
seconds. ``lookup`` applies the remap on the device unless the caller
remapped on the host (:meth:`remap_indices`, the input pipeline's place
for it) and says so with ``assume_remapped=True``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.ops.narrow import narrow_lookup, pack_narrow, packing_factor
from cuembed_tpu_torch.ops.tiered import (
    DEFAULT_HOT_BYTES,
    TieredConfig,
    auto_config,
    tiered_forward,
    tiering_profitable,
)
from cuembed_tpu_torch.types import CombineMode, default_device, init_table_
from cuembed_tpu_torch.utils import frequency as freq
from cuembed_tpu_torch.utils.calibration import refine_tiered_config


def host_array(x) -> np.ndarray:
    """A numpy view (or copy, for a device tensor) of indices or offsets."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _batch_hotness(calibration_indices, calibration_offsets, default: int) -> int:
    """The hotness the JAX calibration sizes its chunks for: the live
    count's average for CSR, the trailing axis of fixed-hotness ids."""
    if calibration_offsets is not None:
        off = host_array(calibration_offsets)
        batch = max(1, off.shape[0] - 1)
        return max(1, int(round(float(off[-1]) / batch)))
    if calibration_indices is not None:
        ci = host_array(calibration_indices)
        if ci.ndim >= 2:
            return int(ci.shape[-1])
    return default


class EmbeddingTable:
    """One embedding table plus the state of its hot-first layout.

    Attributes:
      table: the device table in the *current storage layout* (frequency-
        ordered after :meth:`refresh_layout`; training updates apply to
        this tensor directly).
      remap: ``original_category -> storage_row`` (host numpy int32), or
        None before any reorder.
      tiered_cfg: the calibrated :class:`TieredConfig`, or None when the JAX
        layout would serve the whole table from its hot budget.
    """

    def __init__(
        self,
        table: torch.Tensor,
        *,
        mode: CombineMode = CombineMode.SUM,
        hot_bytes: int = DEFAULT_HOT_BYTES,
        low_precision_math: bool = False,
        layout: str = "auto",
        vmem_table_bytes: int | None = None,
    ):
        """``table`` is the *logical* ``[V, W]`` tensor, on the device it is
        to be served from. ``layout``: "auto" line-packs narrow tables
        (width < 128 with 128 % width == 0) at construction, as the JAX
        package does (``ops.narrow``; the lookups read the packed storage
        through its logical view, with no copy); "raw" keeps the table as
        given; "packed" requires a packable width.

        ``hot_bytes`` and ``vmem_table_bytes`` are the JAX package's layout
        numbers (its hot-head budget, and the table size under which it
        serves a table without tiering; default: its built-in one). They
        size ``tiered_cfg`` as the JAX package sizes it, and say nothing of
        the card's memories.
        """
        if layout not in ("auto", "raw", "packed"):
            raise ValueError(f"unknown layout: {layout}")
        self._num_categories, self._width = table.shape
        k = packing_factor(self._width)
        if layout == "packed" and k == 1:
            raise ValueError(
                "layout='packed' needs width < 128 with 128 % width == 0"
            )
        self._pack_k = k if layout in ("auto", "packed") else 1
        self.table = pack_narrow(table) if self._pack_k > 1 else table
        self.mode = mode
        self.hot_bytes = hot_bytes
        self.vmem_table_bytes = vmem_table_bytes
        self.low_precision_math = low_precision_math
        self.counts: Optional[np.ndarray] = None
        self.remap: Optional[np.ndarray] = None
        self._remap_dev: Optional[torch.Tensor] = None
        self.tiered_cfg: Optional[TieredConfig] = None
        self._natural_order = False
        self._q_head = None  # ops.quant.QuantizedHead (opt-in, lossy)
        self._q_cfg: Optional[TieredConfig] = None

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        generator: torch.Generator | None,
        num_categories: int,
        width: int,
        *,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str | None = None,
        mode: CombineMode = CombineMode.SUM,
        hot_bytes: int = DEFAULT_HOT_BYTES,
        low_precision_math: bool = False,
        layout: str = "auto",
        vmem_table_bytes: int | None = None,
    ) -> "EmbeddingTable":
        """A table drawn U(-1/sqrt(W), 1/sqrt(W)) in fp32 from ``generator``
        (on ``device``, default the card) and cast to ``dtype``: the JAX
        package's law, not its draws."""
        table = init_table_(torch.empty((num_categories, width), dtype=torch.float32,
                                        device=default_device(device)), generator)
        return cls(
            table.to(dtype), mode=mode, hot_bytes=hot_bytes,
            low_precision_math=low_precision_math, layout=layout,
            vmem_table_bytes=vmem_table_bytes,
        )

    @property
    def num_categories(self) -> int:
        return self._num_categories

    @property
    def width(self) -> int:
        return self._width

    def logical_table(self) -> torch.Tensor:
        """The ``[V, W]`` view of the storage (unpacks narrow layouts)."""
        if self._pack_k == 1:
            return self.table
        return self.table.view(-1, self._width)[: self._num_categories]

    def _auto_config(self, hotness: int, **fractions) -> TieredConfig | None:
        extra = {} if self.vmem_table_bytes is None else {
            "vmem_table_bytes": self.vmem_table_bytes}
        return auto_config(self.num_categories, self.width, self.table.element_size(),
                           hotness, hot_bytes=self.hot_bytes, **fractions, **extra)

    # -- frequency statistics (host side) ----------------------------------
    def observe(self, indices) -> None:
        """Fold one batch of *original-id* indices into the running counts."""
        self.counts = freq.count_frequencies(
            host_array(indices), self.num_categories, self.counts
        )

    def decay(self, rate: float = 0.9) -> None:
        """Decay running counts (call between traffic windows)."""
        if self.counts is not None:
            self.counts = freq.decay_counts(self.counts, rate)

    # -- layout maintenance -------------------------------------------------
    def _calibrated(self, cfg, remap, calibration_indices, calibration_offsets,
                    hotness):
        """The JAX calibration of ``cfg``: tier fractions, then one
        refinement pass, from the calibration ids in storage rows
        (``remap``); only live CSR values count."""
        if cfg is None or calibration_indices is None:
            return cfg
        ci = host_array(calibration_indices)
        if calibration_offsets is not None:
            ci = ci.reshape(-1)[: int(host_array(calibration_offsets)[-1])]
        head_f, cold_f = freq.tier_fractions(
            ci, remap, cfg.mxu_head_rows, cfg.hot_rows, margin=1.15
        )
        cfg = self._auto_config(hotness, cold_fraction=cold_f, head_fraction=head_f)
        return refine_tiered_config(
            cfg, remap[ci.reshape(1, -1)],
            calib_offsets=(None if calibration_offsets is None
                           else host_array(calibration_offsets)),
            value_capacity=(0 if calibration_offsets is None
                            else int(host_array(calibration_indices).size)),
        )

    def refresh_layout(
        self, calibration_indices=None, calibration_offsets=None
    ) -> None:
        """Reorder storage by observed frequency and calibrate the config.

        ``lookup`` results are unchanged (the remap composes with the
        reorder). ``calibration_indices`` (original ids, any shape
        ``[..., hotness]``) tightens the static capacities to observed
        per-chunk maxima; for CSR pass ``calibration_offsets`` (one
        ``[batch+1]`` array, with the matching flat values), whose live
        count sets the average hotness.
        """
        if self.counts is None:
            raise ValueError("observe() at least one batch first")
        perm, remap = freq.frequency_order(self.counts)
        # counts speak original ids, so the new remap replaces (not stacks
        # on) the old: the gather takes the current layout to the new one.
        storage_perm = perm if self.remap is None else self._compose_perm(perm)
        rows = torch.as_tensor(storage_perm.astype(np.int64), device=self.table.device)
        if self._pack_k == 1:
            self.table = self.table.index_select(0, rows)
        else:
            self.table = pack_narrow(self.logical_table().index_select(0, rows))
        self.remap = remap
        self._remap_dev = None
        self._natural_order = False  # superseded by the measured reorder
        # The int8 head is a snapshot of the previous row order; serving it
        # against the new remap would return other categories' rows. Drop
        # it, so that the "enable_int8_head() first" check fails loudly.
        self._q_head = None
        self._q_cfg = None

        hotness = _batch_hotness(calibration_indices, calibration_offsets, 1)
        cfg = self._auto_config(hotness)
        self.tiered_cfg = self._calibrated(cfg, remap, calibration_indices,
                                           calibration_offsets, hotness)

    def use_natural_order(
        self, calibration_indices=None, calibration_offsets=None,
        hotness: int = 1,
    ) -> None:
        """Declare the id space already hot-first (id 0 the most frequent),
        as production logs often assign ids: no permutation, no remap, no
        relayout; the config is calibrated against the natural order.

        Results never depend on the claim. ``calibration_indices`` (and
        ``calibration_offsets`` for CSR) tighten the capacities as in
        :meth:`refresh_layout`; ``hotness`` seeds the chunking when no
        calibration batch is given.
        """
        if self.remap is not None:
            raise ValueError(
                "the table was already reordered (refresh_layout); "
                "natural order no longer holds for its storage layout"
            )
        hotness = max(1, _batch_hotness(calibration_indices, calibration_offsets,
                                        hotness))
        cfg = self._auto_config(hotness)
        identity = np.arange(self.num_categories, dtype=np.int32)
        self.tiered_cfg = self._calibrated(cfg, identity, calibration_indices,
                                           calibration_offsets, hotness)
        self._natural_order = True

    def _compose_perm(self, perm: np.ndarray) -> np.ndarray:
        """Permutation taking the *current* layout to the new one: the
        current storage row of original category c is ``old_remap[c]``."""
        return np.asarray(self.remap)[perm]

    def calibrate(self, calibration_indices, calibration_offsets=None) -> None:
        """One-call ceremony: observe + refresh_layout.

        For CSR pass the flat values plus ``calibration_offsets``; only
        the live prefix (``offsets[-1]``) informs counts and capacities.
        """
        obs = host_array(calibration_indices)
        if calibration_offsets is not None:
            obs = obs.reshape(-1)[: int(host_array(calibration_offsets)[-1])]
        self.observe(obs)
        self.refresh_layout(calibration_indices, calibration_offsets)

    # -- opt-in int8 head (lossy serving mode) -------------------------------
    def enable_int8_head(self, calibration_indices=None) -> None:
        """Build the int8 head (:mod:`cuembed_tpu_torch.ops.quant`) over the
        hottest rows: the JAX package's lossy serving mode, with its rows
        and slot capacities (per-row error at most max|row|/254 an element).
        Call after :meth:`calibrate` (or :meth:`use_natural_order`); re-call
        after :meth:`refresh_layout` or training updates, since it is a
        snapshot. ``calibration_indices`` (original ids) re-derive the slot
        capacities for the larger band. Lookups use it only with
        ``lookup(use_int8_head=True)``, forward only.
        """
        from cuembed_tpu_torch.ops.quant import int8_head_rows, quantize_head

        if self.tiered_cfg is None or (
            self.remap is None and not self._natural_order
        ):
            raise ValueError(
                "calibrate()/refresh_layout()/use_natural_order() first — "
                "the int8 head extends the tiered layout (or the table is "
                "VMEM-served already and needs no head)"
            )
        if self._pack_k > 1:
            raise ValueError("int8 head supports wide tables only")
        rows = min(
            self.num_categories // 8 * 8,
            int8_head_rows(self.width, self.hot_bytes),
        )
        cfg = replace(self.tiered_cfg, hot_rows=rows)
        if calibration_indices is not None:
            flat_ids = host_array(calibration_indices).reshape(-1)
            remapped = flat_ids if self.remap is None else self.remap[flat_ids]
            mid_s, cold_s = freq.calibrate_capacities(
                remapped, None, cfg.mxu_head_rows, rows,
                cfg.chunk_elems, margin=1.15,
            )
            cfg = replace(cfg, mid_slots=mid_s, cold_slots=cold_s)
        else:
            # The wider band [mxu_head_rows, rows) takes rows the exact
            # layout classed cold, so the sound bound without fresh
            # calibration is mid'(chunk) <= mid(chunk) + cold(chunk).
            cfg = replace(
                cfg,
                mid_slots=min(
                    cfg.chunk_elems,
                    -(-(cfg.mid_slots + cfg.cold_slots) // 8) * 8,
                ),
            )
        self._q_head = quantize_head(self.table[:rows])
        self._q_cfg = cfg

    # -- index translation --------------------------------------------------
    def _remap_on(self, device: torch.device) -> torch.Tensor:
        if self._remap_dev is None or self._remap_dev.device != device:
            self._remap_dev = torch.as_tensor(self.remap, device=device)
        return self._remap_dev

    def remap_indices(self, indices):
        """id->row translation: on the host for numpy ids (the input
        pipeline's place for it), on their device for a tensor."""
        if self.remap is None:
            return indices
        if isinstance(indices, torch.Tensor):
            rm = self._remap_on(indices.device)
            return rm.index_select(0, indices.reshape(-1)).view(indices.shape)
        return self.remap[np.asarray(indices)]

    # -- lookup --------------------------------------------------------------
    def lookup(
        self,
        indices,
        weights=None,
        offsets=None,
        *,
        assume_remapped: bool = False,
        use_int8_head: bool = False,
    ) -> torch.Tensor:
        """Differentiable pooled lookup, with the JAX package's routing.

        ``assume_remapped=True`` promises the indices already went through
        :meth:`remap_indices`; otherwise the remap (if any) is applied on
        the device. Numpy inputs are moved to the table's device.

        ``use_int8_head=True`` serves the int8 band from the head built by
        :meth:`enable_int8_head`: lossy and forward-only, fixed hotness,
        SUM/MEAN/weighted SUM.
        """
        device = self.table.device
        indices, weights, offsets = (
            None if x is None else torch.as_tensor(x, device=device)
            for x in (indices, weights, offsets))
        if use_int8_head:
            if self._q_head is None:
                raise ValueError("enable_int8_head() first")
            if offsets is not None:
                raise ValueError("int8 head is fixed-hotness only")
            if weights is not None and self.mode != CombineMode.SUM:
                raise ValueError(
                    "weights are only supported with CombineMode.SUM"
                )
            if self.remap is not None and not assume_remapped:
                indices = self.remap_indices(indices)
            return tiered_forward(
                self.table, indices, None, weights, mode=self.mode,
                cfg=self._q_cfg,
                low_precision_math=self.low_precision_math,
                q_head=self._q_head,
            )
        remap_dev = None
        if self.remap is not None and not assume_remapped:
            remap_dev = self._remap_on(device)
        tiered = (
            self.tiered_cfg
            if (self.remap is not None or self._natural_order)
            else None
        )
        if self._pack_k > 1:
            if remap_dev is not None:
                indices = self.remap_indices(indices)
            # As the JAX table: no line-tiering outside the batch shapes its
            # engine tiers profitably (it changes no result here).
            if (
                tiered is not None
                and offsets is None
                and indices.dim() == 2
                and not tiering_profitable(indices.numel(), indices.shape[1])
            ):
                tiered = None
            return narrow_lookup(
                self.table, self._num_categories, self._width,
                indices, weights, offsets, mode=self.mode,
                low_precision_math=self.low_precision_math,
                tiered_cfg=tiered,
            )
        kwargs = dict(
            mode=self.mode,
            low_precision_math=self.low_precision_math,
            backend="auto",
            tiered_cfg=tiered,
            remap=remap_dev,
        )
        if offsets is not None:
            return embedding_lookup_csr(
                self.table, indices, offsets, weights, **kwargs
            )
        return embedding_lookup(self.table, indices, weights, **kwargs)


def resize_table(
    table: torch.Tensor,
    new_num_categories: int,
    generator: torch.Generator | None = None,
    *,
    accum: torch.Tensor | None = None,
):
    """Vocabulary warm-start: grow or shrink a table's row count.

    Growing appends rows drawn U(-1/sqrt(W), 1/sqrt(W)) in fp32 from
    ``generator`` (the collection's init law) — or zeros when
    ``generator`` is None, as the JAX function appends zeros without a key —
    so existing categories keep their trained vectors exactly. Shrinking
    keeps the first rows (a view): on a frequency-ordered table that drops
    the coldest categories.

    ``accum``: an optional row-aligned optimizer state (row-wise AdaGrad
    accumulator, Adam moments) resized alongside; new rows get zero state.
    Returns ``table`` or ``(table, accum)``. The caller owns the id space.
    """
    old_v, width = table.shape[0], table.shape[1]
    if new_num_categories == old_v:
        return table if accum is None else (table, accum)
    if new_num_categories < old_v:
        new_t = table[:new_num_categories]
        if accum is None:
            return new_t
        return new_t, accum[:new_num_categories]
    extra = new_num_categories - old_v
    if generator is None:
        rows = table.new_zeros((extra, width))
    else:
        rows = init_table_(torch.empty((extra, width), dtype=torch.float32,
                                       device=table.device), generator).to(table.dtype)
    new_t = torch.cat([table, rows], dim=0)
    if accum is None:
        return new_t
    new_a = torch.cat([accum, accum.new_zeros((extra,) + tuple(accum.shape[1:]))], dim=0)
    return new_t, new_a
