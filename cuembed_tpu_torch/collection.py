"""Multi-table embedding collection, the counterpart of
``cuembed_tpu/collection.py``.

A set of named embedding tables managed together:

* per-table tiered configs carved out of one shared hot-head budget
  (proportional to each table's traffic share), as the JAX package sizes
  them; on the card they change no result and no kernel;
* host-side frequency statistics and layout maintenance (reordering a
  table and its id->row remap without changing lookup results; the reorder
  gathers on the tables' device);
* collection-wide forward (:meth:`EmbeddingCollection.apply`, one K1 or K2
  launch a table on the card; its fixed-hotness tables go to
  ``embedding_lookup_many`` together, which serves those on the card that
  need no gradient in one host pass and one call into the library) and
  row-sparse training updates
  (:meth:`~EmbeddingCollection.sgd_update`,
  :meth:`~EmbeddingCollection.adagrad_update`, K3 in compressed mode a
  table) built on :mod:`cuembed_tpu_torch.train`, which update the tables
  in place.

Tables are a ``dict[str, torch.Tensor]``, as the JAX package's are a dict
of arrays. The sharded entry points (:meth:`EmbeddingCollection.shard`,
:meth:`~EmbeddingCollection.apply_sharded` and the routed updates) run on
the parallel layer (:mod:`cuembed_tpu_torch.parallel`), one rank at a time
on its blocks; :meth:`~EmbeddingCollection.plan_placement` chooses each
table's placement with the planner
(:mod:`cuembed_tpu_torch.parallel.planner`) from measured head-hit rates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cuembed_tpu_torch.ops.api import (
    embedding_lookup,
    embedding_lookup_csr,
    embedding_lookup_many,
)
from cuembed_tpu_torch.ops.tiered import DEFAULT_HOT_BYTES, TieredConfig, auto_config
from cuembed_tpu_torch.table import host_array
from cuembed_tpu_torch.train import (
    _flatten_coo,
    rowwise_adagrad_init,
    rowwise_adagrad_sparse_update,
    sgd_sparse_update,
)
from cuembed_tpu_torch.types import CombineMode, default_device, init_table_
from cuembed_tpu_torch.utils import frequency as freq
from cuembed_tpu_torch.utils import trace

# The TPU lane width the JAX package pads rows to; head_hit_rates sizes the
# hot heads with it, as the placement planner reads them.
LANES = 128

def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclass(frozen=True)
class TableConfig:
    """One table's static configuration."""

    name: str
    num_categories: int
    width: int
    mode: CombineMode = CombineMode.SUM
    dtype: torch.dtype = torch.float32
    hotness: int = 1            # expected hotness (capacity planning only)
    traffic_share: float = 1.0  # relative lookup volume (hot-budget split)
    #: features served by this table (torchrec's shared-table pattern:
    #: e.g. one "video_id" table behind "watched", "liked", "shared"
    #: features). Empty = one feature named like the table. Used by the
    #: ``*_features`` entry points; the per-table API ignores it.
    feature_names: Tuple[str, ...] = ()


class EmbeddingCollection:
    """A set of named embedding tables managed as one unit."""

    def __init__(
        self,
        configs: Sequence[TableConfig],
        *,
        hot_bytes_total: int = DEFAULT_HOT_BYTES,
        cold_fraction: float = 0.25,
        head_fraction: float = 0.45,
    ):
        names = [c.name for c in configs]
        if len(set(names)) != len(names):
            raise ValueError("table names must be unique")
        self.configs: Dict[str, TableConfig] = {c.name: c for c in configs}
        self.feature_to_table: Dict[str, str] = {}
        for c in configs:
            for f in (c.feature_names or (c.name,)):
                if f in self.feature_to_table:
                    raise ValueError(
                        f"feature {f!r} claimed by both "
                        f"{self.feature_to_table[f]!r} and {c.name!r}"
                    )
                self.feature_to_table[f] = c.name
        total_share = sum(max(c.traffic_share, 0.0) for c in configs) or 1.0
        self.tiered: Dict[str, Optional[TieredConfig]] = {}
        for c in configs:
            budget = int(hot_bytes_total * max(c.traffic_share, 0.0) / total_share)
            self.tiered[c.name] = auto_config(
                c.num_categories,
                c.width,
                _itemsize(c.dtype),
                c.hotness,
                cold_fraction=cold_fraction,
                head_fraction=head_fraction,
                hot_bytes=max(budget, 1),
                # a table is served untiered only if it fits its own share
                # of the collection budget
                vmem_table_bytes=max(budget, 1),
            )

    # -- params ------------------------------------------------------------
    def init(
        self,
        generator: torch.Generator | None = None,
        *,
        device: torch.device | str | None = None,
    ) -> Dict[str, torch.Tensor]:
        """Tables drawn U(-1/sqrt(W), 1/sqrt(W)) in fp32 from ``generator``
        (one table after the other, on ``device``, default the card) and
        cast to each config's dtype: the JAX package's law, not its draws."""
        device = default_device(device)
        tables = {}
        for name, c in self.configs.items():
            t = torch.empty((c.num_categories, c.width), dtype=torch.float32,
                            device=device)
            tables[name] = init_table_(t, generator).to(c.dtype)
        return tables

    # -- frequency layout maintenance (host side) ---------------------------
    def init_counts(self) -> Dict[str, np.ndarray]:
        return {
            name: np.zeros((c.num_categories,), np.int64)
            for name, c in self.configs.items()
        }

    def update_counts(
        self, counts: Dict[str, np.ndarray], indices: Dict[str, np.ndarray]
    ) -> Dict[str, np.ndarray]:
        for name, idx in indices.items():
            counts[name] = freq.count_frequencies(
                host_array(idx), self.configs[name].num_categories, counts[name]
            )
        return counts

    def reorder(
        self, tables: Dict[str, torch.Tensor], counts: Dict[str, np.ndarray]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray]]:
        """Frequency-reorder every table; returns (tables, remaps).

        ``lookup(reordered[name], remap[name][idx])`` equals
        ``lookup(original[name], idx)``. The rows are gathered on the
        tables' device (the JAX package goes through the host; the bits are
        the same). Remaps are host numpy: apply them in the input pipeline
        (:mod:`cuembed_tpu_torch.utils.pipeline`).
        """
        new_tables, remaps = {}, {}
        for name, t in tables.items():
            perm, remap = freq.frequency_order(counts[name])
            new_tables[name] = freq.reorder_table(t, perm)
            remaps[name] = remap
        return new_tables, remaps

    # -- placement planning ---------------------------------------------------
    def head_hit_rates(
        self,
        counts: Dict[str, np.ndarray],
        *,
        hot_bytes_total: int = DEFAULT_HOT_BYTES,
    ) -> Dict[str, float]:
        """Per-table head-hit rate from observed frequency counts: the
        fraction of observed traffic that a frequency-ordered head sized to
        the table's traffic share of ``hot_bytes_total`` (in the JAX
        package's lane-padded rows) would serve, the number the placement
        planner reads.

        Tables without enough evidence are omitted: on a small sample the
        top-``hot_rows`` mass is ~100% for *any* distribution. Evidence
        means more than 2x the head size in distinct observed categories,
        or at least 16x the head size in total observations.
        """
        total_share = sum(
            max(c.traffic_share, 0.0) for c in self.configs.values()
        ) or 1.0
        out: Dict[str, float] = {}
        for name, c in self.configs.items():
            cnt = counts.get(name)
            if cnt is None or cnt.sum() == 0:
                continue
            pw = -(-c.width // LANES) * LANES
            budget = int(
                hot_bytes_total * max(c.traffic_share, 0.0) / total_share
            )
            hot_rows = max(budget // (pw * _itemsize(c.dtype)), 0) // 8 * 8
            if hot_rows <= 0:
                continue
            cnt = np.asarray(cnt)
            if (
                np.count_nonzero(cnt) <= 2 * hot_rows
                and cnt.sum() < 16 * hot_rows
            ):
                continue  # insufficient evidence (see docstring)
            top = np.sort(cnt)[::-1][:hot_rows]
            out[name] = float(top.sum() / cnt.sum())
        return out

    def plan_placement(
        self,
        n_shards: int,
        *,
        batch: int,
        counts: Optional[Dict[str, np.ndarray]] = None,
        cost=None,
        column_ok: bool = False,
        grid_ok: bool = False,
        col_shards: int = 1,
        hot_bytes_total: int = DEFAULT_HOT_BYTES,
    ):
        """Place this collection over ``n_shards`` devices.

        With ``counts`` (from :meth:`update_counts`), hybrid placement is
        considered using the measured head-hit rates; without stats no
        table goes hybrid. Returns a
        :class:`cuembed_tpu_torch.parallel.planner.Plan` — feed it to
        :func:`~cuembed_tpu_torch.parallel.planner.apply_plan` and the
        ``planned_*`` entry points. Host logic only: no device is needed.
        """
        from cuembed_tpu_torch.parallel.planner import plan

        hits = (
            self.head_hit_rates(counts, hot_bytes_total=hot_bytes_total)
            if counts
            else None
        )
        return plan(
            list(self.configs.values()),
            n_shards,
            batch=batch,
            cost=cost,
            head_hit_rate=hits,
            hot_bytes_total=hot_bytes_total,
            column_ok=column_ok,
            grid_ok=grid_ok,
            col_shards=col_shards,
        )

    # -- forward -------------------------------------------------------------
    def _lookup(self, name, table, idx, w, off, backend, tiered):
        c = self.configs[name]
        tc = self.tiered[name] if (tiered and c.mode != CombineMode.CONCAT) else None
        be = "tiered" if tc is not None else backend
        if off is not None:
            return embedding_lookup_csr(table, idx, off, w, mode=c.mode,
                                        backend=be, tiered_cfg=tc)
        return embedding_lookup(table, idx, w, mode=c.mode, backend=be, tiered_cfg=tc)

    def apply(
        self,
        tables: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        *,
        backend: str = "auto",
        tiered: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Pooled lookup for every table present in ``indices``.

        ``tiered=True`` passes each table's tiered config
        (``backend="tiered"``): the same results, on the same kernels, one
        table at a time through ``embedding_lookup`` /
        ``embedding_lookup_csr``. Untiered, the fixed-hotness tables go to
        ``embedding_lookup_many`` in one call (where they share (batch,
        width, dtype) on the card, their outputs are views of one buffer),
        the CSR tables one at a time.
        """
        span = (trace.begin("collection.apply")
                if trace.torch_profiler._is_profiler_enabled else None)
        try:
            configs, weight, offset = self.configs, (weights or {}).get, (offsets or {}).get
            fixed, pooled = [], {}
            for name, idx in indices.items():
                off = offset(name)
                if off is None and not tiered:
                    fixed.append((name, tables[name], idx, weight(name), configs[name].mode))
                else:
                    pooled[name] = self._lookup(name, tables[name], idx, weight(name), off,
                                                backend, tiered)
            if fixed:
                names, *lookups = zip(*fixed)
                outs = dict(zip(names, embedding_lookup_many(*lookups, backend=backend)))
                if not pooled:
                    return outs
                pooled.update(outs)
            return {name: pooled[name] for name in indices}
        finally:
            if span is not None:
                trace.end(span)

    # -- feature-level entry points (shared tables) ---------------------------
    def apply_features(
        self,
        tables: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        *,
        backend: str = "auto",
        tiered: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Pooled lookup per FEATURE; features resolve to their shared
        table (``TableConfig.feature_names``). Output keyed by feature."""
        out = {}
        for f, idx in indices.items():
            name = self.feature_to_table[f]
            out[f] = self._lookup(name, tables[name], idx,
                                  weights.get(f) if weights else None,
                                  offsets.get(f) if offsets else None,
                                  backend, tiered)
        return out

    def update_counts_features(
        self, counts: Dict[str, np.ndarray], indices: Dict[str, np.ndarray]
    ) -> Dict[str, np.ndarray]:
        """Aggregate per-FEATURE draws into each shared table's counts."""
        for f, idx in indices.items():
            name = self.feature_to_table[f]
            counts[name] = freq.count_frequencies(
                host_array(idx), self.configs[name].num_categories, counts[name]
            )
        return counts

    def _features_coo(self, name, indices, grads_y, weights, offsets):
        """Joint positions-as-samples COO over every feature of table
        ``name`` present in ``grads_y``: ``([n, 1] ids, [n, W] grad rows,
        [n, 1] coefficients)``, or None.

        Gradients from all features of a shared table are SUMMED before
        the optimizer step (the torchrec semantics): each feature's
        (position -> row, coefficient) pairs and per-position gradient
        rows concatenate into ONE batch, so AdaGrad sees the joint per-row
        gradient, not a sequence of partial ones.
        """
        c = self.configs[name]
        if c.mode == CombineMode.CONCAT:
            raise ValueError(
                "feature-level updates pool per sample; CONCAT tables "
                "have per-position outputs — update them per table"
            )
        feats = [
            f for f in (c.feature_names or (c.name,)) if f in grads_y
        ]
        if not feats:
            return None
        flats, rows, coeffs = [], [], []
        for f in feats:
            idx = indices[f]
            w = weights.get(f) if weights else None
            off = offsets.get(f) if offsets else None
            gy = grads_y[f].to(torch.float32)
            if off is None and w is None and c.mode == CombineMode.MEAN:
                gy = gy * (1.0 / idx.shape[1])
            flat, sids, coeff = _flatten_coo(idx, off, w, c.mode, torch.float32)
            flats.append(flat.to(torch.int64))
            rows.append(gy.index_select(0, sids.long()))
            coeffs.append(
                coeff if coeff is not None
                else torch.ones(flat.shape[0], dtype=torch.float32, device=flat.device)
            )
        return (
            torch.cat(flats)[:, None],
            torch.cat(rows, dim=0),
            torch.cat(coeffs)[:, None],
        )

    def sgd_update_features(
        self,
        tables: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        grads_y: Dict[str, torch.Tensor],
        *,
        lr: float,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Sparse SGD with per-FEATURE gradients on shared tables: one
        joint update per table, in place."""
        new = dict(tables)
        for name in {self.feature_to_table[f] for f in grads_y}:
            coo = self._features_coo(name, indices, grads_y, weights, offsets)
            if coo is None:
                continue
            pidx, pgy, pw = coo
            new[name] = sgd_sparse_update(
                tables[name], pidx, pgy, lr=lr, weights=pw,
                mode=CombineMode.SUM,
            )
        return new

    def adagrad_update_features(
        self,
        tables: Dict[str, torch.Tensor],
        accums: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        grads_y: Dict[str, torch.Tensor],
        *,
        lr: float,
        eps: float = 1e-8,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Row-wise AdaGrad with per-FEATURE gradients on shared tables, in
        place: the per-row gradient is summed across features before
        squaring (the compressed sums do that by construction), as one
        joint batch."""
        new_t, new_a = dict(tables), dict(accums)
        for name in {self.feature_to_table[f] for f in grads_y}:
            coo = self._features_coo(name, indices, grads_y, weights, offsets)
            if coo is None:
                continue
            pidx, pgy, pw = coo
            new_t[name], new_a[name] = rowwise_adagrad_sparse_update(
                tables[name], accums[name], pidx, pgy, lr=lr, eps=eps,
                weights=pw, mode=CombineMode.SUM,
            )
        return new_t, new_a

    # -- sparse training ------------------------------------------------------
    def sgd_update(
        self,
        tables: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        grads_y: Dict[str, torch.Tensor],
        *,
        lr: float,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        tiered: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Sparse SGD on every table in ``grads_y``, in place."""
        new = dict(tables)
        for name, gy in grads_y.items():
            c = self.configs[name]
            new[name] = sgd_sparse_update(
                tables[name],
                indices[name],
                gy,
                lr=lr,
                offsets=offsets.get(name) if offsets else None,
                weights=weights.get(name) if weights else None,
                mode=c.mode,
                tiered_cfg=self.tiered[name] if tiered else None,
            )
        return new

    def adagrad_init(
        self, *, device: torch.device | str | None = None
    ) -> Dict[str, torch.Tensor]:
        """Row-wise AdaGrad state of every table (on ``device``, default the
        card)."""
        return {
            name: rowwise_adagrad_init(c.num_categories, device=device)
            for name, c in self.configs.items()
        }

    def adagrad_update(
        self,
        tables: Dict[str, torch.Tensor],
        accums: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        grads_y: Dict[str, torch.Tensor],
        *,
        lr: float,
        eps: float = 1e-8,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        tiered: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Row-wise AdaGrad on every table in ``grads_y``, in place."""
        new_t, new_a = dict(tables), dict(accums)
        with trace.span("collection.adagrad_update"):
            for name, gy in grads_y.items():
                c = self.configs[name]
                new_t[name], new_a[name] = rowwise_adagrad_sparse_update(
                    tables[name],
                    accums[name],
                    indices[name],
                    gy,
                    lr=lr,
                    eps=eps,
                    offsets=offsets.get(name) if offsets else None,
                    weights=weights.get(name) if weights else None,
                    mode=c.mode,
                    tiered_cfg=self.tiered[name] if tiered else None,
                )
        return new_t, new_a

    # -- multi-device (row-sharded tables over a mesh axis) --------------------
    def shard(
        self, tables: Dict[str, torch.Tensor], mesh, *, axis: str = "model"
    ) -> Dict[str, torch.Tensor]:
        """This rank's row block (spec ``(axis, None)``) of every table.

        Rows are padded to a multiple of the axis size (padding rows are
        never addressed: ids stay in ``[0, num_categories)``). Each block is
        a contiguous copy. Feed the result to :meth:`apply_sharded` /
        :meth:`adagrad_update_sharded`.
        """
        from cuembed_tpu_torch.parallel import local_block, pad_table_for_shards
        from cuembed_tpu_torch.parallel.sharding import axis_size

        n = axis_size(mesh, axis)
        return {
            name: local_block(pad_table_for_shards(t, n), mesh, (axis, None)).clone()
            for name, t in tables.items()
        }

    def adagrad_init_sharded(
        self, mesh, *, axis: str = "model", device: torch.device | str | None = None
    ) -> Dict[str, torch.Tensor]:
        """This rank's block of the accumulators, row-aligned with
        :meth:`shard`'s padded tables (on ``device``, default the card)."""
        from cuembed_tpu_torch.parallel.sharding import axis_size

        n = axis_size(mesh, axis)
        return {
            name: rowwise_adagrad_init(-(-c.num_categories // n), device=device)
            for name, c in self.configs.items()
        }

    def apply_sharded(
        self,
        tables: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        *,
        mesh,
        axis: str = "model",
    ) -> Dict[str, torch.Tensor]:
        """All-to-all routed pooled lookup for every table in ``indices``.

        Tables from :meth:`shard`; this rank's ``(axis, None)`` block of the
        batch (sharded-CSR ``[1, cap]`` blocks with ``offsets``: see
        :func:`~cuembed_tpu_torch.parallel.shard_csr`).
        """
        from cuembed_tpu_torch.parallel import alltoall_row_sharded_lookup

        return {
            name: alltoall_row_sharded_lookup(
                tables[name], idx,
                weights.get(name) if weights else None,
                offsets.get(name) if offsets else None,
                mesh=mesh, mode=self.configs[name].mode, axis=axis,
            )
            for name, idx in indices.items()
        }

    def sgd_update_sharded(
        self,
        tables: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        grads_y: Dict[str, torch.Tensor],
        *,
        mesh,
        lr: float,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        axis: str = "model",
    ) -> Dict[str, torch.Tensor]:
        """Routed sparse SGD for every table in ``grads_y``, in place."""
        from cuembed_tpu_torch.parallel import sharded_sgd_sparse_update

        new = dict(tables)
        for name, gy in grads_y.items():
            new[name] = sharded_sgd_sparse_update(
                tables[name], indices[name], gy, mesh=mesh, lr=lr,
                offsets=offsets.get(name) if offsets else None,
                weights=weights.get(name) if weights else None,
                mode=self.configs[name].mode, axis=axis,
            )
        return new

    def adagrad_update_sharded(
        self,
        tables: Dict[str, torch.Tensor],
        accums: Dict[str, torch.Tensor],
        indices: Dict[str, torch.Tensor],
        grads_y: Dict[str, torch.Tensor],
        *,
        mesh,
        lr: float,
        eps: float = 1e-8,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        offsets: Optional[Dict[str, torch.Tensor]] = None,
        axis: str = "model",
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Routed row-wise AdaGrad for every table in ``grads_y``, in place."""
        from cuembed_tpu_torch.parallel import sharded_rowwise_adagrad_sparse_update

        new_t, new_a = dict(tables), dict(accums)
        for name, gy in grads_y.items():
            new_t[name], new_a[name] = sharded_rowwise_adagrad_sparse_update(
                tables[name], accums[name], indices[name], gy,
                mesh=mesh, lr=lr, eps=eps,
                offsets=offsets.get(name) if offsets else None,
                weights=weights.get(name) if weights else None,
                mode=self.configs[name].mode, axis=axis,
            )
        return new_t, new_a
