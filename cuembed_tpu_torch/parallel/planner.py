"""Automatic placement planner for multi-table embedding collections, the
counterpart of ``cuembed_tpu/parallel/planner.py``.

The reference is single-table, single-GPU (``README.md:110``); in
production GPU recommenders the multi-device placement decision is made by
an external planner (torchrec's ``EmbeddingShardingPlanner`` is the
canonical one). Given the static
:class:`~cuembed_tpu_torch.collection.TableConfig` set, the mesh geometry
and a cost model taken on the card (:class:`CostModel`), :func:`plan`
chooses per table among

* ``replicated``     — small tables: every rank holds a full copy. Zero
  lookup communication; the sparse update all-gathers the batch COO once
  so replicas stay bit-identical.
* ``row_sharded``    — the default for big tables: all-to-all routed
  lookups (:func:`~cuembed_tpu_torch.parallel.alltoall_row_sharded_lookup`)
  + routed sparse updates. Per-step wire volume is ``O(nnz * width)``,
  independent of the table size.
* ``hybrid``         — row-sharded with a replicated frequency-ordered hot
  head (:func:`~cuembed_tpu_torch.parallel.hybrid_tiered_lookup`): routed
  volume shrinks by the calibrated head-hit rate. Chosen only when the
  caller supplies a measured hit rate — the planner never guesses skew.
* ``column_sharded`` — very wide tables: the width axis is sliced
  ``(None, model)``.
* ``grid_sharded``   — huge AND wide tables (torchrec's "grid"): rows over
  the routing axis x columns over the data axis
  (:func:`~cuembed_tpu_torch.parallel.grid_sharded_lookup`), cutting both
  the per-device footprint and the routed row payload by the column count.
  Opt-in like column sharding (requires a 2D mesh).

:func:`plan` is pure host logic, deterministic and testable with no
device. The rest runs SPMD, once per rank, on the rank's blocks of a
``(data, model)`` ``DeviceMesh``, as the JAX functions' ``shard_map``
bodies run once per device: :func:`apply_plan` cuts the calling rank's
blocks out of global tables (:func:`~cuembed_tpu_torch.parallel.sharding.
local_block`); :func:`planned_lookup`, :func:`planned_sgd_update` and
:func:`planned_adagrad_update` dispatch each table to the lookup or update
its placement requires. The local work is K1, K2 and K3 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from cuembed_tpu_torch.collection import TableConfig, _itemsize
from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.ops.tiered import DEFAULT_HOT_BYTES
from cuembed_tpu_torch.parallel.alltoall_lookup import (
    alltoall_row_sharded_lookup,
    grid_sharded_lookup,
    hybrid_tiered_lookup,
    split_hybrid_table,
)
from cuembed_tpu_torch.parallel.collectives import all_gather, replicated
from cuembed_tpu_torch.parallel.sharded_lookup import column_sharded_lookup
from cuembed_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_size,
    local_block,
    pad_table_for_shards,
)
from cuembed_tpu_torch.parallel.train import (
    _gather_batch,
    column_sharded_rowwise_adagrad_sparse_update,
    column_sharded_sgd_sparse_update,
    grid_sharded_rowwise_adagrad_sparse_update,
    grid_sharded_sgd_sparse_update,
    sharded_hybrid_rowwise_adagrad_sparse_update,
    sharded_hybrid_sgd_sparse_update,
    sharded_rowwise_adagrad_sparse_update,
    sharded_sgd_sparse_update,
)
from cuembed_tpu_torch.train import (
    _flatten_coo,
    rowwise_adagrad_sparse_update as _adagrad_1card,
    sgd_sparse_update as _sgd_1card,
)
from cuembed_tpu_torch.types import CombineMode

# The JAX package's 128-lane TPU layout: plan() sizes a table's footprint
# and its hybrid head in rows padded to it, as
# EmbeddingCollection.head_hit_rates sizes the head whose hit rate plan()
# reads. The card stores rows unpadded, so for a table narrower than 128
# this overstates its footprint by 128 / width.
LANES = 128

REPLICATED = "replicated"
ROW_SHARDED = "row_sharded"
HYBRID = "hybrid"
COLUMN_SHARDED = "column_sharded"
GRID_SHARDED = "grid_sharded"

# The NVLink rate between two H100 SXM cards, one direction (NVIDIA H100 SXM
# data sheet: 900 GB/s in both directions together). One card cannot
# measure it; chip_smoke.py's calibration prices comm_bytes_per_step with it.
NVLINK_BYTES_PER_S = 450e9


class PlanError(ValueError):
    """The requested collection cannot be placed within the budget."""


@dataclass(frozen=True)
class CostModel:
    """Per-card constants the placement decision ranks against.

    The memory size and the size thresholds are an NVIDIA H100's, taken by
    ``chip_smoke.py::phase_planner`` on an "NVIDIA H100 80GB HBM3, 700.00 W"
    (``nvidia-smi --query-gpu=name,power.limit``): each placement's lookup
    and row-wise AdaGrad update on one card of a (data, model) = (2, 4)
    mesh, batch 65536, timed on the card (the least of 10 steps), plus the
    plan's ``comm_bytes_per_step`` over the data sheet's NVLink rate
    (:data:`NVLINK_BYTES_PER_S`). Override per deployment. Only *ratios*
    matter for placement — the absolute comm estimates exist for
    :meth:`Plan.summary`, not for correctness.
    """

    #: device memory of one card: ``torch.cuda.get_device_properties(0).
    #: total_memory`` on the H100 above.
    hbm_bytes: int = 85_017_493_504
    #: fraction of device memory the embedding tables may claim (the rest
    #: is activations, the dense tower, the allocator's scratch).
    hbm_budget_fraction: float = 0.6
    #: biggest copy worth replicating: the largest uniform width-128 bf16
    #: table (hotness 32; swept 16 MiB .. 1 GiB) whose replicated step the
    #: calibration models faster than its row-sharded step, by 1 ms or
    #: more (at 256 MiB the two tie; past it the replicated update, which
    #: sums the whole batch, loses). The routed step waits on the host, so
    #: the crossover moves with the host's load: on a slower machine,
    #: replicated won up to 512 MiB.
    replicate_bytes_max: int = 128 * 2**20
    #: a column slice must keep full lane tiles per shard (the JAX
    #: package's 128-lane layout, :data:`LANES`).
    column_min_slice_lanes: int = LANES
    #: largest vocab placed column-sharded. Not a crossover: none was
    #: found. The calibration swept the wide mix's shape (width 512 fp32,
    #: hotness 16) over 128K .. 64M rows (32 GiB a shard), and the
    #: column-sharded step won at every size, by about 5 ms of 10.5 (it
    #: routes nothing and sums a quarter of the width, at a cost that does
    #: not grow with the vocab). The default is the sweep's top: past it
    #: the planner keeps the row-sharded rule, unmeasured.
    column_rows_max: int = 1 << 26
    #: head-hit rate below which hybrid's replicated head is not worth its
    #: memory: the routed-volume saving is proportional to the rate.
    hybrid_min_hit_rate: float = 0.5
    #: fp32 gradient rows ride the update wire.
    grad_elem_bytes: int = 4
    #: all-to-all capacity headroom over the balanced share. 2.0 is a
    #: guess; calibrate from measured traffic with
    #: :func:`cuembed_tpu_torch.utils.frequency.calibrate_capacity_factor`
    #: (frequency-ordered tables concentrate hot rows on shard 0 and can
    #: need much more).
    capacity_factor: float = 2.0
    #: row-sharded per-device footprint above which a grid-eligible table
    #: (wide enough for full lane tiles per column slice) also shards its
    #: width axis. Not a crossover: none was found. The calibration swept
    #: the huge mix's shape (width 256 bf16, hotness 64, 4 x 2 shards) over
    #: 4 MiB .. 2 GiB a shard row-sharded, and the grid step won at every
    #: size, by over 5 ms (half the width and half the routed payload a
    #: card). The default is the sweep's bottom. A smaller point could not
    #: change a 4-shard plan: below ``replicate_bytes_max`` / 4 (32 MiB a
    #: shard) a table replicates before grid is considered.
    grid_bytes_min: int = 4 * 2**20


@dataclass(frozen=True)
class TablePlan:
    """One table's placement decision and its cost-model estimates."""

    name: str
    placement: str
    bytes_per_device: int
    #: estimated per-device link bytes per train step (fwd + sparse SGD).
    comm_bytes_per_step: int
    #: hybrid only: replicated head rows (0 otherwise).
    hot_rows: int = 0
    #: hybrid only: calibrated fraction of lookups served by the head.
    head_hit_rate: float = 0.0


@dataclass(frozen=True)
class Plan:
    """A full placement for a collection over ``n_shards`` devices."""

    tables: Dict[str, TablePlan]
    n_shards: int
    bytes_per_device: int
    budget_bytes: int
    cost: CostModel = field(default_factory=CostModel)
    #: devices along the column (data) axis for grid placements; 1 when no
    #: grid table exists.
    col_shards: int = 1

    def summary(self) -> str:
        lines = [
            f"plan over {self.n_shards} shards: "
            f"{self.bytes_per_device / 2**20:.1f} MB/device of "
            f"{self.budget_bytes / 2**20:.1f} MB budget",
        ]
        for tp in self.tables.values():
            extra = (
                f" hot_rows={tp.hot_rows} hit={tp.head_hit_rate:.2f}"
                if tp.placement == HYBRID
                else ""
            )
            lines.append(
                f"  {tp.name}: {tp.placement:<14} "
                f"{tp.bytes_per_device / 2**20:8.1f} MB/dev  "
                f"~{tp.comm_bytes_per_step / 2**20:.1f} MB/step ICI{extra}"
            )
        return "\n".join(lines)


def _padded_width(width: int) -> int:
    """Lane-padded width, the JAX package's layout (see :data:`LANES`)."""
    return -(-width // LANES) * LANES


def plan(
    configs: Sequence[TableConfig],
    n_shards: int,
    *,
    batch: int,
    cost: Optional[CostModel] = None,
    head_hit_rate: Optional[Dict[str, float]] = None,
    hot_bytes_total: int = DEFAULT_HOT_BYTES,
    column_ok: bool = False,
    grid_ok: bool = False,
    col_shards: int = 1,
) -> Plan:
    """Place every table; raise :class:`PlanError` if over budget.

    Args:
      configs: the collection's static table configs (``hotness`` and
        ``traffic_share`` size the communication estimates and the hybrid
        head budget split; ``dtype`` a torch dtype).
      n_shards: devices along the routing (model) axis.
      batch: global batch size (communication estimates only).
      cost: the card's constants (default :class:`CostModel`, the H100's).
      head_hit_rate: per-table calibrated fraction of lookups landing in a
        frequency-ordered head of the table's share of
        ``hot_bytes_total``
        (:meth:`~cuembed_tpu_torch.collection.EmbeddingCollection.
        head_hit_rates` on real traffic). Tables absent from the dict
        never go hybrid.
      hot_bytes_total: hybrid head memory budget per device, split across
        hybrid tables by ``traffic_share``.
      column_ok: allow ``column_sharded`` placements (requires the caller
        to run lookups with a 2D (data, model) mesh).
      grid_ok: allow ``grid_sharded`` placements — rows over the model axis
        x columns over ``col_shards`` devices of the data axis. Chosen when
        a table's row-sharded per-device footprint exceeds
        ``cost.grid_bytes_min`` and its width splits into full lane tiles;
        requires a 2D mesh whose data axis has ``col_shards`` devices.
        Hybrid wins over grid when a measured head-hit rate qualifies the
        table (skew evidence routes a fraction of the traffic; grid always
        routes all of it).
      col_shards: data-axis device count grid placements divide the width
        over (ignored unless ``grid_ok``).
    """
    cost = cost or CostModel()
    if grid_ok and col_shards < 2:
        raise PlanError("grid_ok requires col_shards >= 2")
    hits = head_hit_rate or {}
    if n_shards < 1:
        raise PlanError("n_shards must be >= 1")

    # Hybrid head budget split by traffic share over ALL tables — the same
    # split EmbeddingCollection.head_hit_rates uses to calibrate the hit
    # rates, so TablePlan.head_hit_rate describes the head the plan builds.
    hybrid_names = [
        c.name
        for c in configs
        if hits.get(c.name, 0.0) >= cost.hybrid_min_hit_rate
    ]
    hybrid_share = sum(max(c.traffic_share, 0.0) for c in configs) or 1.0

    tables: Dict[str, TablePlan] = {}
    for c in configs:
        elem = _itemsize(c.dtype)
        pw = _padded_width(c.width)
        total = c.num_categories * pw * elem
        nnz = batch * max(c.hotness, 1)
        nnz_l = -(-nnz // n_shards)
        routed = int(nnz_l * cost.capacity_factor)
        # Routed fwd: ids out + rows back; update: ids + fp32 grad rows.
        row_comm = routed * (
            4 + c.width * elem + 4 + c.width * cost.grad_elem_bytes
        )

        def replicated_plan():
            # Update = COO all-gather so replicas stay identical.
            repl_comm = int(
                nnz_l * (4 + c.width * cost.grad_elem_bytes)
                * (n_shards - 1)
            )
            return TablePlan(c.name, REPLICATED, total, repl_comm)

        if total <= cost.replicate_bytes_max or n_shards == 1:
            tables[c.name] = replicated_plan()
            continue

        if (
            column_ok
            and c.num_categories <= cost.column_rows_max
            and c.width >= cost.column_min_slice_lanes * n_shards
            and c.width % n_shards == 0
        ):
            # fwd output all-gather + update COO all-gather.
            col_comm = int(
                (batch * c.width * elem + nnz * (4 + c.width * 4))
                * (n_shards - 1)
                / n_shards
            )
            tables[c.name] = TablePlan(
                c.name, COLUMN_SHARDED, -(-total // n_shards), col_comm
            )
            continue

        hit = hits.get(c.name, 0.0)
        if c.name in hybrid_names:
            budget = int(
                hot_bytes_total * max(c.traffic_share, 0.0) / hybrid_share
            )
            budget_rows = max(budget // (pw * elem), 0) // 8 * 8
            if budget_rows >= c.num_categories:
                # The head budget covers the whole table: a hybrid with an
                # empty tail IS replication — place it as such (an empty
                # tail would make rows_per 0 in the routed paths).
                tables[c.name] = replicated_plan()
                continue
            # keep at least one tail row per shard (8-row granules)
            hot_rows = min(
                budget_rows,
                (c.num_categories - 8 * n_shards) // 8 * 8,
            )
            head_bytes = hot_rows * pw * elem
            # Hybrid pays only when the routed volume it removes exceeds
            # the per-step all-reduce of the replicated head's gradient
            # (~2x head bytes: reduce-scatter + all-gather over the axis).
            if hot_rows >= 1024 and hit * row_comm > 2 * head_bytes:
                per_dev = head_bytes + -(-(total - head_bytes) // n_shards)
                comm = int(row_comm * (1.0 - hit)) + head_bytes * 2
                tables[c.name] = TablePlan(
                    c.name, HYBRID, per_dev, comm,
                    hot_rows=hot_rows, head_hit_rate=hit,
                )
                continue

        # Grid is checked AFTER hybrid: a caller-measured head-hit rate is
        # direct evidence that hybrid routes a fraction of the traffic;
        # grid serves the remaining big-and-wide tables (no skew evidence)
        # where the width split cuts both the footprint and the routed
        # payload.
        if (
            grid_ok
            and col_shards > 1
            and -(-total // n_shards) > cost.grid_bytes_min
            and c.width % col_shards == 0
            and c.width >= cost.column_min_slice_lanes * col_shards
        ):
            w_slice = c.width // col_shards
            # ids route once per column group; row/grad payloads carry only
            # the local width slice; gather_output all-gathers the
            # [batch/n_r, W] rows over the column axis.
            grid_comm = routed * (
                4 + w_slice * elem + 4 + w_slice * cost.grad_elem_bytes
            ) + int(
                (batch // n_shards) * c.width * elem
                * (col_shards - 1) / col_shards
            )
            tables[c.name] = TablePlan(
                c.name, GRID_SHARDED,
                -(-total // (n_shards * col_shards)), grid_comm,
            )
            continue

        tables[c.name] = TablePlan(
            c.name, ROW_SHARDED, -(-total // n_shards), row_comm
        )

    per_dev = sum(tp.bytes_per_device for tp in tables.values())
    budget = int(cost.hbm_bytes * cost.hbm_budget_fraction)
    if per_dev > budget:
        worst = sorted(
            tables.values(), key=lambda t: -t.bytes_per_device
        )[:3]
        raise PlanError(
            f"placement needs {per_dev / 2**30:.2f} GiB/device, budget is "
            f"{budget / 2**30:.2f} GiB; largest: "
            + ", ".join(
                f"{t.name}={t.bytes_per_device / 2**20:.0f}MB({t.placement})"
                for t in worst
            )
            + " — add chips, or serve the largest tables host-offloaded "
            "(cuembed_tpu_torch.offload.HostOffloadTable) / int8-quantized "
            "(cuembed_tpu_torch.ops.quant)"
        )
    used_cols = (
        col_shards
        if any(tp.placement == GRID_SHARDED for tp in tables.values())
        else 1
    )
    return Plan(tables, n_shards, per_dev, budget, cost, used_cols)


# --------------------------------------------------------------------------
# Layout
# --------------------------------------------------------------------------


def _mesh_dim(mesh: DeviceMesh, axis: str) -> Optional[int]:
    """Size of the mesh dim ``axis``, None when the mesh has no such dim
    (JAX's ``mesh.shape.get(axis)``)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return None
    return axis_size(mesh, axis)


def _block(t: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, as a contiguous copy."""
    return local_block(t, mesh, spec).clone(memory_format=torch.contiguous_format)


def apply_plan(
    p: Plan,
    tables: Dict[str, torch.Tensor],
    mesh: DeviceMesh,
    *,
    axis: str = MODEL_AXIS,
    col_axis: str = DATA_AXIS,
) -> Dict[str, Any]:
    """This rank's blocks of every table per its plan, each a contiguous
    copy on the table's device (the analog of the JAX function's
    ``device_put`` of each table under its placement's sharding).

    ``tables`` are the global tables, the same on every rank. Replicated:
    the whole table. Row-sharded: the ``(axis, None)`` block of the table
    padded to a multiple of the axis size. Grid: the ``(axis, col_axis)``
    block. Column: the ``(None, axis)`` block. Hybrid: a ``(head, tail)``
    pair, the whole head and the ``(axis, None)`` block of the padded tail.

    Hybrid tables must already be frequency-ordered (hot categories in the
    lowest rows — :meth:`cuembed_tpu_torch.collection.EmbeddingCollection.
    reorder`); the planner cannot verify that, only the calibration that
    produced ``head_hit_rate`` can.
    """
    n = axis_size(mesh, axis)
    if n != p.n_shards:
        raise PlanError(
            f"plan was built for {p.n_shards} shards, mesh axis "
            f"'{axis}' has {n}"
        )
    if p.col_shards > 1 and _mesh_dim(mesh, col_axis) != p.col_shards:
        raise PlanError(
            f"plan's grid placements want {p.col_shards} column shards, "
            f"mesh axis '{col_axis}' has {_mesh_dim(mesh, col_axis)}"
        )
    placed: Dict[str, Any] = {}
    for name, t in tables.items():
        tp = p.tables[name]
        if tp.placement == REPLICATED:
            placed[name] = t.clone(memory_format=torch.contiguous_format)
        elif tp.placement == ROW_SHARDED:
            placed[name] = _block(pad_table_for_shards(t, n), mesh, (axis, None))
        elif tp.placement == HYBRID:
            head, tail = split_hybrid_table(t, tp.hot_rows, n)
            placed[name] = (
                head.clone(memory_format=torch.contiguous_format),
                _block(tail, mesh, (axis, None)),
            )
        elif tp.placement == GRID_SHARDED:
            if t.shape[1] % p.col_shards != 0:
                raise PlanError(
                    f"{name}: width {t.shape[1]} must be a multiple of "
                    f"the column count {p.col_shards} for grid sharding"
                )
            placed[name] = _block(pad_table_for_shards(t, n), mesh, (axis, col_axis))
        else:  # COLUMN_SHARDED
            if t.shape[1] % n != 0:
                raise PlanError(
                    f"{name}: width {t.shape[1]} must be a multiple of "
                    f"the axis size {n} for column sharding"
                )
            placed[name] = _block(t, mesh, (None, axis))
    return placed


# --------------------------------------------------------------------------
# Planned forward
# --------------------------------------------------------------------------


def planned_lookup(
    p: Plan,
    placed: Dict[str, Any],
    indices: Dict[str, torch.Tensor],
    weights: Optional[Dict[str, torch.Tensor]] = None,
    offsets: Optional[Dict[str, torch.Tensor]] = None,
    *,
    mesh: DeviceMesh,
    modes: Optional[Dict[str, CombineMode]] = None,
    axis: str = MODEL_AXIS,
    data_axis: str = DATA_AXIS,
    compress: str = "none",
) -> Dict[str, torch.Tensor]:
    """Pooled lookup for every table in ``indices``, by placement, on this
    rank's blocks.

    Index layouts: routed and replicated tables want this rank's ``(axis,
    None)`` block of the batch (sharded-CSR ``[1, cap]`` blocks from
    :func:`~cuembed_tpu_torch.parallel.shard_csr` with ``offsets``);
    column-sharded tables want its ``(data_axis, None)`` block, or a flat
    CSR batch, replicated. Each result is this rank's block of the pooled
    output under the same spec (``[1, local_batch, W]`` for sharded CSR).
    ``compress="int8"`` applies to routed payloads only (serving mode — see
    :func:`~cuembed_tpu_torch.parallel.hybrid_tiered_lookup`).
    """
    out: Dict[str, torch.Tensor] = {}
    modes = modes or {}
    for name, idx in indices.items():
        tp = p.tables[name]
        mode = modes.get(name, CombineMode.SUM)
        w = weights.get(name) if weights else None
        off = offsets.get(name) if offsets else None
        if tp.placement == REPLICATED:
            table = placed[name]
            if off is None or off.dim() == 2:
                # The result is sharded over the axis while the table is
                # replicated there: its gradient sums over the axis.
                table = replicated(table, axis_group(mesh, axis))
            if off is not None and off.dim() == 2:
                # Sharded-CSR blocks (the layout routed tables in the same
                # call require): one lookup (K2) per block; the output
                # [blocks, local_batch, W] matches the routed paths' block
                # convention.
                out[name] = torch.stack([
                    embedding_lookup_csr(table, idx[b], off[b],
                                         None if w is None else w[b], mode=mode)
                    for b in range(off.shape[0])
                ])
            elif off is not None:
                out[name] = embedding_lookup_csr(table, idx, off, w, mode=mode)
            else:
                out[name] = embedding_lookup(table, idx, w, mode=mode)
        elif tp.placement == ROW_SHARDED:
            out[name] = alltoall_row_sharded_lookup(
                placed[name], idx, w, off, mesh=mesh, mode=mode,
                capacity_factor=p.cost.capacity_factor, axis=axis,
                compress=compress,
            )
        elif tp.placement == HYBRID:
            head, tail = placed[name]
            out[name] = hybrid_tiered_lookup(
                head, tail, idx, w, off, mesh=mesh, mode=mode,
                capacity_factor=p.cost.capacity_factor,
                cold_frac=max(1.0 - tp.head_hit_rate, 1e-3),
                axis=axis, compress=compress,
            )
        elif tp.placement == GRID_SHARDED:
            out[name] = grid_sharded_lookup(
                placed[name], idx, w, off, mesh=mesh, mode=mode,
                capacity_factor=p.cost.capacity_factor,
                row_axis=axis, col_axis=data_axis, compress=compress,
            )
        else:  # COLUMN_SHARDED
            out[name] = column_sharded_lookup(
                placed[name], idx, w, off, mesh=mesh, mode=mode,
                data_axis=data_axis, model_axis=axis,
            )
    return out


# --------------------------------------------------------------------------
# Planned sparse updates
# --------------------------------------------------------------------------


def _gathered_coo(idx_g, offs_g, w_g, gy_g, mode):
    """Global positions-as-samples COO from all-gathered CSR blocks.

    Each shard-CSR block's liveness/weights/MEAN coefficients fold into
    per-position weights; the per-position gradient row is gathered from
    the global ``grad_y``. Feeding the result to the single-card sparse
    updates as a ``[nnz, 1]`` batch is exact: SGD is linear in positions,
    and AdaGrad compresses per unique row BEFORE squaring.
    """
    n, lb = offs_g.shape[0], offs_g.shape[1] - 1
    flats, sids, coeffs = [], [], []
    for s in range(n):
        f, si, co = _flatten_coo(
            idx_g[s], offs_g[s], None if w_g is None else w_g[s], mode,
            torch.float32,
        )
        flats.append(f)
        sids.append(si.long() + s * lb)
        coeffs.append(
            co if co is not None
            else torch.ones(f.shape[0], dtype=torch.float32, device=f.device)
        )
    flat = torch.cat(flats)
    coeff = torch.cat(coeffs)
    gy_rows = gy_g.index_select(0, torch.cat(sids))
    return flat[:, None], gy_rows, coeff[:, None]


def _gathered_batch(idx, gy, weights, offsets, group):
    """This rank's batch blocks all-gathered over ``group`` in group-rank
    order (ids and offsets as int64, as the port keeps them)."""
    return (*_gather_batch(idx.long(), gy, weights, group),
            None if offsets is None else all_gather(offsets.long(), group))


def _replicated_sgd(table, idx, gy, *, mesh, lr, weights, offsets, mode, axis):
    """Identical global sparse update on every replica, in place.

    One batch-COO all-gather over ``axis`` (volume ~ ``nnz * width * 4``,
    fine for the small tables that replicate), then the single-card sparse
    update (K3 compressed) runs on the same inputs on every rank, so the
    replicas never diverge: the all-reduced-dense-gradient semantics,
    row-sparsely. With ``offsets`` (sharded-CSR blocks) the gathered
    blocks become a positions-as-samples COO (:func:`_gathered_coo`).
    """
    idx_g, gy_g, w_g, offs_g = _gathered_batch(idx, gy, weights, offsets,
                                               axis_group(mesh, axis))
    if offs_g is not None:
        pidx, pgy, pw = _gathered_coo(idx_g, offs_g, w_g, gy_g, mode)
        return _sgd_1card(table, pidx, pgy, lr=lr, weights=pw, mode=CombineMode.SUM)
    return _sgd_1card(table, idx_g, gy_g, lr=lr, weights=w_g, mode=mode)


def _replicated_adagrad(
    table, accum, idx, gy, *, mesh, lr, eps, weights, offsets, mode, axis
):
    """Row-wise AdaGrad on every replica, as :func:`_replicated_sgd`."""
    idx_g, gy_g, w_g, offs_g = _gathered_batch(idx, gy, weights, offsets,
                                               axis_group(mesh, axis))
    if offs_g is not None:
        pidx, pgy, pw = _gathered_coo(idx_g, offs_g, w_g, gy_g, mode)
        return _adagrad_1card(table, accum, pidx, pgy, lr=lr, eps=eps, weights=pw,
                              mode=CombineMode.SUM)
    return _adagrad_1card(table, accum, idx_g, gy_g, lr=lr, eps=eps, weights=w_g,
                          mode=mode)


@torch.no_grad()
def planned_sgd_update(
    p: Plan,
    placed: Dict[str, Any],
    indices: Dict[str, torch.Tensor],
    grads_y: Dict[str, torch.Tensor],
    *,
    mesh: DeviceMesh,
    lr: float,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    offsets: Optional[Dict[str, torch.Tensor]] = None,
    modes: Optional[Dict[str, CombineMode]] = None,
    axis: str = MODEL_AXIS,
    data_axis: str = DATA_AXIS,
) -> Dict[str, Any]:
    """Sparse SGD for every table in ``grads_y``, by placement, in place on
    this rank's blocks (``grads_y``: this rank's block of each pooled
    output's gradient, laid out like :func:`planned_lookup`'s result; for
    sharded CSR the ``[local_batch, W]`` rows)."""
    new = dict(placed)
    modes = modes or {}
    for name, gy in grads_y.items():
        tp = p.tables[name]
        mode = modes.get(name, CombineMode.SUM)
        idx = indices[name]
        w = weights.get(name) if weights else None
        off = offsets.get(name) if offsets else None
        if tp.placement == REPLICATED:
            new[name] = _replicated_sgd(
                placed[name], idx, gy, mesh=mesh, lr=lr, weights=w,
                offsets=off, mode=mode, axis=axis,
            )
        elif tp.placement == ROW_SHARDED:
            new[name] = sharded_sgd_sparse_update(
                placed[name], idx, gy, mesh=mesh, lr=lr, offsets=off,
                weights=w, mode=mode,
                capacity_factor=p.cost.capacity_factor, axis=axis,
            )
        elif tp.placement == HYBRID:
            head, tail = placed[name]
            new[name] = sharded_hybrid_sgd_sparse_update(
                head, tail, idx, gy, mesh=mesh, lr=lr, offsets=off,
                weights=w, mode=mode,
                capacity_factor=p.cost.capacity_factor,
                cold_frac=max(1.0 - tp.head_hit_rate, 1e-3),
                axis=axis,
            )
        elif tp.placement == GRID_SHARDED:
            new[name] = grid_sharded_sgd_sparse_update(
                placed[name], idx, gy, mesh=mesh, lr=lr, offsets=off,
                weights=w, mode=mode,
                capacity_factor=p.cost.capacity_factor,
                row_axis=axis, col_axis=data_axis,
            )
        else:  # COLUMN_SHARDED
            # CSR here is the column lookup's replicated-flat layout
            # (indices [nnz], offsets [batch+1]), NOT sharded-CSR blocks.
            new[name] = column_sharded_sgd_sparse_update(
                placed[name], idx, gy, mesh=mesh, lr=lr, offsets=off,
                weights=w, mode=mode, data_axis=data_axis,
                model_axis=axis,
            )
    return new


def planned_adagrad_init(
    p: Plan, placed: Dict[str, Any], mesh: DeviceMesh, *, axis: str = MODEL_AXIS
) -> Dict[str, Any]:
    """Row-wise AdaGrad accumulators (fp32 zeros) row-aligned with this
    rank's blocks, on their device: a block of the table's rows for
    row-sharded and grid tables (spec ``(axis,)``; grid's are replicated
    over the column axis, kept identical by the full-row statistic), a
    ``(head, tail)`` pair for hybrid, the whole table's rows for replicated
    and column-sharded ones (per-row statistics span the full row)."""
    del mesh, axis  # the blocks carry their own rows
    out: Dict[str, Any] = {}
    for name, tp in p.tables.items():
        if name not in placed:
            continue
        if tp.placement == HYBRID:
            out[name] = tuple(
                torch.zeros(part.shape[0], dtype=torch.float32, device=part.device)
                for part in placed[name]
            )
        else:
            t = placed[name]
            out[name] = torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
    return out


@torch.no_grad()
def planned_adagrad_update(
    p: Plan,
    placed: Dict[str, Any],
    accums: Dict[str, Any],
    indices: Dict[str, torch.Tensor],
    grads_y: Dict[str, torch.Tensor],
    *,
    mesh: DeviceMesh,
    lr: float,
    eps: float = 1e-8,
    weights: Optional[Dict[str, torch.Tensor]] = None,
    offsets: Optional[Dict[str, torch.Tensor]] = None,
    modes: Optional[Dict[str, CombineMode]] = None,
    axis: str = MODEL_AXIS,
    data_axis: str = DATA_AXIS,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Row-wise AdaGrad for every table in ``grads_y``, by placement, in
    place on this rank's blocks and accumulators (the batch arguments as
    :func:`planned_sgd_update`)."""
    new_t, new_a = dict(placed), dict(accums)
    modes = modes or {}
    for name, gy in grads_y.items():
        tp = p.tables[name]
        mode = modes.get(name, CombineMode.SUM)
        idx = indices[name]
        w = weights.get(name) if weights else None
        off = offsets.get(name) if offsets else None
        if tp.placement == REPLICATED:
            new_t[name], new_a[name] = _replicated_adagrad(
                placed[name], accums[name], idx, gy, mesh=mesh, lr=lr,
                eps=eps, weights=w, offsets=off, mode=mode, axis=axis,
            )
        elif tp.placement == ROW_SHARDED:
            new_t[name], new_a[name] = sharded_rowwise_adagrad_sparse_update(
                placed[name], accums[name], idx, gy, mesh=mesh,
                lr=lr, eps=eps, offsets=off, weights=w, mode=mode,
                capacity_factor=p.cost.capacity_factor, axis=axis,
            )
        elif tp.placement == HYBRID:
            head, tail = placed[name]
            hacc, tacc = accums[name]
            nh, nt, nha, nta = sharded_hybrid_rowwise_adagrad_sparse_update(
                head, tail, hacc, tacc, idx, gy, mesh=mesh, lr=lr,
                eps=eps, offsets=off, weights=w, mode=mode,
                capacity_factor=p.cost.capacity_factor,
                cold_frac=max(1.0 - tp.head_hit_rate, 1e-3),
                axis=axis,
            )
            new_t[name] = (nh, nt)
            new_a[name] = (nha, nta)
        elif tp.placement == GRID_SHARDED:
            new_t[name], new_a[name] = grid_sharded_rowwise_adagrad_sparse_update(
                placed[name], accums[name], idx, gy, mesh=mesh,
                lr=lr, eps=eps, offsets=off, weights=w, mode=mode,
                capacity_factor=p.cost.capacity_factor,
                row_axis=axis, col_axis=data_axis,
            )
        else:  # COLUMN_SHARDED
            # CSR here is the column lookup's replicated-flat layout.
            new_t[name], new_a[name] = column_sharded_rowwise_adagrad_sparse_update(
                placed[name], accums[name], idx, gy, mesh=mesh,
                lr=lr, eps=eps, offsets=off, weights=w, mode=mode,
                data_axis=data_axis, model_axis=axis,
            )
    return new_t, new_a
