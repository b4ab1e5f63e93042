"""The parallel layer of the PyTorch port, the counterpart of
``cuembed_tpu/parallel``.

Tables sharded over a ``(data, model)`` ``DeviceMesh`` (row-wise,
column-wise, row x column "grid", or a replicated hot head with a routed
tail), lookups routed with masked local lookups and an all-reduce or with
an all-to-all exchange of ids and rows, and the matching sparse updates
routed to the rank that owns each row. Each function runs once per rank
(SPMD over ``torch.distributed``, as ``shard_map`` runs its body once per
device) on the rank's blocks, which
:func:`~cuembed_tpu_torch.parallel.sharding.local_block` cuts from a global
array. The placement planner (:mod:`~cuembed_tpu_torch.parallel.planner`)
chooses each table's layout from a cost model taken on the card and
dispatches each table's lookup and update to it. The local work is K1, K2
and K3 on the card.
"""

from cuembed_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    assemble,
    batch_sharding,
    local_block,
    make_mesh,
    pad_table_for_shards,
    shard_csr,
    table_sharding,
)
from cuembed_tpu_torch.parallel.sharded_lookup import (
    column_sharded_lookup,
    row_sharded_lookup,
)
from cuembed_tpu_torch.parallel.alltoall_lookup import (
    alltoall_row_sharded_lookup,
    grid_sharded_lookup,
    hybrid_tiered_lookup,
    split_hybrid_table,
)
from cuembed_tpu_torch.parallel.train import (
    column_sharded_rowwise_adagrad_sparse_update,
    column_sharded_sgd_sparse_update,
    grid_sharded_rowwise_adagrad_sparse_update,
    grid_sharded_sgd_sparse_update,
    sharded_hybrid_rowwise_adagrad_sparse_update,
    sharded_hybrid_sgd_sparse_update,
    sharded_rowwise_adagrad_sparse_update,
    sharded_sgd_sparse_update,
)
from cuembed_tpu_torch.parallel.planner import (
    CostModel,
    Plan,
    PlanError,
    TablePlan,
    apply_plan,
    plan,
    planned_adagrad_init,
    planned_adagrad_update,
    planned_lookup,
    planned_sgd_update,
)
from cuembed_tpu_torch.parallel import multihost

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "alltoall_row_sharded_lookup",
    "grid_sharded_lookup",
    "grid_sharded_sgd_sparse_update",
    "grid_sharded_rowwise_adagrad_sparse_update",
    "hybrid_tiered_lookup",
    "split_hybrid_table",
    "sharded_sgd_sparse_update",
    "sharded_rowwise_adagrad_sparse_update",
    "sharded_hybrid_sgd_sparse_update",
    "sharded_hybrid_rowwise_adagrad_sparse_update",
    "column_sharded_sgd_sparse_update",
    "column_sharded_rowwise_adagrad_sparse_update",
    "multihost",
    "make_mesh",
    "table_sharding",
    "batch_sharding",
    "local_block",
    "assemble",
    "pad_table_for_shards",
    "row_sharded_lookup",
    "shard_csr",
    "column_sharded_lookup",
    "CostModel",
    "Plan",
    "PlanError",
    "TablePlan",
    "plan",
    "apply_plan",
    "planned_lookup",
    "planned_sgd_update",
    "planned_adagrad_init",
    "planned_adagrad_update",
]
