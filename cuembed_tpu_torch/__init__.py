"""cuembed_tpu_torch — the PyTorch/CUDA port of cuembed_tpu.

An embedding-bag lookup library for NVIDIA Hopper: a differentiable lookup
over fixed-hotness ``[batch, hotness]`` or CSR indices, with SUM, MEAN,
weighted SUM and CONCAT combine, fp32/bf16/fp16 tables and an
fp32-accumulation policy, and sparse optimizers (``train``). The
fixed-hotness and CSR lookups run on two hand-written CUDA kernels
(``csrc/forward.cu``), and the backward, a sort by index and a sum of each
index's run, on a third (``csrc/backward.cu``), for CUDA tensors; CPU
tensors take a plain PyTorch version. The JAX package's TPU engines (tiered,
line-packed narrow, int8; ``ops/tiered.py``, ``ops/narrow.py``,
``ops/quant.py``) keep their API and results and run on the same kernels,
and so do the table layer (``EmbeddingTable``, ``EmbeddingCollection``, the
fused groups of ``fused.py``), the models (``models/``: the DLRM tower and
``QREmbeddingBag``), the host binding (``native``) and the input pipeline
(``utils/pipeline.py``), the host-offloaded table (``offload.py``) and the
parallel layer (``parallel/``: row, column, grid and hybrid sharding, the
all-to-all router and the routed updates, run per rank over
``torch.distributed``). This package imports neither JAX nor
``cuembed_tpu``; the JAX package is the reference it is tested against.
"""

from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig
from cuembed_tpu_torch.fused import (
    FusedSpec,
    fuse_counts,
    fuse_tables,
    fused_adagrad_update,
    fused_lookup,
    fused_sgd_update,
    fused_sharded_adagrad_update,
    fused_sharded_lookup,
    fused_sharded_sgd_update,
    unfuse_table,
)
from cuembed_tpu_torch.models.embedding_bag import EmbeddingBag
from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.ops.cuda_backward import (
    embedding_backward_cuda,
    embedding_backward_cuda_compressed,
)
from cuembed_tpu_torch.ops.cuda_forward import (
    embedding_forward_cuda,
    embedding_forward_cuda_csr,
)
from cuembed_tpu_torch.ops.lookup_torch import (
    CompressedGrad,
    embedding_backward_compressed_torch,
    embedding_backward_torch,
    embedding_forward_torch,
)
from cuembed_tpu_torch.ops.tiered import (
    TieredConfig,
    csr_combine_config,
    tiered_forward,
)
from cuembed_tpu_torch.ops.transforms import (
    compact_sparse_indices,
    compute_compressed_grad_indices,
    extract_row_ids_for_concat,
    extract_row_ids_from_csr,
    extract_row_ids_from_fixed,
    transpose,
    transpose_masked_compact,
)
from cuembed_tpu_torch.offload import HostOffloadTable, OffloadBatch
from cuembed_tpu_torch.table import EmbeddingTable, resize_table
from cuembed_tpu_torch.train import (
    adam_init,
    adam_sparse_update,
    embedding_grad_y,
    rowwise_adagrad_init,
    rowwise_adagrad_sparse_update,
    sgd_sparse_update,
)
from cuembed_tpu_torch.types import (
    STORAGE_DTYPES,
    CombineMode,
    CSRFormat,
    FixedFormat,
    accumulation_dtype,
    combine_coefficients,
)
from cuembed_tpu_torch.utils.datagen import PowerLawGenerator, power_law_indices
from cuembed_tpu_torch import parallel

__version__ = "0.1.0"

__all__ = [
    "CombineMode",
    "STORAGE_DTYPES",
    "FixedFormat",
    "CSRFormat",
    "accumulation_dtype",
    "combine_coefficients",
    "embedding_lookup",
    "embedding_lookup_csr",
    "TieredConfig",
    "csr_combine_config",
    "tiered_forward",
    "EmbeddingTable",
    "resize_table",
    "EmbeddingCollection",
    "TableConfig",
    "FusedSpec",
    "fuse_tables",
    "fuse_counts",
    "fused_lookup",
    "fused_sgd_update",
    "fused_adagrad_update",
    "unfuse_table",
    "fused_sharded_lookup",
    "fused_sharded_sgd_update",
    "fused_sharded_adagrad_update",
    "HostOffloadTable",
    "OffloadBatch",
    "parallel",
    "embedding_forward_torch",
    "embedding_forward_cuda",
    "embedding_forward_cuda_csr",
    "CompressedGrad",
    "embedding_backward_torch",
    "embedding_backward_compressed_torch",
    "embedding_backward_cuda",
    "embedding_backward_cuda_compressed",
    "transpose",
    "transpose_masked_compact",
    "compute_compressed_grad_indices",
    "compact_sparse_indices",
    "embedding_grad_y",
    "sgd_sparse_update",
    "rowwise_adagrad_init",
    "rowwise_adagrad_sparse_update",
    "adam_init",
    "adam_sparse_update",
    "extract_row_ids_from_fixed",
    "extract_row_ids_from_csr",
    "extract_row_ids_for_concat",
    "EmbeddingBag",
    "PowerLawGenerator",
    "power_law_indices",
]
