"""Pure-numpy golden models, a copy of ``cuembed_tpu/ref``.

These play the role of the reference's CPU reference implementations
(``utils/include/embedding_lookup_cpu.hpp`` and
``utils/include/index_transforms_cpu.hpp``): scalar-semantics, device-free
implementations that every accelerated path is validated against. They
import numpy and the port's ``CombineMode`` only.
"""

from cuembed_tpu_torch.ref.forward import embedding_forward_ref
from cuembed_tpu_torch.ref.backward import embedding_backward_ref
from cuembed_tpu_torch.ref.transforms import (
    extract_row_ids_from_fixed_ref,
    extract_row_ids_from_csr_ref,
    extract_row_ids_for_concat_ref,
    transpose_ref,
    compute_compressed_grad_indices_ref,
)

__all__ = [
    "embedding_forward_ref",
    "embedding_backward_ref",
    "extract_row_ids_from_fixed_ref",
    "extract_row_ids_from_csr_ref",
    "extract_row_ids_for_concat_ref",
    "transpose_ref",
    "compute_compressed_grad_indices_ref",
]
