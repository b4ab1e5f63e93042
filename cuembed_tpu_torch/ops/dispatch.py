"""Backend dispatch for the lookup and its backward, the counterpart of
``cuembed_tpu/ops/dispatch.py``.

The JAX backend names carry over so that callers do not change:

* ``"auto"`` and ``"pallas"``: the hand-written kernels (K1 fixed, K2 CSR,
  K3 backward) for CUDA tensors, the plain PyTorch version for CPU tensors;
* ``"xla"``: the plain PyTorch version on every device.

Unlike the TPU, where the Pallas backward was opt-in, K3 is the ``"auto"``
backward on CUDA for every width and storage dtype. CONCAT is a pure gather
and goes to ``index_select`` on every device. The TPU engines
(``"tiered"``, ``"narrow"``, a ``tiered_cfg``) are not ported.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops import cuda_backward, cuda_forward
from cuembed_tpu_torch.ops.lookup_torch import (
    CompressedGrad,
    embedding_backward_compressed_torch,
    embedding_backward_torch,
    embedding_forward_torch,
)
from cuembed_tpu_torch.types import CombineMode

BACKENDS = ("auto", "pallas", "xla", "tiered", "narrow")


def _check_backend(backend, tiered_cfg=None):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend}")
    if backend in ("tiered", "narrow") or tiered_cfg is not None:
        raise NotImplementedError(
            "the tiered and narrow engines are not ported yet (ROADMAP P7)"
        )


def forward(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor | None,
    weights: torch.Tensor | None,
    *,
    mode: CombineMode,
    low_precision_math: bool = False,
    backend: str = "auto",
    tiered_cfg=None,
) -> torch.Tensor:
    """Route a forward lookup to the kernel or the plain version."""
    _check_backend(backend, tiered_cfg)
    if mode == CombineMode.CONCAT:
        return table.index_select(0, indices.reshape(-1))
    if backend == "xla":
        return embedding_forward_torch(
            table, indices, offsets, weights, mode=mode,
            low_precision_math=low_precision_math,
        )
    if offsets is None:
        return cuda_forward.embedding_forward_cuda(
            table, indices, weights, mode=mode,
            low_precision_math=low_precision_math,
        )
    return cuda_forward.embedding_forward_cuda_csr(
        table, indices, offsets, weights, mode=mode,
        low_precision_math=low_precision_math,
    )


def backward(
    grad_y: torch.Tensor,
    num_categories: int,
    transpose_indices: torch.Tensor,
    transpose_sample_ids: torch.Tensor,
    transpose_weights: torch.Tensor | None,
    *,
    nnz=None,
    backend: str = "auto",
    accumulation_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Route the full COO backward to K3 or the plain version.

    On both routes the gradient is in ``grad_y``'s dtype and its sums are
    taken in at least ``accumulation_dtype`` (default: ``grad_y``'s). The
    plain version casts ``grad_y`` to it, sums, and rounds the gradient back
    (the JAX backward's cast, sum, cast). K3 always sums in fp32, which is
    at least the accumulation dtype of every table it takes, and rounds
    once, so a half ``grad_y`` needs no [num_categories, width] fp32
    gradient and no cast.
    """
    _check_backend(backend)
    if backend == "xla" or not grad_y.is_cuda:
        acc = grad_y if accumulation_dtype is None else grad_y.to(accumulation_dtype)
        return embedding_backward_torch(
            acc, num_categories, transpose_indices, transpose_sample_ids,
            transpose_weights, nnz=nnz,
        ).to(grad_y.dtype)
    return cuda_backward.embedding_backward_cuda(
        grad_y, num_categories, transpose_indices, transpose_sample_ids,
        transpose_weights, nnz=nnz)


def backward_compressed(
    grad_y: torch.Tensor,
    transpose_indices: torch.Tensor,
    transpose_sample_ids: torch.Tensor,
    transpose_weights: torch.Tensor | None,
    *,
    nnz=None,
    backend: str = "auto",
) -> CompressedGrad:
    """Route the compressed COO backward to K3 or the plain version."""
    _check_backend(backend)
    fn = (embedding_backward_compressed_torch if backend == "xla"
          else cuda_backward.embedding_backward_cuda_compressed)
    return fn(grad_y, transpose_indices, transpose_sample_ids, transpose_weights,
              nnz=nnz)
