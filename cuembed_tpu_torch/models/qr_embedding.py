"""Quotient-remainder compositional embeddings (``QREmbeddingBag``), the
counterpart of ``cuembed_tpu/models/qr_embedding.py``.

The memory-compression trick for huge vocabularies (Shi et al.,
"Compositional Embeddings Using Complementary Partitions for
Memory-Efficient Recommendation Systems", KDD 2020; torchrec ships it as
``QREmbeddingBag``): a ``[V, W]`` table is replaced by a quotient table
``[ceil(V/Q), W]`` and a remainder table ``[Q, W]``, and id ``i`` is
represented by ``op(q[i // Q], r[i % Q])``. Every id maps to a distinct
(quotient, remainder) pair, while memory drops from ``V*W`` to
``(ceil(V/Q) + Q) * W``.

* ``operation="add"``: pooling is linear, so SUM / MEAN / weighted SUM
  decompose: ``pool(q_i + r_i) = pool(q_i) + pool(r_i)``. Two pooled
  lookups (K1, or K2 for CSR, on the card) and one add.
* ``operation="mult"``: two CONCAT lookups (``index_select``), an
  elementwise product, then the pooled combine. Fixed hotness only (CSR
  with CONCAT is unsupported, as in the reference).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.types import CombineMode, default_device


class QREmbeddingBag(nn.Module):
    """One quotient-remainder table pair and its pooled lookup; the
    parameters ``q`` ``[ceil(V/Q), W]`` and ``r`` ``[Q, W]``."""

    def __init__(
        self,
        num_categories: int,
        width: int,
        num_buckets: int,
        operation: str = "add",
        mode: CombineMode = CombineMode.SUM,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if num_buckets < 1:
            raise ValueError("num_buckets must be >= 1")
        if num_buckets > num_categories:
            raise ValueError(
                f"num_buckets ({num_buckets}) > num_categories "
                f"({num_categories}): the remainder table alone "
                "would outgrow the exact table QR exists to compress — "
                "pick Q ~ sqrt(num_categories)"
            )
        if operation not in ("add", "mult"):
            raise ValueError("operation must be 'add' or 'mult'")
        if mode == CombineMode.CONCAT:
            raise ValueError(
                "QR composes per id; CONCAT pooling would return per-id "
                "rows — compose manually from two CONCAT lookups"
            )
        self.num_categories = num_categories
        self.width = width
        self.num_buckets = num_buckets
        self.operation = operation
        self.mode = mode
        device = default_device(device)
        self.q = nn.Parameter(torch.empty((self.num_quotients, width), dtype=dtype,
                                          device=device))
        self.r = nn.Parameter(torch.empty((num_buckets, width), dtype=dtype,
                                          device=device))
        self.reset_parameters()

    @property
    def num_quotients(self) -> int:
        return -(-self.num_categories // self.num_buckets)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """U(-1, 1) for both tables (the reference's table init), the
        remainder factors ``1 + 0.1 U(-1, 1)`` under "mult" so an untrained
        pair starts near the quotient vector: the JAX law, not its draws."""
        with torch.no_grad():
            self.q.uniform_(-1.0, 1.0, generator=generator)
            self.r.uniform_(-1.0, 1.0, generator=generator)
            if self.operation == "mult":
                self.r.mul_(0.1).add_(1.0)

    def import_params(self, params) -> None:
        """Copy the JAX ``init``'s ``{"q": ..., "r": ...}`` (numpy arrays or
        tensors) into the parameters."""
        with torch.no_grad():
            for name in ("q", "r"):
                src = params[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src, dtype=np.float32))
                getattr(self, name).copy_(src)

    def forward(
        self,
        indices: torch.Tensor,
        weights: torch.Tensor | None = None,
        offsets: torch.Tensor | None = None,
        backend: str = "auto",
    ) -> torch.Tensor:
        """Pooled ``[batch, width]`` lookup through both partitions."""
        qidx = torch.div(indices, self.num_buckets, rounding_mode="floor")
        ridx = torch.remainder(indices, self.num_buckets)
        if self.operation == "add":
            if offsets is not None:
                out_q = embedding_lookup_csr(self.q, qidx, offsets, weights,
                                             mode=self.mode, backend=backend)
                out_r = embedding_lookup_csr(self.r, ridx, offsets, weights,
                                             mode=self.mode, backend=backend)
            else:
                out_q = embedding_lookup(self.q, qidx, weights, mode=self.mode,
                                         backend=backend)
                out_r = embedding_lookup(self.r, ridx, weights, mode=self.mode,
                                         backend=backend)
            return out_q + out_r

        # operation == "mult": per-id rows via CONCAT, then pool.
        if offsets is not None:
            raise ValueError(
                "operation='mult' is fixed-hotness only (per-id rows "
                "come from CONCAT lookups; CSR+CONCAT is unsupported)"
            )
        batch, hot = indices.shape
        rows_q = embedding_lookup(self.q, qidx, mode=CombineMode.CONCAT, backend=backend)
        rows_r = embedding_lookup(self.r, ridx, mode=CombineMode.CONCAT, backend=backend)
        rows = (rows_q * rows_r).view(batch, hot, self.width)
        if weights is not None:
            if self.mode != CombineMode.SUM:
                raise ValueError(
                    "weights are only supported with CombineMode.SUM"
                )
            return torch.sum(rows * weights[:, :, None], dim=1)
        pooled = torch.sum(rows, dim=1)
        if self.mode == CombineMode.MEAN:
            pooled = pooled / hot
        return pooled
