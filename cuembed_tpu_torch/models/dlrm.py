"""DLRM-style recommender: sparse embedding bags + dense MLP towers, the
counterpart of ``cuembed_tpu/models/dlrm.py``.

Multiple embedding tables (K1 forward and K3 backward on the card, one
launch each a table, or one for the group with ``fused=True``), a bottom
MLP over dense features, the pairwise-dot feature interaction, and a top
MLP. :class:`DLRM` is an ``nn.Module`` whose ``forward`` is the JAX
``apply``; :func:`params_from_numpy` loads the JAX ``init``'s parameters, so
that both packages compute the same thing.

Precision, as the JAX model: the MLPs multiply bf16-rounded operands and
keep the product in fp32 (``preferred_element_type=float32``), so here the
operands are rounded to bf16 and multiplied in IEEE fp32 with no TF32
(:func:`~cuembed_tpu_torch.ops.head.fp32_matmul`); the product of two bf16
values is exact in fp32, so the two packages differ only in the order of
the sums. Their gradients round to bf16 as XLA's transpose of that product
does. The interaction is an fp32 product under the same guard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cuembed_tpu_torch.fused import FusedSpec, fused_lookup
from cuembed_tpu_torch.models.embedding_bag import EmbeddingBag
from cuembed_tpu_torch.ops.head import fp32_matmul
from cuembed_tpu_torch.types import CombineMode, default_device, init_table_


@dataclass(frozen=True)
class DLRMConfig:
    table_sizes: Tuple[int, ...] = (100_000,) * 8  # categories per table
    embed_width: int = 64
    hotness: int = 8
    dense_features: int = 16
    bottom_mlp: Tuple[int, ...] = (128, 64)
    top_mlp: Tuple[int, ...] = (256, 128, 1)
    embed_dtype: torch.dtype = torch.float32
    combine_mode: CombineMode = CombineMode.SUM
    #: store all tables as ONE fused physical table (base-offset ids): one
    #: lookup and one backward a step instead of one a table — see
    #: :mod:`cuembed_tpu_torch.fused`.
    fused: bool = False

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)


class _Matmul(torch.autograd.Function):
    """``a @ b`` in IEEE fp32, forward and backward. With ``round_to``, the
    operands are rounded to that type first and each operand's gradient is
    rounded to it too (XLA's transpose of a product of bf16 operands with an
    fp32 result gives bf16 gradients)."""

    @staticmethod
    def forward(ctx, a, b, round_to):
        if round_to is not None:
            a, b = a.to(round_to).float(), b.to(round_to).float()
        ctx.round_to = round_to
        ctx.save_for_backward(a, b)
        return fp32_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = fp32_matmul(g, b.transpose(-1, -2))
        gb = fp32_matmul(a.transpose(-1, -2), g)
        if ctx.round_to is not None:
            ga, gb = ga.to(ctx.round_to).float(), gb.to(ctx.round_to).float()
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, round_to: torch.dtype | None = None):
    """Differentiable ``a @ b`` with fp32 products (see :class:`_Matmul`)."""
    return _Matmul.apply(a, b, round_to)


class MLP(nn.Module):
    """The JAX ``_mlp_init``/``_mlp_apply`` tower: layers ``{"w": [in, out],
    "b": [out]}``, bf16 products with fp32 results, ReLU between layers
    (and after the last unless ``final_linear``)."""

    def __init__(self, dims: Sequence[int], *, device=None):
        super().__init__()
        device = default_device(device)
        self.w = nn.ParameterList(
            nn.Parameter(torch.empty((dims[i], dims[i + 1]), device=device))
            for i in range(len(dims) - 1))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros((dims[i + 1],), device=device))
            for i in range(len(dims) - 1))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """``w ~ sqrt(2 / in) N(0, 1)``, ``b = 0``: the JAX law, not its draws."""
        with torch.no_grad():
            for w, b in zip(self.w, self.b):
                w.normal_(0.0, (2.0 / w.shape[0]) ** 0.5, generator=generator)
                b.zero_()

    def forward(self, x: torch.Tensor, final_linear: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = matmul(x, w, torch.bfloat16) + b
            if not (final_linear and i == n - 1):
                x = torch.relu(x)
        return x

    def load_numpy(self, layers: List[Dict]) -> None:
        """Copy JAX layers ``[{"w", "b"}, ...]`` (numpy arrays) in."""
        if len(layers) != len(self.w):
            raise ValueError(f"expected {len(self.w)} layers, got {len(layers)}")
        with torch.no_grad():
            for w, b, layer in zip(self.w, self.b, layers):
                w.copy_(torch.from_numpy(np.array(layer["w"], np.float32)))
                b.copy_(torch.from_numpy(np.array(layer["b"], np.float32)))


def interaction(bottom_out: torch.Tensor, emb: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[bottom_out, upper triangle of the pairwise dots]``: the JAX
    einsum ``bfd,bgd->bfg`` over the stacked fp32 features, then
    ``triu_indices(F, k=1)``, whose order ``torch.triu_indices`` shares."""
    feats = torch.stack([bottom_out.float()] + [e.float() for e in emb], dim=1)
    inter = matmul(feats, feats.transpose(1, 2))
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)
    return torch.cat([bottom_out.float(), inter[:, iu, ju]], dim=1)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The JAX ``_bce_with_logits``: ``max(l, 0) - l*y + log1p(exp(-|l|))``."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


class DLRM(nn.Module):
    """The DLRM tower; ``forward(dense, sparse)`` is the JAX ``apply``."""

    def __init__(self, config: DLRMConfig, *, device: torch.device | str | None = None):
        super().__init__()
        c = self.config = config
        if c.bottom_mlp[-1] != c.embed_width:
            raise ValueError("bottom MLP output must equal embed_width")
        device = default_device(device)
        self.fused_spec = None
        if c.fused:
            self.fused_spec = FusedSpec.from_sizes(
                [f"t{i}" for i in range(c.num_tables)], c.table_sizes,
                [c.hotness] * c.num_tables, c.embed_width)
            self.tables = nn.Parameter(torch.empty(
                (self.fused_spec.total_rows, c.embed_width), dtype=c.embed_dtype,
                device=device))
        else:
            self.bags = nn.ModuleList(
                EmbeddingBag(v, c.embed_width, c.combine_mode, c.embed_dtype,
                             device=device)
                for v in c.table_sizes)
        self.bottom = MLP((c.dense_features, *c.bottom_mlp), device=device)
        n_feat = c.num_tables + 1  # embedding outputs + bottom-MLP output
        inter_dim = c.bottom_mlp[-1] + n_feat * (n_feat - 1) // 2
        self.top = MLP((inter_dim, *c.top_mlp), device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Tables U(-1/sqrt(W), 1/sqrt(W)) one after the other, then the
        towers (see :meth:`MLP.reset_parameters`)."""
        if self.fused_spec is not None:
            with torch.no_grad():
                for b, s in zip(self.fused_spec.bases, self.fused_spec.sizes):
                    init_table_(self.tables[b:b + s], generator)
        else:
            for bag in self.bags:
                bag.reset_parameters(generator)
        self.bottom.reset_parameters(generator)
        self.top.reset_parameters(generator)

    def forward(
        self,
        dense: torch.Tensor,  # [B, dense_features]
        sparse: Sequence[torch.Tensor],  # num_tables x [B, hotness]
        *,
        backend: str = "auto",
    ) -> torch.Tensor:
        """Logits ``[B]``."""
        c = self.config
        if self.fused_spec is not None:
            spec = self.fused_spec
            out = fused_lookup(self.tables, spec, dict(zip(spec.names, sparse)),
                               mode=c.combine_mode, backend=backend)
            emb = [out[n] for n in spec.names]
        else:
            emb = [bag(idx, backend=backend) for bag, idx in zip(self.bags, sparse)]
        bottom_out = self.bottom(dense)  # [B, embed_width]
        logits = self.top(interaction(bottom_out, emb), final_linear=True)
        return logits[:, 0]

    # -- loss / train step --------------------------------------------------
    def loss(self, dense, sparse, labels, *, backend: str = "auto") -> torch.Tensor:
        return torch.mean(bce_with_logits(self(dense, sparse, backend=backend), labels))

    def sgd_step(self, dense, sparse, labels, lr=0.01, *, backend="auto") -> torch.Tensor:
        """One step of ``p - lr * g`` on every parameter, tables included,
        with the gradients of all of them by autograd (the JAX
        ``value_and_grad`` over the whole pytree): the tables' gradient is
        dense, from K3 in full mode on the card. Updates in place and
        returns the loss (before the step)."""
        params = list(self.parameters())
        with torch.enable_grad():
            loss = self.loss(dense, sparse, labels, backend=backend)
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g.to(p.dtype))
        return loss.detach()


def params_from_numpy(model: DLRM, params: Dict) -> None:
    """Load the JAX ``DLRM.init``'s parameters, as numpy, into ``model``:
    ``tables`` as a list (per-table) or one fused array, ``bottom``/``top``
    as lists of ``{"w", "b"}``. The JAX tables may carry zero padding
    columns past ``embed_width`` (its lane-padded layout); they are dropped.
    """
    c = model.config
    tables = params["tables"]
    if isinstance(tables, (list, tuple)):
        parts = [np.asarray(t, np.float32)[:, :c.embed_width] for t in tables]
    else:
        parts = [np.asarray(tables, np.float32)[:, :c.embed_width]]
    with torch.no_grad():
        if model.fused_spec is not None:
            model.tables.copy_(torch.from_numpy(np.ascontiguousarray(np.concatenate(parts))))
        else:
            if len(parts) == 1 and c.num_tables > 1:
                cuts = np.cumsum(c.table_sizes)[:-1]
                parts = np.split(parts[0], cuts)
            for bag, t in zip(model.bags, parts):
                bag.import_table(np.ascontiguousarray(t))
    model.bottom.load_numpy(params["bottom"])
    model.top.load_numpy(params["top"])
