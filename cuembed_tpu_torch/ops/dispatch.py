"""Backend dispatch for the lookup and its backward, the counterpart of
``cuembed_tpu/ops/dispatch.py``.

The JAX backend names carry over so that callers do not change:

* ``"auto"`` and ``"pallas"``: the hand-written kernels (K1 fixed, K2 CSR,
  K3 backward, K4 row-wise AdaGrad's apply, K5 the COO transpose) for CUDA
  tensors, the plain PyTorch version for CPU tensors;
* ``"xla"``: the plain PyTorch version on every device;
* ``"tiered"``: :func:`~cuembed_tpu_torch.ops.tiered.tiered_forward` with
  the caller's ``tiered_cfg`` or the JAX package's automatic one, which
  serves the whole table through K1 and K2;
* ``"narrow"``: a narrow table (``128 % width == 0``), served as it
  stands on K1 and K2 again.

The ``ValueError`` of each refused call follows the JAX dispatcher:
``"narrow"`` refuses a width that does not pack, and ``"tiered"`` refuses a
raw narrow table too large to pack inline (the active record's
``narrow_inline_pack_bytes``, :func:`_narrow_inline_pack_bytes`), CONCAT,
and a table its automatic config would not tier. The JAX dispatcher
line-packs a small raw narrow table for the call, because TPU arrays are
padded to 128 lanes; on the card that
repack would change no result, so a raw narrow table goes straight to K1
and K2 under every backend (packed storage is
:func:`~cuembed_tpu_torch.ops.narrow.narrow_lookup` and
``EmbeddingBag(layout="packed")``). ``"auto"`` with a ``tiered_cfg`` serves
through K1 and K2, as the JAX package off the TPU serves it through its
plain path; the config changes no gradient either
(:mod:`~cuembed_tpu_torch.ops.api`). The JAX package's hint about a large
table served without tiering concerns the TPU only and is not emitted.
Unlike the TPU, where the Pallas backward was opt-in, K3 is the backward of
every backend but ``"xla"`` on CUDA, and so are K4 (the AdaGrad apply) and
K5 (the COO transpose before K3). CONCAT is a pure gather and goes to
``index_select`` on every device.

This module alone decides which kernel serves a lookup.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops import cuda_adagrad, cuda_backward, cuda_forward, cuda_transforms
from cuembed_tpu_torch.ops import narrow as narrow_mod
from cuembed_tpu_torch.ops.lookup_torch import (
    CompressedGrad,
    embedding_backward_compressed_torch,
    embedding_backward_torch,
    embedding_forward_torch,
)
from cuembed_tpu_torch.ops.narrow import LANES
from cuembed_tpu_torch.ops.tiered import TieredConfig, auto_config, tiered_forward
from cuembed_tpu_torch.types import CombineMode
from cuembed_tpu_torch.utils import trace
from cuembed_tpu_torch.utils.chip import chip_constants

BACKENDS = ("auto", "pallas", "xla", "tiered", "narrow")


def _narrow_inline_pack_bytes() -> int:
    """The active record's bound on the lane-padded bytes of a raw narrow
    table that the JAX package packs inline for one call; ``"tiered"``
    refuses a larger table, as the JAX dispatcher does."""
    return chip_constants()["narrow_inline_pack_bytes"]


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend}")


def pallas_forward_supported(table, indices, offsets, weights, mode) -> bool:
    """Whether K1 or K2 serves the call: every mode but CONCAT (a pure
    gather, ``index_select``), at every width and storage dtype. The JAX
    package's Pallas forward also refuses widths that are no multiple of
    128 lanes and fp16 tables; the kernels here take both."""
    del table, indices, offsets, weights
    return mode != CombineMode.CONCAT


def tiered_auto_config(table, indices, offsets, mode) -> TieredConfig | None:
    """The JAX package's automatic tiered config for this call, or None
    (CONCAT, or a table within its hot budget)."""
    if mode == CombineMode.CONCAT:
        return None
    if offsets is None:
        hotness = indices.shape[1]
    else:
        hotness = max(1, indices.shape[0] // max(1, offsets.shape[0] - 1))
    return auto_config(table.shape[0], table.shape[1], table.element_size(), hotness)


def forward(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor | None,
    weights: torch.Tensor | None,
    *,
    mode: CombineMode,
    low_precision_math: bool = False,
    backend: str = "auto",
    tiered_cfg: TieredConfig | None = None,
) -> torch.Tensor:
    """Route a forward lookup to the kernel or the plain version."""
    span = (trace.begin("dispatch.forward")
            if trace.torch_profiler._is_profiler_enabled else None)
    try:
        _check_backend(backend)
        if narrow_mod.packing_factor(table.shape[1]) > 1:
            phys_bytes = table.shape[0] * LANES * table.element_size()
            if backend == "tiered" and phys_bytes > _narrow_inline_pack_bytes():
                raise ValueError(
                    "backend='tiered' on a raw narrow table would repack it "
                    "every call; store it line-packed (pack_narrow) and call "
                    "narrow_lookup(..., tiered_cfg=...) or use "
                    "EmbeddingBag(layout='packed')"
                )
            if backend in ("tiered", "narrow"):
                cfg = tiered_cfg
                if backend == "tiered" and cfg is None:
                    cfg = tiered_auto_config(table, indices, offsets, mode)
                narrow_mod._tiers(cfg, indices, offsets, mode)  # the JAX engine's errors
                backend = "auto"
        elif backend == "narrow":
            raise ValueError("backend='narrow' needs width < 128 with 128 % width == 0")
        if backend == "tiered":
            cfg = tiered_cfg or tiered_auto_config(table, indices, offsets, mode)
            if cfg is None:
                if mode == CombineMode.CONCAT:
                    raise ValueError(
                        "CONCAT is a pure gather and is never tiered; use "
                        "backend='auto' or 'xla'"
                    )
                raise ValueError(
                    "backend='tiered' but the table fits the VMEM budget; "
                    "use backend='auto' (the plain gather is already fast)"
                )
            return tiered_forward(table, indices, offsets, weights, mode=mode, cfg=cfg,
                                  low_precision_math=low_precision_math)
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
    finally:
        if span is not None:
            trace.end(span)


def forward_many(tables, indices, weights, modes, *, backend: str = "auto") -> list:
    """:func:`forward` for a list of fixed-hotness lookups, where K1 serves
    them: under ``"auto"`` and ``"pallas"`` every lookup but a CONCAT one (a
    gather) goes to ``cuda_forward.embedding_forward_cuda_many`` together,
    with no ``dispatch.forward`` span. Result ``i`` is ``forward(tables[i],
    indices[i], None, weights[i], mode=modes[i], ...)``, bit for bit, where
    that call serves it, else None (a CONCAT lookup, every lookup under the
    other backends, and what the K1 path refuses): the caller routes those
    through :func:`forward` one at a time. (A zero-width table, which
    :func:`forward`'s narrow test refuses with a ``ZeroDivisionError``, gets
    its empty output here.)"""
    _check_backend(backend)
    if backend not in ("auto", "pallas"):
        return [None] * len(tables)
    if CombineMode.CONCAT not in modes:
        return cuda_forward.embedding_forward_cuda_many(tables, indices, weights, modes)
    k1 = [k for k, m in enumerate(modes) if m != CombineMode.CONCAT]
    outs = [None] * len(tables)
    for k, out in zip(k1, cuda_forward.embedding_forward_cuda_many(
            *([seq[k] for k in k1] for seq in (tables, indices, weights, modes)))):
        outs[k] = out
    return outs


def transpose(
    ids: torch.Tensor,
    num_rows: int,
    *,
    hotness: int | None = None,
    sample_ids: torch.Tensor | None = None,
    coeff: torch.Tensor | None = None,
    backend: str = "auto",
):
    """Route the COO transpose (the lookup's positions sorted by id, stably,
    as the backward takes them) to K5 under every backend but ``"xla"``, as
    K3 and K4 are routed, or to the plain version, ``torch.sort``, under
    ``"xla"``; CPU tensors take the plain version under every backend
    (arguments and results: :mod:`~cuembed_tpu_torch.ops.cuda_transforms`)."""
    _check_backend(backend)
    fn = (cuda_transforms.coo_transpose_torch if backend == "xla"
          else cuda_transforms.coo_transpose_cuda)
    return fn(ids, num_rows, hotness=hotness, sample_ids=sample_ids, coeff=coeff)


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
    live_cap: int | None = None,
) -> torch.Tensor:
    """Route the full COO backward to K3 or the plain version.

    On both routes the gradient is in ``grad_y``'s dtype and its sums are
    taken in at least ``accumulation_dtype`` (default: ``grad_y``'s). The
    plain version casts ``grad_y`` to it, sums, and rounds the gradient back
    (the JAX backward's cast, sum, cast). K3 always sums in fp32, which is
    at least the accumulation dtype of every table it takes, and rounds
    once, so a half ``grad_y`` needs no [num_categories, width] fp32
    gradient and no cast. ``live_cap`` bounds the live entries; it changes
    no result (K3 reads only the live prefix anyway).
    """
    _check_backend(backend)
    if backend == "xla" or not grad_y.is_cuda:
        acc = grad_y if accumulation_dtype is None else grad_y.to(accumulation_dtype)
        return embedding_backward_torch(
            acc, num_categories, transpose_indices, transpose_sample_ids,
            transpose_weights, nnz=nnz, live_cap=live_cap,
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
    out=None,
) -> CompressedGrad:
    """Route the compressed COO backward to K3 or the plain version
    (``out``: see :func:`~cuembed_tpu_torch.ops.lookup_torch.embedding_backward_compressed_torch`)."""
    _check_backend(backend)
    fn = (embedding_backward_compressed_torch if backend == "xla"
          else cuda_backward.embedding_backward_cuda_compressed)
    with trace.span("dispatch.backward_compressed"):
        return fn(grad_y, transpose_indices, transpose_sample_ids, transpose_weights,
                  nnz=nnz, out=out)


def rowwise_adagrad_apply(
    table: torch.Tensor,
    accum: torch.Tensor,
    cg: CompressedGrad,
    *,
    lr: float,
    eps: float,
    backend: str = "auto",
):
    """Route row-wise AdaGrad's apply of a compressed gradient to K4 or the
    plain version (:mod:`~cuembed_tpu_torch.ops.cuda_adagrad`), in place."""
    _check_backend(backend)
    fn = (cuda_adagrad.rowwise_adagrad_apply_torch if backend == "xla"
          else cuda_adagrad.rowwise_adagrad_apply_cuda)
    return fn(table, accum, cg, lr=lr, eps=eps)
