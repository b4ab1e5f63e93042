"""The tiered backward's head, the counterpart of ``cuembed_tpu/ops/head.py``.

The tiered backward splits the table gradient in two. The rows under
``cfg.mxu_head_rows`` (the hottest, when the table is stored hot-first)
take their gradient as one product, ``grad[:head] = M^T @ grad_y``, where
``M[b, c]`` sums the coefficients of sample ``b``'s positions on row ``c``.
Every other position goes through the sorted-COO backward (K3 on the card)
on a COO whose head positions were replaced by the int32-max sentinel, which
K3 drops. ``M`` is built by scatter-adds of the coefficients, never as a
``[batch, hotness, head]`` compare cube.

The product runs in IEEE fp32 (:func:`fp32_matmul`), as the JAX package
runs it at ``Precision.HIGHEST``: a matmul that TF32 may serve keeps 10
bits of each operand's significand and would not match.
"""

from __future__ import annotations

import torch

from cuembed_tpu_torch.ops.tiered import TieredConfig


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32, with no TF32, whatever the caller set
    (``torch.set_float32_matmul_precision`` or ``allow_tf32``); the
    caller's setting is restored after."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(saved)


def head_matrix(indices2d: torch.Tensor, coeff2d, head: int, acc_dt,
                return_appeared: bool = False):
    """``M[b, c]``: the sum of the coefficients of sample ``b``'s positions
    on row ``c < head`` (``coeff2d=None``: unit coefficients, so ``M``
    counts them), in ``acc_dt``.

    ``return_appeared=True`` also returns the ``[head]`` bool mask of the
    head rows that any position hits, zero coefficients included.

    Positions off the head add to a spare column of their own sample, so
    no step waits on the host for a count. Counts are sums of ones, exact
    in any order, so they take one scatter-add. Coefficients are added one
    hotness column at a time, in position order: within a column every
    (sample, column) target is distinct, so the sums are the same on every
    run.
    """
    batch, hotness = indices2d.shape
    device = indices2d.device
    m = torch.zeros((batch, head + 1), dtype=acc_dt, device=device)
    col = torch.where((indices2d >= 0) & (indices2d < head), indices2d, head).long()
    cell = torch.arange(batch, device=device)[:, None] * (head + 1) + col
    flat = m.view(-1)
    if coeff2d is None:
        one = torch.ones((), dtype=acc_dt, device=device)
        flat.index_add_(0, cell.view(-1), one.expand(cell.numel()))
    else:
        coeff2d = coeff2d.to(acc_dt)
        for j in range(hotness):
            flat.index_add_(0, cell[:, j], coeff2d[:, j])
    m = m[:, :head]
    if not return_appeared:
        return m
    appeared = torch.zeros(head + 1, dtype=torch.bool, device=device)
    appeared[col.view(-1)] = True
    return m, appeared[:head]


def head_grad(indices2d, coeff2d, grad_y, head: int, acc_dt) -> torch.Tensor:
    """``grad[:head] = M^T @ grad_y``, in ``acc_dt``, in full precision."""
    m = head_matrix(indices2d, coeff2d, head, acc_dt)
    return fp32_matmul(m.t(), grad_y.to(acc_dt))


def head_forward(indices2d, coeff2d, head_slice, head: int, acc_dt):
    """``M @ table[:head]``, the forward's head combine, in full precision."""
    m = head_matrix(indices2d, coeff2d, head, acc_dt)
    return fp32_matmul(m, head_slice.to(acc_dt))


def nonhead_capacity(cfg: TieredConfig, n: int) -> int:
    """The JAX package's static bound on non-head positions after the sort
    (8-aligned)."""
    frac = cfg.nonhead_frac
    if frac is None:
        frac = (cfg.mid_slots + cfg.cold_slots) / cfg.chunk_elems
    frac = min(1.0, frac)
    return min(n, -(-int(n * frac) // 8) * 8)


def tiered_backward_coo(
    grad_y: torch.Tensor,
    num_categories: int,
    indices2d: torch.Tensor,
    coeff2d,
    t_idx: torch.Tensor,
    t_sid: torch.Tensor,
    t_coeff,
    cfg: TieredConfig,
    *,
    backend: str = "auto",
    accumulation_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Full-table gradient: the head product plus the sorted-COO backward
    of the other positions.

    Args:
      grad_y: ``[batch, width]`` upstream gradient.
      indices2d, coeff2d: the ``[batch, hotness]`` lookup indices and
        per-position coefficients (None: unit), for the head matrix.
      t_idx, t_sid, t_coeff: the index-sorted COO whose head positions
        (``idx < cfg.mxu_head_rows``) became the int32-max sentinel before
        the sort.
      accumulation_dtype: the dtype of the sums (default ``grad_y``'s), as
        in :func:`~cuembed_tpu_torch.ops.dispatch.backward`.

    Returns ``[num_categories, width]`` in ``grad_y``'s dtype: the head rows
    are ``acc(0) + M^T @ grad_y`` rounded once, as the JAX package's
    ``grad.at[:head].add(grad_head)`` on its zero head rows. The JAX
    package's choice between a calibrated prefix and the full width changes
    no result; the whole COO is passed here, and K3 skips the sentinels'
    rows.
    """
    from cuembed_tpu_torch.ops import dispatch

    acc_dt = accumulation_dtype or grad_y.dtype
    head_rows = min(cfg.mxu_head_rows, num_categories)
    grad_head = head_grad(indices2d, coeff2d, grad_y, head_rows, acc_dt)
    grad = dispatch.backward(grad_y, num_categories, t_idx, t_sid, t_coeff,
                             backend=backend, accumulation_dtype=acc_dt)
    head = grad[:head_rows]
    head.copy_(head.to(acc_dt) + grad_head)
    return grad
