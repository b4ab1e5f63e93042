"""EmbeddingBag: one embedding-bag table as an ``nn.Module``, the counterpart
of ``cuembed_tpu/models/embedding_bag.py``.

The TPU package's lane padding (``layout="padded"``) exists only for the
TPU's 128-lane tile, so ``"padded"`` and ``"raw"`` both store the logical
``[num_categories, width]`` table here. ``layout="packed"`` keeps the JAX
package's line-packed layout for narrow widths (``128 % width == 0``):
``[ceil(V/k), k*width]`` with ``k = 128 // width`` rows a line
(:mod:`cuembed_tpu_torch.ops.narrow`), looked up through its logical view
on the same kernels, so a packed JAX table carries across unchanged.
``import_table`` / ``from_numpy`` take a table from the JAX package (as a
numpy array, logical or, for ``"packed"``, packed), ``export_table`` gives
the logical one back. The forward is differentiable: ``loss.backward()``
fills ``weight.grad`` (in the stored layout) through the sorted-COO
backward, and any ``torch.optim`` optimizer steps the table.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cuembed_tpu_torch.ops.api import embedding_lookup, embedding_lookup_csr
from cuembed_tpu_torch.ops.narrow import (
    LANES,
    narrow_lookup,
    pack_narrow,
    packing_factor,
    unpack_narrow,
)
from cuembed_tpu_torch.ops.tiered import tiering_profitable
from cuembed_tpu_torch.types import (
    STORAGE_DTYPES,
    CombineMode,
    default_device,
    init_table_,
)

__all__ = ["EmbeddingBag", "LANES", "default_device"]

_TORCH_MODES = {"sum": CombineMode.SUM, "mean": CombineMode.MEAN}


def _numpy_table(arr) -> tuple[np.ndarray, torch.dtype]:
    """A numpy table and the storage dtype it stands for. numpy has no
    bfloat16, so a bf16 array (ml_dtypes) comes in as fp32, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32), torch.bfloat16
    return arr, torch.from_numpy(np.empty(0, arr.dtype)).dtype


class EmbeddingBag(nn.Module):
    """One embedding-bag table and its lookup."""

    def __init__(
        self,
        num_categories: int,
        width: int,
        mode: CombineMode = CombineMode.SUM,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str | None = None,
        layout: str = "padded",
    ):
        super().__init__()
        if layout not in ("padded", "packed", "raw"):
            raise ValueError(f"unknown layout: {layout}")
        if dtype not in STORAGE_DTYPES:
            raise ValueError(f"unsupported storage dtype: {dtype}")
        self.num_categories = num_categories
        self.width = width
        self.mode = mode
        self.dtype = dtype
        self.layout = layout
        self.weight = nn.Parameter(
            torch.empty(self.stored_shape, dtype=dtype, device=default_device(device))
        )
        self.reset_parameters()

    @property
    def device(self) -> torch.device:
        return self.weight.device

    @property
    def _packed(self) -> bool:
        return self.layout == "packed" and packing_factor(self.width) > 1

    @property
    def stored_width(self) -> int:
        """The width of a stored logical row: ``width`` in every layout.
        The JAX package pads ``"padded"`` rows to a multiple of ``LANES``
        for the TPU's tile; the port pads nothing."""
        return self.width

    @property
    def stored_shape(self) -> tuple[int, int]:
        """The parameter's shape: ``[ceil(V/k), k*W]`` packed, else ``[V, W]``."""
        if self._packed:
            k = packing_factor(self.width)
            return (-(-self.num_categories // k), k * self.width)
        return (self.num_categories, self.width)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """U(-1/sqrt(width), 1/sqrt(width)) init, the JAX package's law;
        a packed table's padding rows stay zero."""
        with torch.no_grad():
            init_table_(self.weight, generator, self.width)
            if self._packed:
                self.weight.view(-1, self.width)[self.num_categories:] = 0

    # -- carrying tables across ------------------------------------------
    def import_table(self, weight) -> None:
        """Copy a table (numpy array, JAX array or tensor) into the
        parameter, cast to the storage dtype: a logical ``[V, W]`` table, or,
        for ``layout="packed"``, one already in the stored
        ``[ceil(V/k), k*W]`` layout (the JAX package's packed table)."""
        if isinstance(weight, torch.Tensor):
            src = weight.detach()
        else:
            host = _numpy_table(weight)[0]
            src = torch.from_numpy(np.require(host, requirements=["C", "W"]))
        shape = tuple(src.shape)
        if shape == (self.num_categories, self.width):
            src = pack_narrow(src) if self._packed else src
        elif shape != self.stored_shape:
            raise ValueError(
                f"expected [{self.num_categories}, {self.width}] weights"
                + (f" or packed {list(self.stored_shape)}" if self._packed else "")
                + f", got {shape}"
            )
        with torch.no_grad():
            self.weight.copy_(src)

    def export_table(self) -> np.ndarray:
        """The table as a logical ``[V, W]`` numpy array (bf16 as fp32)."""
        w = self.weight.detach()
        if self._packed:
            w = unpack_narrow(w, self.num_categories, self.width)
        w = w.cpu()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.numpy()

    @classmethod
    def from_numpy(
        cls,
        arr,
        *,
        mode: CombineMode = CombineMode.SUM,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        layout: str = "padded",
        num_categories: int | None = None,
        width: int | None = None,
    ) -> "EmbeddingBag":
        """Build a bag around a logical ``[V, W]`` table, e.g. one exported
        by the JAX package, or around a packed ``[ceil(V/k), k*W]`` one
        (``layout="packed"``, with ``num_categories`` and ``width``, which
        its shape does not fix). ``dtype`` defaults to the array's (bf16
        for an ml_dtypes bfloat16 array)."""
        host, host_dtype = _numpy_table(arr)
        bag = cls(
            host.shape[0] if num_categories is None else num_categories,
            host.shape[1] if width is None else width, mode=mode,
            dtype=dtype if dtype is not None else host_dtype,
            device=device, layout=layout,
        )
        bag.import_table(host)
        return bag

    @classmethod
    def from_torch(
        cls,
        module: nn.Module,
        *,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        layout: str = "padded",
    ) -> "EmbeddingBag":
        """Build a bag from a ``torch.nn.EmbeddingBag`` (or ``nn.Embedding``,
        read as SUM): its weights and combine mode."""
        mode_str = getattr(module, "mode", "sum")
        if mode_str not in _TORCH_MODES:
            raise ValueError(
                f"torch mode {mode_str!r} has no CombineMode analog "
                "(max-pooling is out of the reference's scope too)"
            )
        w = module.weight.detach()
        bag = cls(
            w.shape[0], w.shape[1], mode=_TORCH_MODES[mode_str],
            dtype=dtype if dtype is not None else w.dtype,
            device=device if device is not None else w.device,
            layout=layout,
        )
        bag.import_table(w)
        return bag

    def forward(
        self,
        indices: torch.Tensor,
        weights: torch.Tensor | None = None,
        offsets: torch.Tensor | None = None,
        backend: str = "auto",
        tiered_cfg=None,
    ) -> torch.Tensor:
        if self._packed:
            # As the JAX module: "auto" drops the config outside the
            # batch shapes its engine tiers profitably.
            if (backend == "auto" and tiered_cfg is not None and offsets is None
                    and indices.dim() == 2
                    and not tiering_profitable(indices.numel(), indices.shape[1])):
                tiered_cfg = None
            return narrow_lookup(
                self.weight, self.num_categories, self.width, indices, weights,
                offsets, mode=self.mode, tiered_cfg=tiered_cfg,
            )
        if offsets is not None:
            return embedding_lookup_csr(
                self.weight, indices, offsets, weights, mode=self.mode,
                backend=backend, tiered_cfg=tiered_cfg,
            )
        return embedding_lookup(
            self.weight, indices, weights, mode=self.mode, backend=backend,
            tiered_cfg=tiered_cfg,
        )
