"""Mesh construction and block specs for embedding workloads, the
counterpart of ``cuembed_tpu/parallel/sharding.py``.

Canonical layout: a 2D mesh ``(data, model)`` over the ranks of
``torch.distributed``. Embedding tables shard row-wise over ``model`` (each
rank owns a contiguous row range), the training batch shards over
``data``, dense-tower parameters replicate. Collectives run over the
process group of a mesh dim (:func:`axis_group`): NCCL on the card, gloo on
the CPU.

The JAX package places global arrays with a ``NamedSharding``; here every
rank holds only its own block. A spec is a tuple with one entry a
dimension, an axis name or None (replicated), as ``PartitionSpec`` reads;
:func:`local_block` cuts a rank's block out of a global array by it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


def _balanced_n_model(n: int) -> int:
    # Balanced split: model gets the (larger) half of the power-of-two
    # factorization — 2->(1,2), 4->(2,2), 8->(2,4), 16->(4,4).
    k = 0
    while n % (1 << (k + 1)) == 0:
        k += 1
    return 1 << ((k + 1) // 2)


def mesh_shape(n: int, n_model: Optional[int] = None) -> Tuple[int, int]:
    """The ``(data, model)`` sizes :func:`make_mesh` gives ``n`` ranks."""
    if n_model is None:
        n_model = _balanced_n_model(n)
    if n % n_model != 0:
        raise ValueError(f"{n} devices not divisible by n_model={n_model}")
    return n // n_model, n_model


def make_mesh(
    n_model: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    *,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Build a ``(data, model)`` mesh over the ranks of the default process
    group (or the ranks ``devices``, in order).

    ``n_model`` defaults to the largest power-of-two divisor of the rank
    count up to the balanced split — enough model shards to spread tables,
    the rest data parallel. ``device_type`` is "cuda" unless the caller asks
    for "cpu"; without a card it must be given. Every rank of the default
    group must call this (it creates the dims' process groups).
    """
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device_type='cpu' to build "
                "the mesh on the CPU"
            )
        device_type = "cuda"
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n_data, n_model = mesh_shape(len(ranks), n_model)
    if devices is None:
        return init_device_mesh(device_type, (n_data, n_model),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along the mesh dim ``axis`` (JAX's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the mesh dim ``axis``; its group ranks are the
    coordinates along ``axis``."""
    return mesh.get_group(axis)


def table_sharding(mesh: DeviceMesh, *, column: bool = False) -> Spec:
    """Row-sharded (default) or column-sharded table placement."""
    return (None, MODEL_AXIS) if column else (MODEL_AXIS, None)


def batch_sharding(mesh: DeviceMesh) -> Spec:
    """Batch-major arrays shard over the data axis."""
    return (DATA_AXIS,)


def local_block(x, mesh: DeviceMesh, spec: Spec):
    """This rank's block of the global array ``x`` under ``spec`` (the
    analog of ``jax.device_put(x, NamedSharding(mesh, P(*spec)))``): each
    dimension named by an axis is cut into that axis's size of equal parts,
    and the part at this rank's coordinate is kept. Dimensions past the
    spec, and None entries, are whole. Works on tensors (a view) and numpy
    arrays."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than {x.ndim} dimensions")
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n != 0:
            raise ValueError(
                f"dimension {dim} of size {x.shape[dim]} does not divide over "
                f"axis {axis!r} of size {n}"
            )
        size = x.shape[dim] // n
        i = axis_index(mesh, axis)
        index.append(slice(i * size, (i + 1) * size))
    return x[tuple(index)]


def assemble(blocks, spec: Spec, mesh_shape: Tuple[int, int]):
    """The global array from every rank's block under ``spec`` on a ``(data,
    model)`` mesh of ``mesh_shape`` whose ranks ``init_device_mesh`` lays
    out row-major, rank 0 first: the inverse of :func:`local_block`. Blocks
    at the same position (replicas) must be equal bit for bit; the
    positions are concatenated. Tensors or numpy arrays, returned as the
    same type."""
    n_data, n_model = mesh_shape
    if len(blocks) != n_data * n_model:
        raise ValueError(f"{len(blocks)} blocks for a mesh of shape {mesh_shape}")
    tensors = isinstance(blocks[0], torch.Tensor)
    equal = torch.equal if tensors else np.array_equal
    placed = {}
    for rank, block in enumerate(blocks):
        c = {DATA_AXIS: rank // n_model, MODEL_AXIS: rank % n_model}
        key = tuple(None if a is None else c[a] for a in spec)
        if key not in placed:
            placed[key] = block
        elif not equal(block, placed[key]):
            raise ValueError(f"replicas of block {key} differ (rank {rank})")

    def join(prefix, dim):
        if dim == len(spec):
            return placed[prefix]
        if spec[dim] is None:
            return join(prefix + (None,), dim + 1)
        n = n_data if spec[dim] == DATA_AXIS else n_model
        parts = [join(prefix + (i,), dim + 1) for i in range(n)]
        return torch.cat(parts, dim=dim) if tensors else np.concatenate(parts, axis=dim)

    return join((), 0)


def pad_table_for_shards(table, n_shards: int):
    """Pad rows so the table divides evenly across ``n_shards`` (a tensor
    or a numpy array, returned as the same type)."""
    v = table.shape[0]
    padded = (v + n_shards - 1) // n_shards * n_shards
    if padded == v:
        return table
    if isinstance(table, np.ndarray):
        return np.pad(table, ((0, padded - v), (0, 0)))
    return torch.nn.functional.pad(table, (0, 0, 0, padded - v))


def shard_csr(
    indices: np.ndarray,
    offsets: np.ndarray,
    n_shards: int,
    weights: Optional[np.ndarray] = None,
    *,
    cap: Optional[int] = None,
):
    """Split a global CSR batch into the *sharded-CSR* layout.

    A flat CSR batch cannot shard along the data axis directly (offset
    values are global), so the data-parallel layout re-bases it per
    shard: ``indices [n_shards, cap]`` (zero-padded value blocks),
    ``offsets [n_shards, local_batch + 1]``, ``weights`` like indices.
    Cut each rank's ``[1, ...]`` block with :func:`local_block` under
    ``(DATA_AXIS, None)`` for :func:`~cuembed_tpu_torch.parallel.row_sharded_lookup`,
    or ``(MODEL_AXIS, None)`` for the routed lookups.

    ``cap`` (static per-shard value capacity) defaults to the largest
    shard's nonzero count, rounded up to 8.

    Returns ``(indices_blocks, offsets_blocks, weights_blocks | None)``,
    host numpy arrays.
    """
    offsets = np.asarray(offsets)
    indices = np.asarray(indices)
    batch = offsets.shape[0] - 1
    if batch % n_shards != 0:
        raise ValueError("batch must divide evenly across shards")
    lb = batch // n_shards
    bounds = offsets[:: lb]  # [n_shards + 1] sample-group boundaries
    per_shard_nnz = bounds[1:] - bounds[:-1]
    if cap is None:
        cap = max(8, -(-int(per_shard_nnz.max()) // 8) * 8)
    idx_blocks = np.zeros((n_shards, cap), indices.dtype)
    off_blocks = np.zeros((n_shards, lb + 1), offsets.dtype)
    w_blocks = (
        np.zeros((n_shards, cap), np.asarray(weights).dtype)
        if weights is not None
        else None
    )
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        k = hi - lo
        if k > cap:
            raise ValueError(f"shard {s} needs {k} slots > cap {cap}")
        idx_blocks[s, :k] = indices[lo:hi]
        off_blocks[s] = offsets[s * lb : (s + 1) * lb + 1] - lo
        if w_blocks is not None:
            w_blocks[s, :k] = np.asarray(weights)[lo:hi]
    return idx_blocks, off_blocks, w_blocks
