"""Multi-host initialization and mesh construction, the counterpart of
``cuembed_tpu/parallel/multihost.py``.

Everything in :mod:`cuembed_tpu_torch.parallel` is mesh-generic: the same
per-rank programs run over one host's cards or many hosts', with the
collectives of each mesh dim on its own process group. This module is the
thin bootstrap, for a job started by ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``)::

    from cuembed_tpu_torch.parallel import multihost
    multihost.initialize()           # NCCL on the card, one card a rank
    mesh = multihost.pod_mesh()      # (data, model) over all ranks

Keep the ``model`` axis (the per-lookup all-to-alls) within a host, where
the cards share NVLink: :func:`pod_mesh` makes the model axis the ranks of
one host and lets the ``data`` axis (gradient reductions, which tolerate
the slower network) span hosts.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from cuembed_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS
from cuembed_tpu_torch.types import default_device


def initialize(**kwargs) -> None:
    """Initialize ``torch.distributed`` from the ``torchrun`` environment
    (no-op if already initialized). The backend is NCCL with a card, gloo
    without, unless ``backend=`` says otherwise; with a card each rank
    takes the card ``LOCAL_RANK``. Other keyword arguments go to
    ``init_process_group``. A single process with no ``torchrun``
    environment stays uninitialized, as a bare ``jax.distributed`` call with
    nothing to detect does; with explicit arguments a failure raises."""
    if dist.is_initialized():
        return
    if not kwargs and "WORLD_SIZE" not in os.environ:
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(**kwargs)


def pod_mesh(n_model: Optional[int] = None, *,
             device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over all ranks.

    ``n_model`` defaults to the ranks of one host (``LOCAL_WORLD_SIZE``), so
    the model axis stays within a host and the data axis spans hosts.
    ``device_type`` is "cuda" unless the caller asks for "cpu"; without a
    card it must be given.
    """
    device_type = default_device(device_type).type
    n = dist.get_world_size()
    if n_model is None:
        n_model = min(int(os.environ.get("LOCAL_WORLD_SIZE", n)), n)
    while n % n_model != 0:
        n_model //= 2
    return init_device_mesh(device_type, (n // n_model, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
