"""Process groups for the sharded path: the counterpart of
``dlrm_tpu/parallel/mesh.py``.

One rank is one process that drives one device.  The JAX package's mesh
axes become process groups of a ``torch.distributed`` device mesh:

* ``"d"``, the table axis: the embedding tables are sharded over it
  (``parallel/placement.py``) and the embedding exchange runs in its group;
* ``"h"``, the data-only (DCN) axis of a 2-D mesh: the tables are
  replicated over it, and the sparse updates are gathered over it in
  compressed form before they are applied (``parallel/embedding.py``).

The JAX package's ``batch_sharding`` and ``param_shardings`` become these
per-rank rules:

* **The batch** is split over every rank of the mesh, rank-major (``"h"``
  major, ``"d"`` minor on a 2-D mesh): rank r holds the contiguous rows
  :func:`local_batch_rows` gives.  The global batch must divide by the
  number of ranks.
* **The MLPs** are replicated: every rank holds the same dense parameters
  (broadcast from rank 0 at the start) and applies the same all-reduced
  gradient.
* **The table stack** is rank-local: rank r holds shard r of the
  placement along ``"d"``, its ``(local_rows, D)`` stack and its ``(R_t,
  D / N)`` column shards.

The backend follows the device: NCCL for ``cuda``, gloo for the CPU, and
neither stands in for the other.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dim names ``("d",)``
or ``("h", "d")``.  :func:`make_hybrid_mesh` orders a 2-D mesh by host,
the DCN granule where GPUs have no slice.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join the gang: initialize the default process group with the
    device's backend, and return the device this rank drives.  Call once
    per process before any exchange; a second call checks the backend and
    returns.

    ``coordinator_address``: ``host:port`` of rank 0's store (or a
    ``tcp://`` / ``file://`` URL), with ``num_processes`` and
    ``process_id``.  With no arguments the usual ``torchrun`` environment
    is read (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    A ``cuda`` device without an index becomes ``cuda:<LOCAL_RANK>`` (the
    environment's, else the rank modulo the visible cards).
    """
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", but {device} needs {backend}")
        return _rank_device(device, dist.get_rank())
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes and process_id need a "
                             "coordinator_address")
        init_method, world, rank = "env://", -1, -1
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes "
                             "and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    kw = {}
    if device.type == "cuda":
        device = _rank_device(device, rank if rank >= 0
                              else int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    return device


def init_single_process(device="cuda") -> torch.device:
    """A process group of this process alone (world size 1), with the
    device's backend and an in-memory store (no address): what a sharded
    run of one process joins.  Returns the device it drives; a group
    already initialized is checked as :func:`init_distributed` does."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        return init_distributed(device=device)
    kw = {}
    if device.type == "cuda":
        device = _rank_device(device, 0)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0, **kw)
    return device


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None \
        else rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def is_lead_process() -> bool:
    """True on the rank that owns logging and metadata writes (rank 0, or
    the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _mesh_device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = "d"
              ) -> DeviceMesh:
    """1-D mesh: one table group over every rank of the gang."""
    world = dist.get_world_size() if dist.is_initialized() else None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh, but the gang "
                         f"has {world} process(es); start one process per "
                         f"rank")
    device_type = _mesh_device_type()
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def make_mesh_2d(dcn: int, ici: int, dcn_axis: str = "h",
                 ici_axis: str = "d") -> DeviceMesh:
    """2-D ``(dcn, ici)`` mesh over the gang's ranks in order: rank
    ``h * ici + d`` is at ``(h, d)``; the tables shard over ``ici_axis``."""
    device_type = _mesh_device_type()
    if dcn * ici != dist.get_world_size():
        raise ValueError(f"requested a {dcn}x{ici} mesh, but the gang has "
                         f"{dist.get_world_size()} process(es)")
    return init_device_mesh(device_type, (dcn, ici),
                            mesh_dim_names=(dcn_axis, ici_axis))


def make_hybrid_mesh(ici_axis: str = "d", dcn_axis: str = "h",
                     host: Optional[str] = None) -> DeviceMesh:
    """2-D ``(hosts, ranks a host)`` mesh: the fast axis ``ici_axis``
    inside a host, ``dcn_axis`` across hosts.  Every rank names its host
    (``host``, default ``socket.gethostname()``); the names are gathered,
    hosts take the order of their first rank, and each host's ranks stand
    in rank order.  The tables shard over ``ici_axis`` only, so the
    embedding exchange stays inside a host; only the compressed updates
    of :func:`dcn_axis_of`'s axis cross hosts.  Every host must hold the
    same number of ranks.  The counterpart of the JAX package's
    ``make_hybrid_mesh``, whose granule is the TPU slice (or the process
    where devices have no slice); GPUs have no slice, and one process
    drives one card, so the granule is the host."""
    device_type = _mesh_device_type()
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names,
                           socket.gethostname() if host is None else host)
    hosts = list(dict.fromkeys(names))
    groups = [[r for r, h in enumerate(names) if h == name]
              for name in hosts]
    if len({len(g) for g in groups}) != 1:
        raise ValueError(f"hosts hold {[len(g) for g in groups]} ranks: a "
                         f"hybrid mesh needs the same number on every host")
    return DeviceMesh(device_type, torch.tensor(groups),
                      mesh_dim_names=(dcn_axis, ici_axis))


def dcn_axis_of(mesh: DeviceMesh, axis: str = "d") -> Optional[str]:
    """The mesh's data-only (DCN) axis name, or None on a 1-D mesh:
    ``axis`` is the table axis, and any other axis carries batch data
    parallelism only."""
    others = [a for a in mesh.mesh_dim_names if a != axis]
    if not others:
        return None
    if len(others) > 1:
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}; expected at "
                         f"most one besides the table axis {axis!r}")
    return others[0]


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh, rank-major (the batch block it
    holds)."""
    flat = mesh.mesh.flatten().tolist()
    return flat.index(dist.get_rank())


def local_batch_rows(mesh: DeviceMesh, global_batch: int) -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` rows of a global batch that this rank
    holds: the batch split over every rank of the mesh, rank-major."""
    n = mesh.mesh.numel()
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split over the mesh's {n} ranks: every exchange "
                         f"needs a multiple of {n}")
    b = global_batch // n
    r = mesh_rank(mesh)
    return r * b, (r + 1) * b
