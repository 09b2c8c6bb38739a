"""Process-group setup for ray-sharded rendering and training.

PyTorch counterpart of octree_raymarcher_tpu/parallel/mesh.py.  The scalable
axis of a raymarcher is rays: the octree pools and voxel parameters are
replicated, one copy per device, the ray batch shards across a 1-D ``rays``
axis, and voxel-parameter gradients are summed across it.  The JAX package
builds a 1-D device ``Mesh``; here that axis is a ``torch.distributed``
process group with one rank per device, and :func:`make_mesh` returns a
:class:`RayMesh` that carries the group, the rank, the world size and the
rank's device.  A ``cuda`` mesh runs on NCCL on ``cuda:<local rank>``, a
``cpu`` mesh on gloo; neither falls back to the other.

The reference's ``ray_sharding`` and ``replicated`` name JAX sharding objects,
which torch.distributed has no counterpart of.  The two layouts are kept as a
convention of the entry points instead: every rank is given the whole ray
batch and takes its contiguous block (:meth:`RayMesh.ray_block`), which is
``P(RAYS_AXIS)``'s layout, and pools and parameters are whole on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from ..world.device import resolve_device

RAYS_AXIS = "rays"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D ``rays`` axis: a process group and this process's place in it."""

    group: object            # the torch.distributed process group (None: the default one)
    rank: int                # this process's rank in ``group``
    size: int                # ranks in ``group``
    device: torch.device     # where this rank's pools, rays and params live

    def ray_block(self, n: int) -> slice:
        """This rank's rows of an ``n``-ray batch: [rank*n/size, (rank+1)*n/size)."""
        if n % self.size:
            raise ValueError(f"{n} rays do not split evenly over {self.size} ranks; "
                             "pad the batch first (pad_rays)")
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)


def local_address() -> str:
    """``127.0.0.1:<port>`` with a port that was free a moment ago: the
    rendezvous of a group whose ranks all run on this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> None:
    """Initialise the default process group for ``device`` (NCCL for
    ``cuda``, gloo for ``cpu``); a no-op if it already exists.

    ``coordinator`` is the rendezvous ``host:port``, ``num_processes`` the
    world size and
    ``process_id`` this process's rank.  With no coordinator the group is
    read from the environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  A failed initialisation raises."""
    if dist.is_initialized():
        return
    kind = resolve_device(device).type
    init_method = "env://" if coordinator is None else f"tcp://{coordinator}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend=BACKENDS[kind], init_method=init_method, **kwargs)


def make_mesh(device="cuda", group=None) -> RayMesh:
    """The ``rays`` axis over ``group`` (default: every rank of the
    initialised default group).  A ``cuda`` mesh needs an NCCL group and
    takes ``cuda:<LOCAL_RANK>`` (default: the global rank modulo the visible
    cards), which it makes the current device; a ``cpu`` mesh needs gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group; call "
                           "init_distributed first")
    kind = resolve_device(device).type
    want = BACKENDS[kind]
    backend = str(dist.get_backend(group))
    if want not in backend:
        raise RuntimeError(f"a {kind} mesh needs the {want} backend; the group has {backend}")
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return RayMesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                   device=dev)


__all__ = ["RAYS_AXIS", "BACKENDS", "RayMesh", "init_distributed", "local_address",
           "make_mesh"]
