"""Device mesh of the port over ``torch.distributed`` (port of
``ransac_tpu.parallel.mesh``).

The JAX package names its parallelism through a ``jax.sharding.Mesh`` with
a ``data`` axis (candidate cameras, keyframes, observations) and a
``model`` axis (hypothesis, map or camera blocks), and one controller
``shard_map``s a function over it.  The port is SPMD instead: every rank is
a process, each calls the same function with the same arguments and a
``Mesh``, and four helpers keyed by axis name stand for the collectives:

- ``psum`` -> ``all_reduce(mesh, x, axis)``;
- ``all_gather`` -> ``all_gather(mesh, x, axis)`` ([n, ...], in axis order);
- ``ppermute`` -> ``from_right(mesh, x, axis)``, the one right-neighbour hop;
- ``axis_index`` -> ``axis_index(mesh, axis)`` (``DeviceMesh.get_local_rank``).

One code path serves every backend: a gather is an ``all_reduce`` of a
zeroed [n, ...] buffer in which each rank writes its own row (gloo offers
only ``broadcast`` and ``all_reduce`` on CUDA tensors), and the hop picks
the neighbour's row of that gather.  Adding zeros is exact, so a gather
carries every bit.

``make_mesh(1)`` with no process group is a mesh of this process's one
device and the helpers are the identity.  Above one device it needs an
initialized process group of that many ranks (``parallel.multihost``): a
size-n mesh is the world's first n ranks, laid out (data, model) row-major
on a ``torch.distributed.device_mesh.DeviceMesh``.  Building it is
collective over the whole world, so every rank calls ``make_mesh``; ranks
outside it get a mesh with ``member`` False and skip the work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")

#: What a request for more devices than the world has is told.
MULTI_DEVICE = ("a mesh of more than one device needs an initialized torch.distributed "
                "process group of at least that many ranks: run under torchrun (or "
                "parallel.multihost.initialize_cluster) with --nproc-per-node N")


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh: ``shape`` its axis sizes, ``device`` this rank's
    device, ``ranks`` the world ranks it spans (row-major), ``device_mesh``
    the ``DeviceMesh`` (None for one process without a group)."""
    device: torch.device
    shape: dict = field(default_factory=lambda: {"data": 1, "model": 1})
    ranks: tuple = (0,)
    device_mesh: object = None

    @property
    def devices(self) -> tuple:
        """This rank's device, as the one-element tuple of the mesh's
        devices that this process holds."""
        return (self.device,)

    @property
    def member(self) -> bool:
        """Whether this rank is in the mesh (always, without a group)."""
        return self.device_mesh is None or world_rank() in self.ranks


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", world_rank()))


def rank_device(device="cuda") -> torch.device:
    """This rank's device of ``device``'s kind: ``cuda:(LOCAL_RANK %
    device_count)`` (ranks share cards when there are fewer cards than
    ranks), or the CPU.  CUDA where there is none raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available")
    if device.index is not None and world_size() == 1:
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def ranks_share_a_device(local_world: int | None = None) -> bool:
    """Whether this host runs more ranks (``local_world``; None:
    ``LOCAL_WORLD_SIZE``, else the world) than it has cards, or runs on the
    CPU: the mesh then validates the sharded program, not a speedup."""
    if not torch.cuda.is_available():
        return True
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    return local_world > torch.cuda.device_count()


def _factor(n: int) -> tuple[int, int]:
    """The squarest (data, model) factorization of n with data >= model."""
    model = 1
    for m in range(int(np.sqrt(n)), 0, -1):
        if n % m == 0:
            model = m
            break
    return n // model, model


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None, device="cuda") -> Mesh:
    """A (data, model) mesh over the world's first ``n_devices`` ranks
    (None: all of them, as the JAX function takes ``jax.devices()``), each
    rank on its own device of ``device``'s kind (``rank_device``).
    Without ``data`` and ``model``, the squarest factorization with data
    >= model.  More devices than ranks raises ``ValueError``; so does a
    ``data`` x ``model`` split that is not ``n_devices``."""
    n = world_size() if n_devices is None else int(n_devices)
    if data is None or model is None:
        data, model = _factor(n)
    data, model = int(data), int(model)
    if data * model != n:
        raise ValueError(f"make_mesh: data {data} x model {model} is not {n} devices")
    if n < 1 or n > world_size():
        raise ValueError(f"make_mesh(n_devices={n_devices}, data={data}, model={model}) "
                         f"asks for {n} devices of a world of {world_size()}: {MULTI_DEVICE}")
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(device=dev)
    if dev.type == "cuda":
        # DeviceMesh picks a card by LOCAL_RANK unless one is current.
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(n).reshape(data, model)
    dm = DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)
    return Mesh(device=dev, shape={"data": data, "model": model},
                ranks=tuple(range(n)), device_mesh=dm)


def replicated(mesh: Mesh) -> tuple:
    """DTensor placements of a tensor replicated over both axes (JAX's
    ``NamedSharding(mesh, P())``)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in AXES)


def sharded(mesh: Mesh, *spec) -> tuple:
    """DTensor placements of ``PartitionSpec(*spec)``: tensor dim d is
    sharded over the axis named by ``spec[d]`` (None: not sharded), each
    axis not named replicates."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    unknown = set(dims) - set(AXES)
    if unknown:
        raise ValueError(f"sharded: no mesh axis {sorted(unknown)} (axes {AXES})")
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in AXES)


# ------------------------------------------------------------ axis helpers
def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's index along ``axis`` (JAX's ``lax.axis_index``)."""
    if mesh.device_mesh is None:
        return 0
    return mesh.device_mesh.get_local_rank(axis)


def all_reduce(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` on every rank of it (JAX's ``psum``);
    a new tensor."""
    if mesh.device_mesh is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.device_mesh.get_group(axis))
    return y


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` along ``axis``, in axis order (JAX's
    ``lax.all_gather``), as an ``all_reduce`` of a zeroed buffer in which
    this rank writes its own row."""
    if mesh.device_mesh is None:
        return x[None]
    as_bool = x.dtype == torch.bool
    x = x.to(torch.uint8) if as_bool else x
    buf = x.new_zeros((mesh.shape[axis], *x.shape))
    buf[axis_index(mesh, axis)] = x
    dist.all_reduce(buf, group=mesh.device_mesh.get_group(axis))
    return buf.bool() if as_bool else buf


def from_right(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The right neighbour's ``x`` along ``axis`` (JAX's ``ppermute`` with
    the pairs (i + 1 -> i)); the last rank gets zeros, as there."""
    i, n = axis_index(mesh, axis), mesh.shape[axis]
    if mesh.device_mesh is None:
        return torch.zeros_like(x)
    rows = all_gather(mesh, x, axis)
    return rows[i + 1] if i + 1 < n else torch.zeros_like(x)


def block(mesh: Mesh, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``, split over
    ``axis`` (JAX's ``P(axis)`` on that dim); the size must divide."""
    n = mesh.shape[axis]
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over {axis} = {n}")
    step = size // n
    return x.narrow(dim, axis_index(mesh, axis) * step, step)


def world_max(x: float, device) -> float:
    """The largest ``x`` over the world's ranks (a barrier too); ``x``
    itself without a group."""
    if not dist.is_initialized():
        return float(x)
    if dist.get_backend() == "gloo":
        device = "cpu"
    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())
