"""Cluster start-up and the pod mesh (port of ``ransac_tpu.parallel.multihost``).

The JAX package's multi-host entry is ``jax.distributed.initialize`` and a
mesh whose ``data`` axis spans hosts and whose ``model`` axis stays inside
one.  The port's is ``torch.distributed``: ``initialize_cluster`` starts
the process group from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the
counterparts of ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``, and ``pod_mesh`` lays the ``model`` axis over one
host's ranks (``LOCAL_WORLD_SIZE``).

Backend: ``nccl`` where every rank of a host has a card of its own,
``gloo`` where ranks share a card or run on the CPU; the choice and its
reason are logged.  With no cluster configured nothing starts and every
pipeline runs on one process, unchanged.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ransac_tpu_torch.parallel import mesh as mesh_mod
from ransac_tpu_torch.utils.logging import get_logger

log = get_logger("multihost")

#: Seconds a collective may wait before it fails instead of hanging.
DEFAULT_TIMEOUT_S = 600.0


def choose_backend(device="cuda", local_world: int | None = None) -> tuple[str, str]:
    """(backend, reason): ``nccl`` when every one of ``local_world`` ranks
    on this host (None: ``LOCAL_WORLD_SIZE``, else the world) has a card of
    its own, else ``gloo``."""
    if torch.device(device).type != "cuda":
        return "gloo", "ranks run on the CPU"
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available")
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", mesh_mod.world_size()))
    if mesh_mod.ranks_share_a_device(local_world):
        return "gloo", (f"{local_world} local ranks share {torch.cuda.device_count()} "
                        "card(s) (NCCL refuses two ranks on one card)")
    return "nccl", "one card a local rank"


def initialize_cluster(coordinator_address: str | None = None,
                       num_processes: int | None = None, process_id: int | None = None,
                       device="cuda", backend: str | None = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the ``torch.distributed`` process group when a cluster is
    configured; returns whether one is running.

    ``coordinator_address`` ("host:port", or an init URL such as
    ``tcp://...`` or ``file://...``), ``num_processes`` and ``process_id``
    default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    With none of them set this does nothing and returns False.  A group
    already running is kept.  ``backend`` None: ``choose_backend(device)``.
    Every collective fails after ``timeout_s`` instead of hanging."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:  # 0 is a legitimate rank
        process_id = int(env.get("RANK", "0"))
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    reason = "asked for"
    if backend is None:
        backend, reason = choose_backend(
            device, int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    if torch.device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("distributed init: %d processes, this is %d, backend %s (%s)",
             num_processes, process_id, backend, reason)
    return True


def shutdown_cluster() -> None:
    """End the process group, if one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def backend_name() -> str | None:
    """The running group's backend, or None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def pod_mesh(model_axis: int | None = None, device="cuda") -> mesh_mod.Mesh:
    """(data, model) mesh over every rank of the world: ``model`` spans the
    ranks of one host (``LOCAL_WORLD_SIZE``, halved until it divides the
    world), ``data`` the rest."""
    n = mesh_mod.world_size()
    if model_axis is None:
        model_axis = max(int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
        while n % model_axis != 0 and model_axis > 1:
            model_axis //= 2
    return mesh_mod.make_mesh(n, data=n // model_axis, model=model_axis, device=device)


def is_primary() -> bool:
    return mesh_mod.world_rank() == 0
