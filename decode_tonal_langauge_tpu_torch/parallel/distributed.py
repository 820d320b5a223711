"""Multi-process runtime: ``torch.distributed`` bootstrap and host-sharded
work lists.

Counterpart of ``decode_tonal_langauge_tpu/parallel/distributed.py``.

Process model. The JAX package runs one process per host, which drives
every local device, and hosts join through ``jax.distributed``. The port
follows PyTorch's idiom instead: one process per card, launched by
``torchrun``::

    torchrun --nproc_per_node N -m decode_tonal_langauge_tpu_torch config.yaml

and the ranks talk through ``torch.distributed``:

- backend: ``nccl`` between cards, ``gloo`` on the CPU;
- card: each rank pins ``cuda:{LOCAL_RANK}``, and
  ``runtime.device.resolve_device(None)`` returns it under a process
  group;
- data axis: the mesh's ``data`` axis is the ranks, so ``parallel:
  {data: N}`` asks for N ranks; a ``data x model`` that differs from the
  world size raises (``mesh.mesh_from_config``).

Several ranks may share one card only over ``gloo``, asked for
explicitly (``backend="gloo"``): NCCL refuses two ranks on one card. The
layer's own collectives are all-reduce and broadcast, which gloo runs on
CUDA tensors too; a gather is an all-reduce of a zero-padded buffer
(``mesh.all_gather``).

Every rank runs the same program; *work lists* (subjects, blocks) are
split between ranks by :func:`host_shard` without communication. With one
process every function here is the identity or a no-op, so the same
configs run unchanged from one card to a node.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")

# How long a collective waits for the other ranks before the run fails
# (a lost rank then ends the run instead of hanging it). Ranks whose
# shares of a stage differ by more than this wait longer at the stage's
# barrier: pass a longer ``timeout`` to :func:`initialize` for them.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _launch_env():
    """(init_method, world_size, rank, local_rank) from a launcher's
    environment, or None: torchrun's ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, else the JAX
    package's recipe ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
    ``JAX_PROCESS_ID``."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", 0)))
    if env.get("JAX_COORDINATOR_ADDRESS"):
        return (env["JAX_COORDINATOR_ADDRESS"], int(env.get("JAX_NUM_PROCESSES", 1)),
                int(env.get("JAX_PROCESS_ID", 0)), int(env.get("LOCAL_RANK", 0)))
    return None


def _init_method(address: str) -> str:
    """A bare ``host:port`` becomes ``tcp://host:port``; URLs
    (``tcp://``, ``file://``, ``env://``) pass through."""
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the process group if a launch asks for one; returns True when
    more than one process is running afterwards.

    Without ``coordinator_address`` and without a launcher's environment
    (see :func:`_launch_env`) this is a no-op returning False: the
    one-process path. ``coordinator_address`` is ``host:port`` or an
    ``init_method`` URL (``file://<path>`` avoids choosing a free port);
    ``num_processes`` and ``process_id`` complete it as in the JAX
    package. ``backend`` defaults to ``nccl`` with a card and ``gloo``
    without one, or when ``device`` is the CPU. Under a card each rank
    pins ``cuda:{LOCAL_RANK}``; more local ranks than cards raise unless
    ``backend="gloo"`` was asked for, when ranks share cards round-robin.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    launch = _launch_env()
    if coordinator_address is None and launch is None:
        return False
    address, world, rank, local_rank = launch or (None, 1, 0, 0)
    init_method = _init_method(coordinator_address or address)
    world = int(num_processes) if num_processes is not None else world
    rank = int(process_id) if process_id is not None else rank

    on_cpu = device is not None and torch.device(device).type == "cpu"
    cuda = torch.cuda.is_available() and not on_cpu
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards and backend == "nccl":
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({n_cards} "
                f"visible): launch with torchrun --nproc_per_node {n_cards} "
                "or fewer, or ask for backend='gloo' to share cards"
            )
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=timeout)
    return world > 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(
    items: Sequence[T],
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[T]:
    """This process's share of a host-level work list.

    Deterministic round-robin by index, so every process computes the same
    assignment without communication: process p takes items p, p+P, ...
    Order within the shard follows the input order.
    """
    if process_id is None:
        process_id = process_index()
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    if not 0 <= process_id < process_count:
        raise ValueError(
            f"process_id {process_id} out of range for {process_count} processes"
        )
    return list(items[process_id::process_count])


def _mesh_device_type() -> str:
    """``cuda`` under NCCL, else ``cpu`` (gloo, whatever the tensors'
    device)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
):
    """A ``DeviceMesh`` over every rank of the process group.

    With one axis: (world,). With two axes and no shape, the first axis
    spans hosts and the second the ranks within a host
    (``LOCAL_WORLD_SIZE``), so gradients sum over the fast links first.
    Raises without a process group: launch with torchrun or call
    :func:`initialize` first.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: launch with torchrun "
            "--nproc_per_node N, or call parallel.distributed.initialize()"
        )
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) == 1:
            shape = (world,)
        elif len(axis_names) == 2:
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            shape = (world // local, local)
        else:
            raise ValueError("provide an explicit shape for >2 mesh axes")
    return init_device_mesh(_mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def barrier(name: str = "barrier", group=None) -> None:
    """Block until every process (of ``group``, default all) reaches this
    point; a no-op with one process. ``name`` labels the point in the
    error of a rank that times out."""
    if process_count() <= 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
