"""Rank meshes and the data-parallel layout of the trainers and serving.

Counterpart of ``decode_tonal_langauge_tpu/parallel/mesh.py``. A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group (one rank per card, ``distributed.py``): its ``data`` axis
shards the batch, an optional ``model`` axis shards the wide dense layers
(``train_step.py``). Where XLA inserts the collectives for a sharded
array, the port calls them here, over the ``data`` axis's group:

- :func:`shard_batch` keeps this rank's contiguous slice of the leading
  axis (what ``P("data")`` gives device *d*);
- :func:`replicate` broadcasts from rank 0;
- :func:`all_gather` / :func:`fetch_global` concatenate every rank's
  slice. The gather is an all-reduce (SUM) of a zero-padded buffer in
  which each rank fills its own rows: all-reduce and broadcast are the
  collectives that gloo runs on CUDA tensors as well as NCCL does, so two
  ranks can rehearse on one card, and adding zeros is exact.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import barrier, global_mesh, process_count


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
):
    """Mesh over ``n_devices`` ranks, which must be every rank running.

    With one axis the mesh is (n,); with two and no explicit shape, the
    model axis gets 2 where n is even (else 1), to keep DP wide.
    """
    world = process_count()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs {n} processes, and {world} are "
            f"running: launch with torchrun --nproc_per_node {n}"
        )
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            model = 2 if n % 2 == 0 and n > 1 else 1
            shape = (n // model, model)
        else:
            raise ValueError("provide an explicit shape for >2 mesh axes")
    return global_mesh(axis_names, shape)


def mesh_from_config(parallel_cfg):
    """A mesh from a config ``parallel:`` section, or None.

    ::

        parallel:
          data: 2        # ranks on the data axis; 'auto' = world / model
          model: 1       # optional model axis (sharded dense heads)

    ``parallel: auto`` (the bare string) is ``{data: auto}``. Returns
    None when the section is absent or empty or resolves to one rank.
    ``data x model`` must equal the number of ranks running (one per
    card): otherwise this raises and names the ``torchrun`` command that
    fits, rather than run on fewer devices than asked for.
    """
    if not parallel_cfg:
        return None
    if parallel_cfg == "auto" or parallel_cfg is True:
        parallel_cfg = {"data": "auto"}
    if not isinstance(parallel_cfg, dict):
        raise ValueError(
            f"parallel: section must be a mapping or 'auto', got {parallel_cfg!r}"
        )
    model = int(parallel_cfg.get("model", 1))
    data = parallel_cfg.get("data", "auto")
    world = process_count()
    if data in ("auto", None):
        data = max(1, world // model)
    data = int(data)
    if data * model != world:
        raise ValueError(
            f"parallel: asks for data={data} x model={model} ranks, and "
            f"{world} are running: launch one rank per card with torchrun "
            f"--nproc_per_node {data * model}"
        )
    if world == 1:
        return None
    if model == 1:
        return make_mesh(data, axis_names=("data",))
    return make_mesh(world, axis_names=("data", "model"), shape=(data, model))


def _axis(mesh, axis: str):
    """(group, size, this rank's coordinate) of ``axis``."""
    return (mesh.get_group(axis), mesh.shape[mesh.mesh_dim_names.index(axis)],
            mesh.get_local_rank(axis))


def _rows(n: int, size: int, rank: int) -> slice:
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over {size} ranks")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh, arr, axis: str = "data"):
    """This rank's contiguous slice of ``arr``'s leading axis."""
    _, size, rank = _axis(mesh, axis)
    return arr[_rows(arr.shape[0], size, rank)]


def replicate(mesh, tree):
    """Broadcast every tensor of ``tree`` (a module's parameters and
    buffers, a dict or a sequence of tensors) from rank 0, in place; the
    mesh spans every rank. Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree


def all_gather(mesh, local: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Every rank's ``local`` concatenated on the leading axis, in rank
    order, on every rank (a zero-padded all-reduce, see the module
    docstring). Every rank's ``local`` has the same shape; integers travel
    as float64 (exact below 2^53)."""
    if not local.is_floating_point():
        return all_gather(mesh, local.double(), axis).to(local.dtype)
    group, size, rank = _axis(mesh, axis)
    buf = local.new_zeros((size,) + tuple(local.shape))
    buf[rank] = local
    dist.all_reduce(buf, group=group)
    return buf.reshape((size * local.shape[0],) + tuple(local.shape[1:]))


def fetch_global(mesh, local: torch.Tensor, axis: str = "data") -> np.ndarray:
    """:func:`all_gather` to host numpy; ``mesh=None``: ``local`` itself."""
    if mesh is None:
        return local.cpu().numpy()
    return all_gather(mesh, local, axis).cpu().numpy()


class DataParallelLayout:
    """The trainers' and serving's data-parallel layout.

    Each global batch of B rows (``round_batch``: a multiple of the
    ``data`` axis) is split into contiguous slices, one per rank; the
    parameters are replicated. A step computes its slice's share of the
    global loss (the sums over its rows divided by the global batch's
    weight), and :meth:`reduce_sum` adds the gradients and the metric sums
    of every rank in one all-reduce (SUM): averaging, as DDP does, would be
    wrong wherever the slices' weights differ (the padded last batch).
    Reduced values are equal on every rank, so every rank takes the same
    early-stopping branch. :meth:`attach` makes dropout draw the global
    batch's masks and batch norm use the global batch's statistics.

    ``mesh=None`` is the one-device layout and every method is the
    identity, so trainers need no branches. A mesh of one rank still runs
    its collectives.
    """

    def __init__(self, mesh=None, axis: str = "data"):
        self.mesh = mesh
        self._axis = axis
        if mesh is None:
            self.group, self.dp, self.rank = None, 1, 0
        else:
            self.group, self.dp, self.rank = _axis(mesh, axis)

    @property
    def writer(self) -> bool:
        """Whether this rank writes the files of a fit: rank 0 of the
        mesh, or every rank without one (each fits its own work)."""
        return self.mesh is None or dist.get_rank() == 0

    def round_batch(self, batch_size: int) -> int:
        """Round up so each batch splits evenly over ``data``."""
        return -(-batch_size // self.dp) * self.dp

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        return _rows(batch_size, self.dp, self.rank)

    def shard(self, arr):
        """:func:`shard_batch` (identity without a mesh)."""
        return arr if self.mesh is None else shard_batch(self.mesh, arr, self._axis)

    def place_stacks(self, *stacks):
        """This rank's slice of the per-batch axis of (n_batches, B, ...)
        stacks."""
        if self.mesh is None:
            return stacks
        return tuple(s[:, self.rows(s.shape[1])] for s in stacks)

    def replicate_tree(self, tree):
        """:func:`replicate` (identity without a mesh)."""
        return tree if self.mesh is None else replicate(self.mesh, tree)

    def reduce_sum(self, tensors: Sequence[torch.Tensor]):
        """Each tensor summed over the ``data`` ranks, in one all-reduce
        over a flat buffer of them all (cast to the first's dtype and
        back)."""
        tensors = list(tensors)
        if self.mesh is None:
            return tensors
        dtype = tensors[0].dtype
        flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """:func:`all_gather` over ``data`` (identity without a mesh)."""
        return local if self.mesh is None else all_gather(self.mesh, local, self._axis)

    def attach(self, module: torch.nn.Module) -> torch.nn.Module:
        """Point the module's dropout at this rank's rows of the global
        batch's masks and its batch norm at the ``data`` group's
        statistics (see ``ops/dropout.py``, ``models/synthesis.py``)."""
        from ..models.synthesis import BatchNorm1d
        from ..ops.dropout import Dropout

        for m in module.modules():
            if isinstance(m, Dropout):
                m.shard = (self.rank, self.dp)
            elif isinstance(m, BatchNorm1d):
                m.group = self.group
        return module

    def barrier(self, name: str) -> None:
        """Wait for every rank of the ``data`` axis (no-op without a
        mesh)."""
        if self.mesh is not None:
            barrier(name, self.group)
