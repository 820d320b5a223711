"""The seed-axis scan ops that the recurrences (``ops/lstm.py``,
``ops/gru.py``) are built from.

A recurrence is two ``torch.library`` ops over a whole sequence, a
forward and a reverse scan, on tensors with an explicit seed axis S, and
inside them one step op a time step:

- a **step op** (:func:`step_op`) runs its plain version on a CPU tensor
  and launches its hand-written kernel on a CUDA tensor; the kernel's
  operands pass :func:`kernel_dtype`;
- a **scan op** (:func:`scan_op`) runs its module's loop over the step
  ops, on the tensors' device (:func:`on_device`: the kernels launch on
  the current one). Its Meta implementation is the same loop with steps
  that do nothing, so its output shapes are the loop's own. Its vmap rule
  folds vmap's dimension into the seed axis of each input at the position
  the op declares (:func:`fold`), runs the op once, and splits it out of
  each output again (:func:`split`), so a seed-batched fit
  (``training/seed_stack.py``) crosses vmap's batching layer once a
  sequence, not once an op a step. An output without an axis at its
  position (the empty stack a scan that keeps nothing returns) comes back
  unbatched.

The ops are defined on the plain Library: its first call costs nothing,
where ``torch.library.custom_op``'s first call imports seconds of tracing
machinery.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
from torch import Tensor

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}  # the kernels' dtype codes

_LIB = torch.library.Library("tonal", "FRAGMENT")


def kernel_dtype(kernel: str, *ts: Tensor) -> int:
    """The dtype code of ``kernel``'s operands ``ts``; raises on what the
    kernels do not take."""
    dtype = ts[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{kernel}: float32, float64 or bfloat16 operands of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if any(not t.is_cuda or t.device != ts[0].device for t in ts):
        raise ValueError(f"{kernel}: every operand on one CUDA device")
    return _DTYPES[dtype]


def on_device(t: Tensor):
    """The kernels launch on the current device: make it ``t``'s."""
    return torch.cuda.device(t.device) if t.is_cuda else contextlib.nullcontext()


def fold(x: Tensor, dim: Optional[int], pos: int, size: int) -> Tensor:
    """Move vmap's dimension ``dim`` (None: not batched, so broadcast) to
    ``pos`` and merge it into the seed axis that follows it."""
    if dim is None:
        x = x.unsqueeze(pos).expand(x.shape[:pos] + (size,) + x.shape[pos:])
    else:
        x = x.movedim(dim, pos)
    return x.reshape(x.shape[:pos] + (-1,) + x.shape[pos + 2:])


def split(x: Tensor, pos: int, size: int) -> Tensor:
    """Undo :func:`fold` on an output: vmap's dimension at ``pos``."""
    return x.reshape(x.shape[:pos] + (size, -1) + x.shape[pos + 1:])


def _name(schema: str) -> str:
    return schema[:schema.index("(")]


def step_op(schema: str, plain: Callable, cuda: Callable) -> None:
    """Define ``tonal::<op>`` by ``schema``: ``plain`` on CPU tensors,
    ``cuda`` (a kernel's launch) on CUDA tensors."""
    _LIB.define(schema)
    _LIB.impl(_name(schema), plain, "CPU")
    _LIB.impl(_name(schema), cuda, "CUDA")


def _nothing(*_) -> None:
    pass


def scan_op(schema: str, scan: Callable, steps: Sequence[str],
            fold_at: Sequence[int], split_at: Sequence[int]):
    """Define and return ``tonal::<op>`` by ``schema``: ``scan(*args, *ops)`` under
    the device guard, ``ops`` the step ops named ``steps`` (looked up at
    each call), on the shapes alone for Meta, and the module docstring's
    vmap rule. ``fold_at`` is the seed axis's position in each tensor
    input (the arguments after them pass as they are), ``split_at`` in
    each output."""
    name = _name(schema)
    _LIB.define(schema)
    op = getattr(torch.ops.tonal, name)

    def run(*args):
        with on_device(args[0]):
            return scan(*args, *[getattr(torch.ops.tonal, s) for s in steps])

    def meta(*args):
        return scan(*args, *(_nothing,) * len(steps))

    def vmap_rule(info, in_dims, *args):
        n = info.batch_size
        tensors = [fold(x, d, p, n) for x, d, p in zip(args, in_dims, fold_at)]
        outs = op(*tensors, *args[len(fold_at):])
        dims = tuple(p if x.dim() > p else None for x, p in zip(outs, split_at))
        return tuple(x if p is None else split(x, p, n) for x, p in zip(outs, dims)), dims

    _LIB.impl(name, run, "CPU")
    _LIB.impl(name, run, "CUDA")
    _LIB.impl(name, meta, "Meta")
    torch.library.register_vmap(f"tonal::{name}", vmap_rule, lib=_LIB)
    return op
