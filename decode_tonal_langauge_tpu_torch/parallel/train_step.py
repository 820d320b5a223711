"""Sharded training steps: data parallelism over the batch axis and
optional model parallelism of the wide dense layers.

Counterpart of ``decode_tonal_langauge_tpu/parallel/train_step.py``. The
classifier's operations are dominated by the 512-wide conv stack and the
``256 * C * L' x 1024`` dense head (``models/deep.py``). Under a
("data", "model") mesh the batch splits over ``data``, and the dense-head
layers (``fc1``, ``fc2``, ``head``) split their outputs over ``model``
(column parallel). Where GSPMD inserts the collectives in JAX, a sharded
layer here passes

- its input through *f*: the identity forward, and an all-reduce (SUM) of
  the input's gradient over the ``model`` group backward (each shard's
  input gradient is a partial sum);
- its output through *g*: an all-gather of the shards' columns over the
  ``model`` group forward (a zero-padded all-reduce, ``mesh.py``), and
  this shard's columns of the gradient backward.

Everything else is replicated, and one all-reduce sums the gradients over
``data``. A step computes what the replicated step computes, up to the
float32 order of its sums.

The steps are stateful, as torch modules are: the weights and the
optimizer's moments live in the model and in the optimizer that the step
functions make, and dropout draws from the generator the caller set
(``ops.dropout.set_dropout_generator``), each rank the global batch's
masks.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from ..runtime.device import exact_f32
from .mesh import DataParallelLayout, _axis, _rows

HEAD_LAYERS = ("fc1", "fc2", "head")


def _has_model_axis(mesh) -> bool:
    return mesh is not None and "model" in (mesh.mesh_dim_names or ())


def _head_layers(model: nn.Module, layer_names) -> Dict[str, nn.Linear]:
    return {name: m for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and name.split(".")[-1] in layer_names}


def dense_head_sharding(mesh, model: nn.Module, layer_names=HEAD_LAYERS):
    """``{parameter name: placement}``: under a ``model`` axis the weights
    and biases of the named ``nn.Linear`` layers are ``Shard(0)``, split on
    the output dimension (``nn.Linear`` stores (out, in); JAX's (in, out)
    kernel takes ``P(None, "model")``), and everything else is
    ``Replicate()``."""
    heads = _head_layers(model, layer_names) if _has_model_axis(mesh) else {}
    sharded = {f"{name}.{p}" for name in heads for p in ("weight", "bias")}
    return {name: Shard(0) if name in sharded else Replicate()
            for name, _ in model.named_parameters()}


class _CopyToModelGroup(torch.autograd.Function):
    """*f*: identity forward, gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """*g*: every shard's columns concatenated on the last axis forward,
    this shard's columns of the gradient backward."""

    @staticmethod
    def forward(ctx, y, group, rank, size):
        ctx.rank, ctx.size = rank, size
        buf = y.new_zeros((size,) + tuple(y.shape))
        buf[rank] = y
        dist.all_reduce(buf, group=group)
        return buf.movedim(0, -2).reshape(tuple(y.shape[:-1]) + (size * y.shape[-1],))

    @staticmethod
    def backward(ctx, grad):
        cols = grad.reshape(tuple(grad.shape[:-1]) + (ctx.size, -1))
        return cols[..., ctx.rank, :].contiguous(), None, None, None


def _column_parallel_linear(x, weight, bias, group, rank, size):
    y = F.linear(_CopyToModelGroup.apply(x, group), weight, bias)
    return _GatherColumns.apply(y, group, rank, size)


@torch.no_grad()
def shard_dense_head(model: nn.Module, mesh, layer_names=HEAD_LAYERS) -> nn.Module:
    """Keep this rank's output rows of each named ``nn.Linear`` (the
    placement of :func:`dense_head_sharding`) and make it column-parallel
    (``models.base.dense`` / ``head`` call its ``sharded_linear``). Build
    the optimizer after this: the sharded parameters are new tensors."""
    group, size, rank = _axis(mesh, "model")
    for layer in _head_layers(model, layer_names).values():
        rows = _rows(layer.out_features, size, rank)
        layer.weight = nn.Parameter(layer.weight[rows].clone())
        layer.bias = nn.Parameter(layer.bias[rows].clone())
        layer.sharded_linear = functools.partial(
            _column_parallel_linear, group=group, rank=rank, size=size)
    return model


def _prepare(model: nn.Module, optimizer: Callable, mesh):
    layout = DataParallelLayout(mesh)
    if _has_model_axis(mesh):
        shard_dense_head(model, mesh)
    layout.attach(model)
    weights: List[torch.Tensor] = list(model.parameters())
    return layout, weights, optimizer(weights)


def _step(layout, weights, opt, loss_fn):
    """One step: the local share of the global loss, one all-reduce of the
    gradients and the loss over ``data``, the optimizer update."""
    with exact_f32():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, weights)
        *grads, loss = layout.reduce_sum([*grads, loss.detach()])
        opt.step(grads)
    return loss


def build_sharded_classifier_step(
    model: nn.Module,
    optimizer: Callable,
    mesh,
    has_batch_stats: bool = False,
) -> Callable:
    """A data-parallel (and, with a ``model`` axis, column-parallel)
    training step: ``step(x, y) -> loss`` on the global batch ``(x, y)``,
    of which each rank computes its ``data`` slice; the loss is the global
    batch's mean softmax cross-entropy.

    ``optimizer`` builds the optimizer from the parameter list (e.g.
    ``functools.partial(NAdam, learning_rate=...)``); it is called after the dense
    head is sharded and left on ``step.optimizer``. ``has_batch_stats``
    says the model has batch norm, whose train-mode statistics are then
    the global batch's (``models.synthesis.BatchNorm1d``); it must match
    the model, as in JAX, where it selects the ``batch_stats`` collection.
    ``mesh=None`` gives the replicated one-device step.
    """
    has_bn = any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in model.modules())
    if has_bn != has_batch_stats:
        raise ValueError(
            f"has_batch_stats={has_batch_stats}, but the model "
            f"{'has' if has_bn else 'has no'} batch norm"
        )
    layout, weights, opt = _prepare(model, optimizer, mesh)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.train()
        n = x.shape[0]
        x, y = layout.shard(x), layout.shard(y)
        return _step(layout, weights, opt,
                     lambda: F.cross_entropy(model(x), y, reduction="sum") / n)

    step.optimizer = opt
    return step


def build_sharded_synthesis_step(model: nn.Module, optimizer: Callable, mesh) -> Callable:
    """The data-parallel step of a synthesis model:
    ``step(ecog, labels, targets) -> loss``, the global batch's mean
    ``|out - targets|``; ``optimizer`` and ``mesh`` as in
    :func:`build_sharded_classifier_step`."""
    layout, weights, opt = _prepare(model, optimizer, mesh)

    def step(ecog: torch.Tensor, labels: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model.train()
        count = targets.numel()
        ecog, labels, targets = (layout.shard(t) for t in (ecog, labels, targets))
        return _step(layout, weights, opt,
                     lambda: (model(ecog, labels) - targets).abs().sum() / count)

    step.optimizer = opt
    return step
