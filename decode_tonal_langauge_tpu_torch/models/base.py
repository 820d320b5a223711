"""Model base utilities: shape math, activations, parameter counts,
seeded initialisation, and the compute-dtype helpers.

Counterpart of ``decode_tonal_langauge_tpu/models/base.py``. A model's
``dtype`` is its compute dtype, as a Flax module's ``dtype`` field: the
parameters stay float32 at rest and each layer casts its input and its
weights to ``dtype`` inside ``forward``, so autograd returns float32
gradients to the float32 parameters (the JAX ``.astype``). ``None``
computes in the parameters' own dtype (float32, or float64 for a
reference run). ``torch.autocast`` is not used: it follows its own op
lists and would also cast the float32 class heads.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lstm import TimeBatchedLSTM
from ..ops.stencil import StencilConvPoolLeaky


def conv_output_length(
    length: int, kernel: int, stride: int = 1, padding: int = 0
) -> int:
    """Torch-style conv/pool output-length formula (floor division)."""
    return (length + 2 * padding - kernel) // stride + 1


def compute_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A compute dtype from a config: a name (``"bfloat16"``,
    ``"float32"``, ``"float16"``, as YAML gives it) or a floating
    ``torch.dtype``; None stays None. Raises on an unknown name or a
    non-floating dtype."""
    if dtype is None:
        return None
    resolved = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if isinstance(resolved, torch.dtype) and resolved.is_floating_point:
        return resolved
    raise ValueError(
        f"compute dtype {dtype!r}: expected a floating dtype name "
        "(float32, bfloat16, float16) or a floating torch.dtype"
    )


def conv(layer: nn.Module, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer`` (an ``nn.Conv1d``/``nn.Conv2d``) applied to ``x`` in
    ``dtype``; None runs the layer as it is."""
    if dtype is None:
        return layer(x)
    return layer._conv_forward(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer`` applied to ``x`` in ``dtype``; None runs it as it is."""
    if dtype is None:
        return _linear(layer, x, layer.weight, layer.bias)
    return _linear(layer, x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _linear(layer: nn.Linear, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``F.linear``; a column-parallel shard of the layer
    (``parallel/train_step.py``) also gathers its outputs over the
    ``model`` axis."""
    sharded = getattr(layer, "sharded_linear", None)
    return F.linear(x, weight, bias) if sharded is None else sharded(x, weight, bias)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to float32 (a float64 reference run stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def head(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A class head computed in at least float32, whatever the model's
    compute dtype: a bfloat16 head would put the logits on bfloat16's
    2^-8 grid, and its sigmoid outputs would then tie exactly, so that
    argmax, and with it training's and evaluation's metrics of one
    checkpoint, would hang on rounding (JAX ``models/deep.py:87-94``)."""
    x = at_least_f32(x)
    return _linear(layer, x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def get_activation(name: str, **kwargs) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name, with the JAX package's (Flax) defaults."""
    table = {
        "ELU": lambda x: F.elu(x, alpha=kwargs.get("alpha", 1.0)),
        "ReLU": F.relu,
        "LeakyReLU": lambda x: F.leaky_relu(
            x, negative_slope=kwargs.get("negative_slope", 0.01)
        ),
        "PReLU": lambda x: F.leaky_relu(
            x, negative_slope=kwargs.get("negative_slope", 0.25)
        ),
        "GLU": lambda x: F.glu(x, dim=kwargs.get("axis", -1)),
        "GELU": lambda x: F.gelu(x, approximate="tanh"),  # flax default
    }
    if name not in table:
        raise ValueError(f"Unsupported activation function: {name}")
    return table[name]


# The standard deviation of a unit normal cut at +-2 sigma: Flax's
# ``variance_scaling`` divides by it so the truncated draw keeps unit
# variance.
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """Flax's ``lecun_normal()``: a unit normal truncated to [-2, 2], drawn
    as ``jax.random.truncated_normal`` draws it (uniforms between
    erf(-sqrt 2) and erf(sqrt 2) mapped through sqrt(2) erfinv), scaled by
    ``1 / sqrt(fan_in) / _TRUNCATED_STD``."""
    edge = math.erf(math.sqrt(2.0))
    u = torch.rand(w.shape, generator=g, dtype=torch.float64) * (2 * edge) - edge
    z = (math.sqrt(2.0) * torch.erfinv(u)).clamp_(-2.0, 2.0)
    w.copy_(z / (math.sqrt(fan_in) * _TRUNCATED_STD))


def _orthogonal(n: int, g: torch.Generator) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn((n, n), generator=g))
    return q * torch.sign(torch.diagonal(r))


_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _state(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Trainable tensors by state-dict key: a module's parameters, or a
    state dict without its batch-norm buffers (Flax keeps those apart,
    in ``batch_stats``)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return {k: v for k, v in params.items() if k.rsplit(".", 1)[-1] not in _BN_BUFFERS}


def count_params(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Total number of trainable parameters of a module or a state dict."""
    return int(sum(v.numel() for v in _state(params).values()))


def layer_param_counts(
    params: Union[nn.Module, Mapping[str, torch.Tensor]]
) -> Dict[str, int]:
    """Parameter count per top-level child under the JAX package's module
    names (``convs.0`` counts as ``convs_0``), the reference's
    ``get_layer_nparams``."""
    counts: Dict[str, int] = {}
    for key, value in _state(params).items():
        parts = key.split(".")
        name = f"{parts[0]}_{parts[1]}" if len(parts) > 2 and parts[1].isdigit() else parts[0]
        counts[name] = counts.get(name, 0) + value.numel()
    return counts


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights with Flax's default schemes: truncated
    LeCun-normal kernels, orthogonal recurrent kernels (per gate), zero biases, unit
    BatchNorm scale. Drawn on the CPU from one ``torch.Generator``, so a
    seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), g)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, g)
            m.bias.zero_()
        elif isinstance(m, StencilConvPoolLeaky):
            _lecun_normal_(m.weight, m.weight.shape[0], g)
            m.bias.zero_()
        elif isinstance(m, TimeBatchedLSTM):
            _lecun_normal_(m.wi, m.wi.shape[0], g)
            m.wh.copy_(torch.cat(
                [_orthogonal(m.features, g) for _ in range(4)], dim=1
            ))
            m.b.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module
