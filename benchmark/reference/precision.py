"""The precisions the reference computes in.

- ``f64``: float64, the reference itself.
- ``f32``: float32 with TF32 off, the configurations' own precision.
- ``tf32``: float32 in which every matmul and convolution first rounds
  its operands to TF32 (10 explicit mantissa bits, round to nearest),
  the next precision below float32: the control. The rounding is done
  here, on the tensors, so it means the same on the CPU and on the card;
  the backend's own TF32 switches stay off in every mode.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    name: str

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "f64" else torch.float32

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a product's operand: rounded to TF32 in ``tf32``."""
        return to_tf32(x) if self.name == "tf32" else x


F64, F32, TF32 = Precision("f64"), Precision("f32"), Precision("tf32")
BY_NAME = {p.name: p for p in (F64, F32, TF32)}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest on TF32's 10-bit mantissa (ties
    away from zero), as a float32 tensor. Differentiable as the identity,
    so a gradient taken through it is the rounded forward's."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


@contextlib.contextmanager
def no_tf32():
    """The backends' own TF32 off for the block (cuBLAS and cuDNN)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before
