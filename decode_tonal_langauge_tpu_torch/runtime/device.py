"""Device selection for the port's entry points.

The counterpart of ``decode_tonal_langauge_tpu/runtime/platform.py``.
Entry points take ``device=None``, which means the CUDA card: when there
is none they raise instead of quietly running on the CPU. The CPU runs
only when a caller asks for it (``device="cpu"``), as the tests do. Under
a process group (``parallel/distributed.py``) the card is the rank's own,
``cuda:{LOCAL_RANK}``, which ``initialize`` made the current device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card), the rank's card under
    a process group; else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


@contextlib.contextmanager
def f32_accumulation():
    """cuBLAS sums bfloat16 and float16 GEMMs in float32 for the duration
    of the block, rounding once at the end.

    By default cuBLAS may reduce a half-precision GEMM's split-K partial
    sums in the half type (``allow_bf16_reduced_precision_reduction``);
    JAX asks XLA for float32 accumulation (``preferred_element_type``).
    Float32 GEMMs are untouched. The caller's flags are restored on exit.
    """
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_bf16_reduced_precision_reduction,
              matmul.allow_fp16_reduced_precision_reduction)
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_bf16_reduced_precision_reduction,
         matmul.allow_fp16_reduced_precision_reduction) = before


@contextlib.contextmanager
def exact_f32(deterministic: bool = False):
    """cuDNN convolutions in full f32, and half-precision GEMMs summed in
    f32 (:func:`f32_accumulation`), for the duration of the block.

    cuDNN defaults to TF32 (about three decimal digits), which would break
    argmax parity with the JAX reference. Matmuls already default to full
    f32 (``torch.backends.cuda.matmul.allow_tf32`` is False) and are left
    alone. ``deterministic`` also restricts cuDNN to its deterministic
    algorithms (some weight- and data-gradient algorithms sum with
    atomics, so two runs of one step differ in the last bits). The
    caller's flags are restored on exit.
    """
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark and not deterministic,
        deterministic=cudnn.deterministic or deterministic,
        allow_tf32=False,
    ), f32_accumulation():
        yield
