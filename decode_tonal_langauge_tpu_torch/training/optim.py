"""NAdam with decay/no-decay parameter groups, the optax update written out;
and Adam with L2, ``torch.optim.Adam``'s update (:class:`Adam`).

Counterpart of ``decode_tonal_langauge_tpu/training/optim.py``, whose
optimizer is ``optax.chain(add_decayed_weights(wd, mask=ndim >= 2),
nadam(lr))``. That is not ``torch.optim.NAdam`` (which adds a
momentum-decay schedule) nor AdamW (whose decay is decoupled): the decay
is an L2 term added to the gradient before NAdam, on parameters of two or
more dimensions only. The synthesizer's optimizer
(``training/synthesis_trainer.py``) decays every parameter: that is
``decay_all=True``. One step, with ``t`` the step count after
increment::

    g      = grad + wd * p                     (ndim >= 2, or every p)
    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * g * g + b2 * nu
    mu_hat = b1 * mu / (1 - b1**(t+1)) + (1 - b1) * g / (1 - b1**t)
    nu_hat = nu / (1 - b2**t)
    p      = p + (mu_hat / (sqrt(nu_hat) + eps)) * -lr

(optax ``scale_by_adam(nesterov=True)``; ``eps`` outside the root). The
bias corrections are formed in float32, as optax forms them.

``moment_dtype`` (e.g. ``"bfloat16"``) stores ``mu`` and ``nu`` in that
dtype at rest; each step widens them to float32, updates in float32 and
rounds the new moments back (JAX ``with_moment_dtype``). By default the
moments take each parameter's dtype, and float64 parameters update in
float64.

:class:`SeedNAdam` runs the same update on seed-stacked tensors (a
leading axis of S seeds, ``training/seed_stack.py``): the decay mask is
taken from each tensor's per-seed shape, as the JAX package's mask sees
unbatched shapes inside ``vmap``, so a stacked bias (ndim 2) is not
decayed.

On the card a step is one launch of K4, ``csrc/nadam_step.cu`` (built by
``_build.py``, bound with ``ctypes``): the whole update for every tensor
in one pass over memory, bit-identical to the plain chain
(:func:`nadam_plain`) on the card for float32 parameters with float32 or
bfloat16 moments and float64 parameters with float64 moments. A step is
the op ``tonal::nadam_step``: on CPU tensors it runs the plain chain, on
CUDA tensors it launches K4 or raises (:func:`kernel_pair`). ``LAUNCHES``
counts K4's launches: one a step, or one for each :data:`MAX_TENSORS`
tensors (or :data:`MAX_STRIDED` gradients that are not contiguous) of a
larger optimizer.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .._build import I32, PTR, launched, library, stream
from ..runtime.profiling import span


def decay_mask(params: Sequence[torch.Tensor], seed_axis: bool = False) -> List[bool]:
    """True for parameters that receive weight decay (ndim >= 2, not
    counting a leading seed axis)."""
    return [p.ndim - int(seed_axis) >= 2 for p in params]


def _moment_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


LAUNCHES = 0  # K4 launches
# What one K4 launch takes (csrc/nadam_step.cu's kMaxTensors, kMaxStrided,
# kMaxDims): tensors, gradients that are not contiguous, and the dims of
# such a gradient once collapsed.
MAX_TENSORS, MAX_STRIDED, MAX_DIMS = 64, 12, 5
_PAIRS = {(torch.float32, torch.float32): 0, (torch.float32, torch.bfloat16): 1,
          (torch.float64, torch.float64): 2}


class Hyper(NamedTuple):
    """One step's constants: the learning rate, the decay, the betas, eps
    and the float32 bias corrections ``1 - b1**t``, ``1 - b1**(t+1)`` and
    ``1 - b2**t`` of step ``t``."""

    lr: float
    wd: float
    b1: float
    b2: float
    eps: float
    bc1: float
    bc1_next: float
    bc2: float


def nadam_plain(params, grads, mu, nu, decay, h: Hyper) -> None:
    """One step of the plain chain, tensor by tensor, on any device: the
    CPU's path and K4's reference (``decay``: the decay term's flag of
    each tensor)."""
    for p, g, m_, v_, decays in zip(params, grads, mu, nu, decay):
        dtype = torch.promote_types(p.dtype, torch.float32)  # float32 at least
        g = g.to(dtype)
        if h.wd and decays:
            g = g + h.wd * p
        m = (1 - h.b1) * g + h.b1 * m_.to(dtype)
        v = (1 - h.b2) * (g * g) + h.b2 * v_.to(dtype)
        mu_hat = h.b1 * (m / h.bc1_next) + (1 - h.b1) * (g / h.bc1)
        update = mu_hat / (torch.sqrt(v / h.bc2) + h.eps)
        p.copy_(p + update * -h.lr)
        m_.copy_(m)
        v_.copy_(v)


def grad_layout(g: torch.Tensor) -> Optional[List[Tuple[int, int]]]:
    """None for a contiguous gradient; else its (size, stride) dims,
    outermost first, with size-1 dims dropped and dims that step as one
    merged. Raises if more than :data:`MAX_DIMS` are left."""
    if g.is_contiguous():
        return None
    dims: List[Tuple[int, int]] = []
    for size, stride in zip(g.shape, g.stride()):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > MAX_DIMS:
        raise ValueError(f"nadam kernel: a gradient of strides {g.stride()} collapses to "
                         f"{len(dims)} dims, more than {MAX_DIMS}")
    return dims


def kernel_pair(params, grads, mu, nu) -> int:
    """K4's code for the (parameter, moment) dtype pair of these tensors;
    raises unless every tensor lies on one device, each gradient and
    moment has its parameter's shape, each gradient its dtype, every pair
    is one that K4 takes, the parameters and moments are contiguous and
    each gradient is contiguous or collapses to :data:`MAX_DIMS` dims."""
    if not (len(params) == len(grads) == len(mu) == len(nu)) or not params:
        raise ValueError("nadam kernel: one gradient and two moments for each of "
                         "one or more parameters")
    pd, md, device = params[0].dtype, mu[0].dtype, params[0].device
    for p, g, m, v in zip(params, grads, mu, nu):
        if not (p.dtype == g.dtype == pd and m.dtype == v.dtype == md and (pd, md) in _PAIRS):
            raise TypeError("nadam kernel: every parameter and gradient float32 with float32 "
                            "or bfloat16 moments, or float64 with float64 moments, one pair for "
                            f"all; got {p.dtype}, {g.dtype}, {m.dtype}, {v.dtype} beside "
                            f"{pd}, {md}")
        if not (p.device == g.device == m.device == v.device == device):
            raise ValueError(f"nadam kernel: every tensor on {device}, got "
                             f"{[str(t.device) for t in (p, g, m, v)]}")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"nadam kernel: a gradient and moments of the parameter's shape "
                             f"{tuple(p.shape)}")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("nadam kernel: contiguous parameters and moments")
        grad_layout(g)
    return _PAIRS[pd, md]


_bound = library("nadam_step", {
    "nadam_step": (I32, I32, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
                   PTR),
    "nadam_step_limits": (ctypes.POINTER(ctypes.c_int),) * 3,
})


@lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """``csrc/nadam_step.cu``, its compile-time limits checked against
    this module's."""
    lib = _bound()
    limits = [ctypes.c_int() for _ in range(3)]
    lib.nadam_step_limits(*map(ctypes.byref, limits))
    if tuple(x.value for x in limits) != (MAX_TENSORS, MAX_STRIDED, MAX_DIMS):
        raise RuntimeError("csrc/nadam_step.cu's limits differ from MAX_TENSORS, "
                           "MAX_STRIDED, MAX_DIMS")
    return lib


def nadam_cuda(params, grads, mu, nu, decay, h: Hyper) -> None:
    """One step by K4: one launch for each :data:`MAX_TENSORS` tensors
    or :data:`MAX_STRIDED` gradients that are not contiguous (empty
    tensors take none)."""
    global LAUNCHES
    pair = kernel_pair(params, grads, mu, nu)
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"nadam kernel: CUDA tensors, got {device}")
    # The constants rounded to the working type as ATen rounds a Python
    # scalar; a division by one is a product with its reciprocal.
    f = np.float64 if pair == 2 else np.float32
    scalars = (ctypes.c_double * 10)(*(float(x) for x in (
        f(h.b1), f(1 - h.b1), f(h.b2), f(1 - h.b2), f(1) / f(h.bc1_next), f(1) / f(h.bc1),
        f(1) / f(h.bc2), f(h.eps), f(-h.lr), f(h.wd))))
    moment_bytes = 16 // params[0].element_size() * mu[0].element_size()
    contiguous = (0,) * (1 + 2 * MAX_DIMS)
    groups, rows, strided = [], [], 0
    for p, g, m, v, decays in zip(params, grads, mu, nu, decay):
        n = p.numel()
        if n == 0:
            continue
        ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        flags = int(bool(h.wd and decays)) | 2 * int(not (
            ptrs[0] % 16 or ptrs[1] % 16 or ptrs[2] % moment_bytes or ptrs[3] % moment_bytes))
        dims = grad_layout(g)
        if len(rows) == MAX_TENSORS or (dims and strided == MAX_STRIDED):
            groups.append(rows)
            rows, strided = [], 0
        if dims:
            strided += 1
            pad = (0,) * (MAX_DIMS - len(dims))
            layout = (len(dims), *(d[0] for d in dims), *pad, *(d[1] for d in dims), *pad)
        rows.append(ptrs + (n, flags) + (layout if dims else contiguous))
    groups.append(rows)
    lib = _library()
    with torch.cuda.device(device):
        cuda_stream = stream(params[0])
        for rows in filter(None, groups):
            table = (ctypes.c_longlong * (len(rows) * len(rows[0])))(*(x for r in rows for x in r))
            err = lib.nadam_step(pair, len(rows), table, scalars, cuda_stream)
            launched(err, "nadam_step", "{} tensors", len(rows))
            LAUNCHES += 1


# ``tonal::nadam_step``: one step on lists of tensors, the plain chain on
# CPU tensors and K4 on CUDA tensors. An op, so that a profiler's trace
# holds the host op under which K4 is launched.
_LIB = torch.library.Library("tonal", "FRAGMENT")
_LIB.define("nadam_step(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] mu, "
            "Tensor(c!)[] nu, bool[] decay, float[] hyper) -> ()")
_LIB.impl("nadam_step", lambda p, g, m, v, d, h: nadam_plain(p, g, m, v, d, Hyper(*h)), "CPU")
_LIB.impl("nadam_step", lambda p, g, m, v, d, h: nadam_cuda(p, g, m, v, d, Hyper(*h)), "CUDA")


class NAdam:
    """The optax NAdam update on a list of tensors or a module's
    parameters. ``step(grads)`` takes the gradients in parameter order
    (``None``: each parameter's ``.grad``). Weight decay reaches the
    parameters of :func:`decay_mask`, or every parameter with
    ``decay_all``."""

    seed_axis = False  # SeedNAdam: every tensor leads with a seed axis

    def __init__(
        self,
        params: Union[nn.Module, Iterable[torch.Tensor]],
        learning_rate: float,
        weight_decay: float = 0.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        moment_dtype=None,
        decay_all: bool = False,
    ) -> None:
        if isinstance(params, nn.Module):
            params = params.parameters()
        self.params = list(params)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = _moment_dtype(moment_dtype)
        self.decay = ([True] * len(self.params) if decay_all
                      else decay_mask(self.params, self.seed_axis))
        dtype = lambda p: self.moment_dtype or p.dtype  # noqa: E731
        self.mu = [torch.zeros_like(p, dtype=dtype(p)) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=dtype(p)) for p in self.params]
        self.count = 0

    def hyper(self) -> Hyper:
        """The constants of step ``count``."""
        return Hyper(self.learning_rate, self.weight_decay, self.b1, self.b2, self.eps,
                     _bias_correction(self.b1, self.count),
                     _bias_correction(self.b1, self.count + 1),
                     _bias_correction(self.b2, self.count))

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        with span("optim.nadam"):
            if grads is None:
                grads = [p.grad for p in self.params]
            self.count += 1
            if self.params:
                torch.ops.tonal.nadam_step(self.params, list(grads), self.mu, self.nu,
                                           self.decay, [float(x) for x in self.hyper()])

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"optimizer state {tuple(src.shape)} {src.dtype} does not "
                    f"fit a moment of {tuple(dst.shape)} {dst.dtype}"
                )
            dst.copy_(src)


class SeedNAdam(NAdam):
    """:class:`NAdam` on seed-stacked tensors (S, ...), with the per-seed
    decay mask of the module docstring. Every seed in the stacks steps at
    each :meth:`step`, so ``count`` is each seed's own step count; a seed
    that stops leaves the stacks (:meth:`select`), and neither its weights
    nor its moments move again."""

    seed_axis = True

    def select(self, params: Sequence[torch.Tensor], keep: torch.Tensor) -> None:
        """Keep the seeds at indices ``keep`` (a long tensor): the stacks
        now hold ``params``, those seeds' rows in that order."""
        self.params = list(params)
        self.mu = [m[keep.to(m.device)] for m in self.mu]
        self.nu = [v[keep.to(v.device)] for v in self.nu]


class Adam(NAdam):
    """``torch.optim.Adam`` with ``weight_decay`` (an L2 term added to the
    gradient of every parameter, before the moments), the optimizer of the
    GRU-CTC decoder's published training (``training/sequence_trainer.py``).
    One step, ``t`` the step count after increment::

        g = grad + wd * p
        m = m + (1 - b1) * (g - m)
        v = b2 * v + (1 - b2) * g * g
        p = p - lr / (1 - b1**t) * m / (sqrt(v) / sqrt(1 - b2**t) + eps)

    run as ``torch.optim.Adam``'s multi-tensor path runs it: each line one
    ``torch._foreach_*`` call over every parameter, a handful of launches a
    step on the card. It keeps :class:`NAdam`'s moments, step count and
    state dict."""

    def __init__(self, params: Union[nn.Module, Iterable[torch.Tensor]], learning_rate: float,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        super().__init__(params, learning_rate, weight_decay, b1, b2, eps, decay_all=True)

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        with span("optim.adam"):
            grads = [p.grad for p in self.params] if grads is None else list(grads)
            b1, b2 = self.b1, self.b2
            self.count += 1
            if self.weight_decay:
                grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
            torch._foreach_lerp_(self.mu, grads, 1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, 1 - b2)
            denom = torch._foreach_sqrt(self.nu)
            torch._foreach_div_(denom, math.sqrt(1 - b2 ** self.count))
            torch._foreach_add_(denom, self.eps)
            torch._foreach_addcdiv_(self.params, self.mu, denom,
                                    -self.learning_rate / (1 - b1 ** self.count))
