"""Vectorized one-way ANOVA over (channel, time) grids, in torch.

Counterpart of ``decode_tonal_langauge_tpu/ops/anova.py``: the closed-form
F statistic at every trailing position and its p-value, on the device of
the input. The F statistic is computed in the input's dtype (float32), as
JAX does.

The p-value needs the regularized incomplete beta, which ``torch.special``
lacks. :func:`betainc` is JAX's algorithm
(``jax/_src/lax/special.py:regularized_incomplete_beta_impl``): the DLMF
8.17.23 continued fraction evaluated by Lentz-Thompson-Barnett, the
symmetry swap where ``x >= (a+1)/(a+b+2)`` and the prefactor from
``lgamma``, ``log`` and ``log1p``. It runs in **float64** whatever the
input's dtype, and :func:`f_sf` casts p back. The grids are only C x T, so
float64 costs little, and it keeps p within ~1e-6 of SciPy where a float32
fraction strays ~1e-4 below p = 1e-3 and ~1e-3 near p = 1. The fraction
takes a fixed :data:`CF_ITERATIONS` steps (JAX's float32 count) with no
early exit, so it never waits on the device; a step past convergence
multiplies by 1.

Group sums are sums of contiguous slices of the trials sorted by label
(an exact float32 reduction, never TF32, and deterministic on the card,
where ``index_add_`` sums with atomics).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

CF_ITERATIONS = 200

Number = Union[float, torch.Tensor]


def betainc(a: Number, b: Number, x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` in float64, elementwise
    (``a``, ``b`` broadcast against ``x``)."""
    x = x.to(torch.float64)
    a = torch.as_tensor(a, dtype=torch.float64, device=x.device).expand_as(x)
    b = torch.as_tensor(b, dtype=torch.float64, device=x.device).expand_as(x)

    # The fraction converges fast for x < (a+1)/(a+b+2); elsewhere
    # I_x(a, b) = 1 - I_{1-x}(b, a) (DLMF 8.17.4).
    direct = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(direct, a, b), torch.where(direct, b, a)
    x = torch.where(direct, x, 1.0 - x)

    # Partial numerators of DLMF 8.17.23 for every step at once: step 1's
    # is 1, then step n has m = (n-1)//2 and d_{2m} (n even) or d_{2m+1}.
    n = torch.arange(2, CF_ITERATIONS, dtype=torch.float64, device=x.device)
    m = torch.floor((n - 1.0) / 2.0).view(-1, *([1] * x.dim()))
    even = (n % 2 == 0).view_as(m)
    two_m = 2.0 * m
    num_even = -(a + m) * (a + b + m) * x / ((a + two_m) * (a + two_m + 1.0))
    num_zero = -(a + b) * x / (a + 1.0)  # m == 0: JAX's FTZ-safe form
    num_even = torch.where(m == 0, num_zero, num_even)
    num_odd = m * (b - m) * x / ((a + two_m - 1.0) * (a + two_m))
    numerators = torch.where(even, num_even, num_odd)

    # Lentz-Thompson-Barnett. The partial denominators are 0 (step 0),
    # then 1, so h and C start at `small` and D at 0.
    small = float(np.finfo(np.float64).eps / 2)
    one = torch.ones_like(x)
    h = torch.full_like(x, small)
    c = h.clone()
    d = torch.zeros_like(x)
    for num in (one, *numerators):
        c = torch.addcdiv(one, num, c)
        c = torch.where(c.abs() < small, small, c)
        d = torch.addcmul(one, num, d)
        d = torch.where(d.abs() < small, small, d).reciprocal_()
        h = h * c * d

    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    very_small = float(np.finfo(np.float64).tiny * 2)
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a,
    )
    result = h * factor
    return torch.where(direct, result, 1.0 - result)


def f_sf(f_stat: torch.Tensor, dfn: Number, dfd: Number) -> torch.Tensor:
    """Survival function of the F distribution, ``P(F > f)``:
    ``I_x(dfd/2, dfn/2)`` at ``x = dfd/(dfd + dfn*f)``. ``x`` is formed
    in ``f_stat``'s dtype, as JAX forms it (in float32 it rounds to
    ~1 - 5e-7 near F = 1e-4, which moves p near 1 by ~3e-3 in both
    packages); the fraction runs in float64 and p returns in that dtype."""
    x = dfd / (dfd + dfn * f_stat)
    return betainc(dfd / 2.0, dfn / 2.0, x).to(f_stat.dtype)


def f_oneway_two_groups(
    a: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-way ANOVA of two sample groups at every trailing position.

    ``a``: (Na, ...), ``b``: (Nb, ...), groups along axis 0 (trials).
    Returns (F, p) of shape ``a.shape[1:]``, as
    ``scipy.stats.f_oneway(a, b)``."""
    na, nb = a.shape[0], b.shape[0]
    n = na + nb
    mean_a = a.mean(dim=0)
    mean_b = b.mean(dim=0)
    grand = (na * mean_a + nb * mean_b) / n
    ssb = na * (mean_a - grand) ** 2 + nb * (mean_b - grand) ** 2
    ssw = ((a - mean_a) ** 2).sum(dim=0) + ((b - mean_b) ** 2).sum(dim=0)
    dfn, dfd = 1.0, float(n - 2)  # k - 1 and n - k with k = 2
    f = (ssb / dfn) / (ssw / dfd)
    return f, f_sf(f, dfn, dfd)


def f_oneway_labeled(
    x: torch.Tensor, labels, n_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-way ANOVA grouping samples (axis 0) by integer ``labels``.

    ``x``: (N, ...) on any device; ``labels``: (N,) host integers in
    [0, n_groups). Returns (F, p) of shape ``x.shape[1:]``, as
    ``scipy.stats.f_oneway(*groups)`` over the same partition."""
    labels = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels)
    labels = labels.astype(np.int64).reshape(-1)
    if labels.size and (labels.min() < 0 or labels.max() >= n_groups):
        raise ValueError(f"labels must lie in [0, {n_groups})")
    n = x.shape[0]
    counts = np.bincount(labels, minlength=n_groups)
    flat = x.reshape(n, -1)

    order = torch.as_tensor(np.argsort(labels, kind="stable"), device=x.device)
    segments = torch.split(flat.index_select(0, order), counts.tolist())
    group_sums = torch.stack([seg.sum(dim=0) for seg in segments])  # (G, D)
    counts_t = torch.as_tensor(counts, dtype=x.dtype, device=x.device)
    group_means = group_sums / counts_t.clamp_min(1.0)[:, None]
    grand = flat.mean(dim=0)

    ssb = (counts_t[:, None] * (group_means - grand) ** 2).sum(dim=0)
    # SSW from group-mean-centred residuals (avoids SST - SSB cancellation).
    idx = torch.as_tensor(labels, device=x.device)
    ssw = ((flat - group_means[idx]) ** 2).sum(dim=0)

    k = int((counts > 0).sum())
    dfn, dfd = float(k - 1), float(n - k)
    f = (ssb / dfn) / (ssw / dfd)
    p = f_sf(f, dfn, dfd)
    return f.reshape(x.shape[1:]), p.reshape(x.shape[1:])
