"""The GRU-CTC phoneme decoder of Willett et al., Nature 620, 1031-1036
(2023), the ``GRUDecoder`` of ``neural_seq_decoder``
(``src/neural_decoder/model.py``), with its CTC loss and its Adam-L2 step
(``scripts/train_model.py``), in plain PyTorch from the equations.

(B, T, C) binned features and each trial's day -> (B, L, n_classes + 1)
logits, blank 0:

1. depthwise Gaussian smoothing over time: 20 taps of a Gaussian of sd
   ``smooth_width`` centred at 9.5, over its sum, 9 bins of zeros before
   and 10 after (``padding="same"``);
2. ``softsign(x W_d + b_d)`` with the trial's day's weights;
3. patches of ``kernel_len`` bins at stride ``stride_len``, feature
   ``c * kernel_len + k``;
4. ``layer_dim`` GRU layers of ``hidden_dim``, both directions, each
   written cell by cell from h0 = 0::

       r  = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
       z  = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
       n  = tanh(x W_in + b_in + r (h W_hn + b_hn))
       h' = (1 - z) n + z h

   the reverse direction from the last frame back; the outputs of every
   layer but the last through dropout;
5. a linear layer.

The loss of a trial is its CTC negative log-likelihood over its first
``(T_b - kernel_len) // stride_len`` frames (the source's ``adjustedLens``),
from the forward (alpha) recursion in log space written out here, over
its target length; infeasible alignments count 0 (``zero_infinity``); a
batch's loss is the weighted mean over its trials. The step is Adam
(``torch.optim.Adam``'s equations) with the L2 term added to every
gradient first.

Departures from the source, all of the benchmark's making: the
configuration's weights are the harness's kinds (``param_spec``: LeCun
normal for every matrix, the day layer's too, zeros for every bias) where
the source starts ``weight_hh`` orthogonal, ``weight_ih`` Xavier-uniform,
the day layers at the identity and the GRU and output biases uniform;
the source's ``n_days`` unused input modules (``inpLayer{k}``) hold no
weights here; the smoothing kernel is computed in the reference's
precision (the source's in float32).

The augmentation and dropout are drawn again by the trainer's rule
(``decode_tonal_langauge_tpu_torch/training/sequence_trainer.py``): a
generator on the device seeded with the trainer's seed draws, each step,
the white noise (B, T_b, C), the offset (B, 1, C) and each dropout's
keep-mask (B, L, 2H) in layer order, all float32 (:func:`draws`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .layers import Spec, dropout, linear
from .precision import Precision

NEG = -1e30  # log of an unreachable state: finite, so no gradient turns NaN
TAPS = 20  # the smoothing kernel's length, the source's constant


def _suffixes(m: Dict) -> List[str]:
    return [""] + (["_reverse"] if m.get("bidirectional", True) else [])


def param_spec(m: Dict) -> Spec:
    c, h, k = m["neural_dim"], m["hidden_dim"], m["kernel_len"]
    d = len(_suffixes(m))
    spec: Spec = [("dayWeights", (m["n_days"], c, c), "lecun", c),
                  ("dayBias", (m["n_days"], 1, c), "zeros", 0)]
    for layer in range(m["layer_dim"]):
        n_in = c * k if layer == 0 else h * d
        for sfx in _suffixes(m):
            g = f"gru_decoder.{{}}_l{layer}{sfx}"
            spec += [(g.format("weight_ih"), (3 * h, n_in), "lecun", n_in),
                     (g.format("weight_hh"), (3 * h, h), "lecun", h),
                     (g.format("bias_ih"), (3 * h,), "zeros", 0),
                     (g.format("bias_hh"), (3 * h,), "zeros", 0)]
    return spec + [("fc_decoder_out.weight", (m["n_classes"] + 1, h * d), "lecun", h * d),
                   ("fc_decoder_out.bias", (m["n_classes"] + 1,), "zeros", 0)]


def frames(m: Dict, n_bins: int) -> int:
    """Frames the GRU sees for a batch padded to ``n_bins`` bins."""
    return (n_bins - m["kernel_len"]) // m["stride_len"] + 1


def input_lengths(m: Dict, lengths: Sequence[int]) -> List[int]:
    """The CTC's frames of each trial: ``(T_b - kernel_len) // stride_len``."""
    return [(int(t) - m["kernel_len"]) // m["stride_len"] for t in lengths]


def dropout_shapes(m: Dict, batch: int, n_bins: Optional[int] = None) -> Dict[str, tuple]:
    """Each between-layer dropout's input shape, in forward order, for a
    batch padded to ``n_bins`` bins (default: one frame's)."""
    steps = frames(m, n_bins or m["kernel_len"])
    width = m["hidden_dim"] * len(_suffixes(m))
    return {f"gru.l{k}": (batch, steps, width) for k in range(m["layer_dim"] - 1)}


def gaussian_kernel(taps: int, sd: float, dtype) -> torch.Tensor:
    grid = torch.arange(taps, dtype=dtype)
    k = torch.exp(-(((grid - (taps - 1) / 2) / sd) ** 2) / 2) / (sd * math.sqrt(2 * math.pi))
    return k / k.sum()


def gru_direction(x: torch.Tensor, wi, wh, bi, bh, prec: Precision,
                  reverse: bool) -> torch.Tensor:
    """One direction of a GRU layer over ``x`` (B, L, I), cell by cell."""
    n_b, n_t, _ = x.shape
    hid = wh.shape[1]
    gx = linear(x, wi, bi, prec)
    h = x.new_zeros(n_b, hid)
    out = [None] * n_t
    for t in (range(n_t - 1, -1, -1) if reverse else range(n_t)):
        gh = linear(h, wh, bh, prec)
        r = torch.sigmoid(gx[:, t, :hid] + gh[:, :hid])
        z = torch.sigmoid(gx[:, t, hid:2 * hid] + gh[:, hid:2 * hid])
        n = torch.tanh(gx[:, t, 2 * hid:] + r * gh[:, 2 * hid:])
        h = (1 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, day: torch.Tensor, m: Dict,
            prec: Precision, masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    c = m["neural_dim"]
    kern = gaussian_kernel(TAPS, m["smooth_width"], x.dtype).to(x.device)
    xp = F.pad(x.transpose(1, 2), ((TAPS - 1) // 2, TAPS // 2))
    smooth = F.conv1d(prec.operand(xp), prec.operand(kern.repeat(c, 1, 1)), groups=c)
    y = torch.bmm(prec.operand(smooth.transpose(1, 2)), prec.operand(p["dayWeights"][day]))
    y = F.softsign(y + p["dayBias"][day])
    n_b = y.shape[0]
    seq = y.unfold(1, m["kernel_len"], m["stride_len"])  # (B, L, C, K)
    seq = seq.reshape(n_b, seq.shape[1], c * m["kernel_len"])
    for layer in range(m["layer_dim"]):
        outs = []
        for sfx in _suffixes(m):
            g = f"gru_decoder.{{}}_l{layer}{sfx}"
            outs.append(gru_direction(seq, p[g.format("weight_ih")], p[g.format("weight_hh")],
                                      p[g.format("bias_ih")], p[g.format("bias_hh")], prec,
                                      reverse=bool(sfx)))
        seq = torch.cat(outs, dim=-1)
        if layer < m["layer_dim"] - 1:
            seq = dropout(seq, (masks or {}).get(f"gru.l{layer}"), m.get("dropout", 0.0))
    return linear(seq, p["fc_decoder_out.weight"], p["fc_decoder_out.bias"], prec)


def ctc_nll(log_probs: torch.Tensor, targets: torch.Tensor, in_lens: Sequence[int],
            tgt_lens: Sequence[int]) -> torch.Tensor:
    """Each trial's CTC negative log-likelihood (inf where no alignment
    exists): the alpha recursion over the extended labels (blank, t_1,
    blank, ..., t_S, blank) of ``targets`` (B, S), in log space, for
    ``log_probs`` (B, L, classes), blank 0."""
    n_b, n_t, _ = log_probs.shape
    dev = log_probs.device
    n_s = 2 * targets.shape[1] + 1
    ext = torch.zeros((n_b, n_s), dtype=torch.long, device=dev)
    ext[:, 1::2] = targets.to(dev)
    # a label state may also come from two states back: not a blank, not a repeat
    skip = torch.zeros((n_b, n_s), dtype=torch.bool, device=dev)
    skip[:, 3::2] = ext[:, 3::2] != ext[:, 1:-2:2]
    in_lens_t = torch.as_tensor(list(in_lens), device=dev)
    neg = log_probs.new_full((n_b, 1), NEG)
    lp = log_probs.gather(2, ext[:, None, :].expand(n_b, n_t, n_s))  # (B, L, S')
    alpha = torch.cat([lp[:, 0, :2], log_probs.new_full((n_b, n_s - 2), NEG)], dim=1)
    for t in range(1, n_t):
        one = torch.cat([neg, alpha[:, :-1]], dim=1)
        two = torch.where(skip, torch.cat([neg, neg, alpha[:, :-2]], dim=1), NEG)
        new = torch.logsumexp(torch.stack([alpha, one, two]), dim=0) + lp[:, t]
        alpha = torch.where((t < in_lens_t)[:, None], new, alpha)
    rows = torch.arange(n_b, device=dev)
    ends = 2 * torch.as_tensor(list(tgt_lens), device=dev)
    last = torch.logsumexp(torch.stack([alpha[rows, ends], alpha[rows, ends - 1]]), dim=0)
    return torch.where(last < NEG / 2, torch.full_like(last, math.inf), -last)


def ctc_batch_loss(logits: torch.Tensor, targets: torch.Tensor, in_lens: Sequence[int],
                   tgt_lens: Sequence[int], w: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The weighted mean over trials of the CTC loss over the target
    length, infinite losses counted 0."""
    nll = ctc_nll(torch.log_softmax(logits, dim=-1), targets, in_lens, tgt_lens)
    per = torch.where(torch.isinf(nll), torch.zeros_like(nll), nll)
    per = per / torch.as_tensor(list(tgt_lens), dtype=nll.dtype, device=nll.device).clamp_min(1)
    return (per * w).sum() / total.clamp_min(1.0)


def draws(seed: int, shapes: Sequence[Dict[str, tuple]], noise_shapes: Sequence[tuple],
          p_drop: float, device) -> List[Dict[str, torch.Tensor]]:
    """Each step's augmentation and keep-masks, by the trainer's rule: per
    step ``noise`` (B, T_b, C), ``offset`` (B, 1, C) and the masks of
    ``shapes[step]``, in that order, from one generator on ``device``
    seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for masks, (n_b, n_t, c) in zip(shapes, noise_shapes):
        step = {"noise": torch.randn((n_b, n_t, c), generator=g, device=device),
                "offset": torch.randn((n_b, 1, c), generator=g, device=device)}
        for name, shape in masks.items():
            step[name] = torch.empty(shape, dtype=torch.float32, device=device).bernoulli_(
                1.0 - p_drop, generator=g)
        out.append(step)
    return out


def follow_steps(forward_fn: Callable, params0: Dict[str, torch.Tensor], batches: Sequence,
                 hyper: Dict, prec: Precision, device) -> Dict[str, object]:
    """``len(batches)`` Adam-L2 steps from ``params0``. ``batches[k]`` is
    (x, day, targets, in_lens, tgt_lens, w, masks) of step k, ``x`` already
    augmented; ``forward_fn(p, x, day, masks=...)`` the model. Returns each
    step's loss, the first gradient per tensor (``grad``; ``grad_eff`` with
    the L2 term, what Adam's first moment holds) and each tensor's change
    after the steps, as norms by name."""
    dt = prec.dtype
    p = {k: v.to(device=device, dtype=dt).clone() for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = hyper["b1"], hyper["b2"], hyper["eps"]
    lr, wd = hyper["learning_rate"], hyper["weight_decay"]
    losses, first = [], {}
    for step, (x, day, targets, in_lens, tgt_lens, w, masks) in enumerate(batches, start=1):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        w = w.to(device=device, dtype=dt)
        logits = forward_fn(leaves, x.to(device=device, dtype=dt), day.to(device),
                            masks={k: v.to(dt) for k, v in masks.items()})
        loss = ctc_batch_loss(logits, targets.to(device), in_lens, tgt_lens, w, w.sum())
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in grads.items():
                g_eff = g + wd * p[k]
                if step == 1:
                    first[k] = (float(g.norm()), float(g_eff.norm()))
                mu[k] = b1 * mu[k] + (1 - b1) * g_eff
                nu[k] = b2 * nu[k] + (1 - b2) * g_eff * g_eff
                denom = torch.sqrt(nu[k]) / math.sqrt(1 - b2 ** step) + eps
                p[k] = p[k] - lr / (1 - b1 ** step) * mu[k] / denom
        del leaves, grads, logits, loss
    change = {k: float((p[k] - params0[k].to(device=device, dtype=dt)).norm()) for k in p}
    return {"loss": losses, "grad": {k: v[0] for k, v in first.items()},
            "grad_eff": {k: v[1] for k, v in first.items()}, "change": change}
