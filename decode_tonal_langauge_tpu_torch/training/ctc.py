"""The CTC loss of a sequence decoder, with spans around its forward and
its backward.

Per trial b, ``-log p(targets_b | logits_b)`` over the first
``input_lengths[b]`` frames, blank 0, the logits turned into log
probabilities by ``log_softmax`` over classes; an infeasible alignment's
infinite loss is zeroed (``zero_infinity``), and its gradient with it.
:func:`ctc_loss` returns each trial's loss divided by its target length
(at least 1): ``torch.nn.CTCLoss(blank=0, reduction="mean",
zero_infinity=True)`` is the mean of these over the batch, which a
trainer takes with its rows' weights.

ATen computes the alignment sums (``aten::_ctc_loss`` and its backward;
the lengths as host lists, so nothing waits on the device). The forward
runs under the span ``ctc.loss`` and the gradient, which autograd runs
on its own thread on the card, under ``ctc.grad``. ATen's backward gives
the gradient of the logits through ``log_softmax`` for valid frames (the
alignment term less the class probabilities; frames past a trial's
length get none); the ``log_softmax`` backward around it is then exact,
as ``F.ctc_loss`` takes it through autograd.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..runtime.profiling import span


class _CTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, input_lengths, target_lengths):
        with span("ctc.loss"):
            log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)  # (L, B, C)
            nll, alpha = torch.ops.aten._ctc_loss(log_probs, targets, input_lengths,
                                                  target_lengths, 0, True)
            scale = 1.0 / torch.tensor(target_lengths, dtype=logits.dtype).clamp_min(1.0)
            scale = scale.to(logits.device, non_blocking=True)
            per = torch.where(torch.isinf(nll), torch.zeros_like(nll), nll) * scale
        ctx.save_for_backward(log_probs, targets, nll, alpha, scale)
        ctx.lengths = (input_lengths, target_lengths)
        return per

    @staticmethod
    def backward(ctx, grad):
        log_probs, targets, nll, alpha, scale = ctx.saved_tensors
        input_lengths, target_lengths = ctx.lengths
        with span("ctc.grad"):
            g = torch.ops.aten._ctc_loss_backward(grad * scale, log_probs, targets,
                                                  input_lengths, target_lengths, nll, alpha,
                                                  0, True)
            g = torch._log_softmax_backward_data(g, log_probs, -1, log_probs.dtype)
        return g.transpose(0, 1), None, None, None


def ctc_loss(logits: torch.Tensor, targets: torch.Tensor, input_lengths: Sequence[int],
             target_lengths: Sequence[int]) -> torch.Tensor:
    """Each trial's CTC loss over its target length (module docstring):
    ``logits`` (B, L, C), ``targets`` (B, S) padded class ids (1..C-1),
    the lengths as host lists of ints. Returns (B,)."""
    return _CTC.apply(logits, targets, [int(n) for n in input_lengths],
                      [int(n) for n in target_lengths])


def greedy_decode(logits: torch.Tensor, input_lengths: Sequence[int]):
    """Each trial's best path: the argmax class of each of its frames,
    repeats merged and blanks dropped (lists of ids, on the host)."""
    best = logits.argmax(dim=-1).cpu().numpy()
    out = []
    for row, n in zip(best, input_lengths):
        seq = row[:int(n)]
        keep = [int(c) for i, c in enumerate(seq) if c != 0 and (i == 0 or c != seq[i - 1])]
        out.append(keep)
    return out


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two id sequences."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]
