#!/usr/bin/env python3
"""Where a float32 gradient of SynthesisFull leaves float64 on the card.

    python3 scripts/f32_gemm_check.py

Prints the torch and CUDA versions and the matmul precision settings;
then, at the output layer's shapes (28,160 -> 2,560 at batch 8), the
relative L2 distance of each float32 product (the forward, the input
gradient and the weight gradient, by ``torch.mm``, ``F.linear`` and
autograd) from float64 on the same inputs, with TF32 off and on (float32
sums of a few thousand terms lie ~1e-6 from float64; TF32's rounded
inputs ~3e-4); then SynthesisFull's first backward at batch 8, float32
against float64 on the card, inside ``exact_f32()`` and outside it: the
gradient reaching the loss's output, the output layer's input, the last
two concat convolutions' outputs, and those layers' parameters. A jump
between two stages with no rounding between them (a leaky ReLU) is a
branch taken otherwise, not a product computed in lower precision.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b).norm() / b.norm()).item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    m = torch.backends.cuda.matmul
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"matmul.allow_tf32 {m.allow_tf32}, float32_matmul_precision "
          f"{torch.get_float32_matmul_precision()}, fp32_precision "
          f"{getattr(m, 'fp32_precision', 'n/a')}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, blas "
          f"{torch.backends.cuda.preferred_blas_library()}")
    print("env: " + ", ".join(f"{k}={v}" for k, v in os.environ.items()
                              if "TF32" in k or "CUBLAS" in k or "PRECISION" in k))
    rng = np.random.default_rng(0)
    b, n_in, n_out = 8, 28160, 2560
    x = torch.from_numpy(rng.standard_normal((b, n_in)).astype(np.float32)).cuda()
    w = torch.from_numpy((rng.standard_normal((n_out, n_in)) / np.sqrt(n_in))
                         .astype(np.float32)).cuda()
    g = torch.from_numpy(np.sign(rng.standard_normal((b, n_out))).astype(np.float32)).cuda()
    g /= b * n_out
    xd, wd, gd = x.double(), w.double(), g.double()
    cases = {
        "forward x @ w.T (K 28160)": (lambda: x @ w.t(), xd @ wd.t()),
        "input grad g @ w (K 2560)": (lambda: g @ w, gd @ wd),
        "weight grad g.T @ x (K 8)": (lambda: g.t() @ x, gd.t() @ xd),
        "F.linear forward": (lambda: F.linear(x, w), xd @ wd.t()),
    }

    def autograd_input_grad():
        xi = x.clone().requires_grad_()
        (F.linear(xi, w) * g).sum().backward()
        return xi.grad

    cases["autograd input grad of F.linear"] = (autograd_input_grad, gd @ wd)
    for tf32 in (False, True):
        m.allow_tf32 = tf32
        for name, (fn, ref) in cases.items():
            print(f"  TF32 {'on ' if tf32 else 'off'} {name}: {rel(fn(), ref):.3g} from float64")
    m.allow_tf32 = False
    xs = x[:, :2560].contiguous()
    ws = w[:, :2560].contiguous()
    print(f"  TF32 off (8, 2560) @ (2560, 2560): "
          f"{rel(xs @ ws.t(), xs.double() @ ws.double().t()):.3g} from float64")
    wt = w.t().contiguous()
    print(f"  TF32 off g @ w with w transposed in memory: {rel(g @ wt.t(), gd @ wd):.3g}")
    from decode_tonal_langauge_tpu_torch.runtime.device import exact_f32

    for name, context in (("exact_f32()", exact_f32), ("no context", contextlib.nullcontext)):
        model_grads(name, context)


def model_grads(name, context, device: str = "cuda", channels: int = 40) -> None:
    """SynthesisFull's first backward at batch 8, float32 against float64
    on ``device`` inside ``context()``: the gradient reaching each stage,
    from the loss back to the concat convolutions."""
    import copy

    from decode_tonal_langauge_tpu_torch.models.base import init_params
    from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisModelCNN

    rng = np.random.default_rng(11)
    n = 8
    batch = [torch.from_numpy(a) for a in (
        rng.standard_normal((n, channels, 200)).astype(np.float32),
        rng.integers(0, 2, (n, 2, 100)).astype(np.float32),
        (rng.standard_normal((n, 2560)) * 10 - 40).astype(np.float32))]
    w = torch.ones(n)
    w[-1] = 0.0
    model = init_params(SynthesisModelCNN(2560, channels, 200, dropout=0.0), seed=4)
    seen = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(device, dtype).train()
        grads = {}

        def keep(key, g):
            grads[key] = g.detach().double()

        def output_hook(mod, grad_in, grad_out):
            keep("d out", grad_out[0])
            keep("d output_layer input", grad_in[0])

        handles = [m.output_layer.register_full_backward_hook(output_hook)]
        for i in (4, 3):
            handles.append(m.concat_convs[i].register_full_backward_hook(
                lambda mod, grad_in, grad_out, i=i: keep(f"d concat_convs.{i} output",
                                                         grad_out[0])))
        b = [t.to(device, dtype) for t in batch]
        wd = w.to(device, dtype)
        with context():
            out = m(b[0], b[1])
            loss = ((out - b[2]).abs().mean(dim=1) * wd).sum() / wd.sum()
            loss.backward()
        for h in handles:
            h.remove()
        for k, p in m.named_parameters():
            if k.startswith(("output_layer", "concat_convs.4", "concat_convs.3")):
                keep(f"grad {k}", p.grad)
        seen[dtype] = grads
    for k in seen[torch.float64]:
        print(f"  SynthesisFull b8 first backward, {name}, {k}: "
              f"{rel(seen[torch.float32][k], seen[torch.float64][k]):.3g} from float64")


if __name__ == "__main__":
    main()
