"""FLOPs and bytes from a configuration's shapes, by the layers'
equations (never by profiling the port, so that no change to the port
can move them).

A multiply-add is 2 FLOPs; only products are counted (convolutions,
dense layers, LSTM projections), not the elementwise work around them.
A layer's training cost is its forward, its weight gradient (as much
again) and, where its input needs a gradient, its input gradient (as
much again). An LSTM's recurrence always takes its gradient back
through time; the gradient of its input projection is taken only where
its input needs one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List


@dataclass
class Layer:
    name: str
    macs: float  # forward multiply-adds per trial
    input_grad: bool  # whether training takes the gradient of its input


def conv(name: str, n_out: int, n_in: int, k: int, t_in: int, width: int,
         input_grad: bool = True) -> Layer:
    return Layer(name, n_out * n_in * k * (t_in - k + 1) * width, input_grad)


def dense(name: str, n_out: int, n_in: int, input_grad: bool = True) -> Layer:
    return Layer(name, n_out * n_in, input_grad)


def lstm(name: str, n_in: int, hid: int, t: int, input_grad: bool) -> List[Layer]:
    """The input projection and the recurrence as two layers; the
    recurrence's gradient runs back through time either way."""
    return [Layer(f"{name}.input", t * n_in * 4 * hid, input_grad),
            Layer(f"{name}.recurrent", t * hid * 4 * hid, True)]


def forward_flops(layers: Iterable[Layer]) -> float:
    return sum(2.0 * l.macs for l in layers)


def train_flops(layers: Iterable[Layer]) -> float:
    return sum(2.0 * l.macs * (3 if l.input_grad else 2) for l in layers)


def recurrent_products(hid: int, steps: int, rows: int, seeds: int, itemsize: int = 4):
    """The recurrent products of one LSTM in a seed-batched train step:
    the forward's ``h @ wh`` and the reverse loop's ``da @ wh^T``, one a
    time step each, ``rows`` rows a seed. Each reads its weight once,
    reads its left operand and writes its result. Returns (label, the
    operand shapes as the profiler reports them, count, FLOPs, bytes) of
    each kind."""
    w = seeds * hid * 4 * hid * itemsize
    flops = 2.0 * seeds * rows * hid * 4 * hid
    fwd = w + seeds * rows * (hid + 4 * hid) * itemsize
    rev = w + seeds * rows * (4 * hid + hid) * itemsize
    return [("forward", [[seeds, rows, hid], [seeds, hid, 4 * hid]], steps, flops, fwd),
            ("reverse", [[seeds, rows, 4 * hid], [seeds, 4 * hid, hid]], steps, flops, rev)]


# The paper's three architectures, layer by layer, for one trial.

def cnn_layers(m) -> List[Layer]:
    t, c = m["input_length"], m["input_channels"]
    widths = (512, 512, 512, 512, 512, 256)
    layers = [Layer("convs.0", widths[0] * 3 * (t - 2) * c, False)]
    t = (t - 2) // 2
    for i in range(1, len(widths)):
        layers.append(conv(f"convs.{i}", widths[i], widths[i - 1], 3, t, c))
        t -= 2
        if i != 4:
            t //= 2
    return layers + [dense("fc1", 1024, t * c * widths[-1]),
                     dense("fc2", m["n_classes"], 1024)]


def cnnrnn_layers(m) -> List[Layer]:
    t, c, h = m["input_length"], m["input_channels"], m.get("lstm_dim", 800)
    u, w = (t - 6) // 2, h // t + c
    t2 = (u - 12) // 3
    return (lstm("lstm1", c, h, t, input_grad=False)
            + [Layer("conv1", 1024 * 7 * (t - 6) * c, False),
               Layer("conv2", 1024 * 7 * (t - 6) * (h // t), True),
               conv("conv3a", 512, 1024, 7, u, w), conv("conv3b", 256, 512, 7, u - 6, w)]
            + lstm("lstm2", w * 256, 512, t2, input_grad=True)
            + [dense("head", m["n_classes"], 512)])


_SYNTHESIS_ECOG = ((3, True), (3, True), (1, True), (1, False))  # after the stencil


def synthesis_latent_length(t: int) -> int:
    t = (t - 2) // 2
    for k, pool in _SYNTHESIS_ECOG:
        t = t - k + 1
        if pool:
            t //= 2
    return t


def synthesis_cnn_layers(m, n_dynamics: int) -> List[Layer]:
    t, c = m["n_timepoints"], m["n_channels"]
    cc, lc = m.get("conv_channels", 64), m.get("lstm_channels", 6)
    layers = [Layer("ecog_convs.0", 512 * 3 * (t - 2) * c, False)]
    t = (t - 2) // 2
    for i, (n_out, n_in, k, pool) in enumerate(
            ((512, 512, 3, True), (512, 512, 3, True), (256, 512, 1, True), (cc, 256, 1, False)),
            start=1):
        layers.append(conv(f"ecog_convs.{i}", n_out, n_in, k, t, c))
        t = t - k + 1
        if pool:
            t //= 2
    layers += lstm("label_lstm", 2, t * c * lc, n_dynamics, input_grad=False)
    widths = (cc + lc, 128, 128, 128, 128, cc)
    layers += [conv(f"concat_convs.{i}", widths[i + 1], widths[i], 1, t, c) for i in range(5)]
    return layers + [dense("output_layer", m["output_dim"], t * c * cc)]
