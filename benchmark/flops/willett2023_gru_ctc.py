"""FLOPs and bytes of ``willett2023_gru_ctc``: the GRU-CTC decoder trained
alone (``harness/flopcount.py`` for the counting rules).

A trial is counted at the mean real length of the configuration's
sentences, (min_bins + max_bins) / 2 bins; the padding a batch carries to
its longest sentence is work the port does that no trial asks for, so it
is left out. Counted: the day layer (a dense layer a bin, its input taking
no gradient), each GRU layer's input projection (3H columns a direction)
and recurrence (its gradient back through time either way), the output
layer. The Gaussian smoothing (a fixed 20-tap depthwise kernel, no
gradient) and the CTC's alignment sums are not products and are left out.
"""

from benchmark.harness import flopcount as fc


def _frames(m, n_bins: int) -> int:
    return (n_bins - m["kernel_len"]) // m["stride_len"] + 1


def layers(cfg):
    m, d = cfg["models"]["decoder"], cfg["data"]
    t = (d["min_bins"] + d["max_bins"]) // 2
    frames, c, h = _frames(m, t), m["neural_dim"], m["hidden_dim"]
    dirs = 2 if m.get("bidirectional", True) else 1
    out = [fc.Layer("day", t * c * c, False)]
    for k in range(m["layer_dim"]):
        n_in = c * m["kernel_len"] if k == 0 else dirs * h
        out += [fc.Layer(f"gru{k}.input", dirs * frames * n_in * 3 * h, True),
                fc.Layer(f"gru{k}.recurrent", dirs * frames * h * 3 * h, True)]
    return out + [fc.Layer("fc", frames * dirs * h * (m["n_classes"] + 1), True)]


def train_flops_per_trial(cfg) -> float:
    """One forward and backward of one trial of the mean length."""
    return fc.train_flops(layers(cfg))


def gru_recurrent_products(cfg, batch: int):
    """The recurrent product of one time step of a layer, every direction
    at once (the directions ride the step kernel's seed axis), in a train
    step of ``batch`` rows: the forward's ``h @ W_hh^T`` and the reverse
    loop's ``dgh @ W_hh``, each reading its weights once, its left operand
    and writing its result. Returns {"forward": (FLOPs, bytes), "reverse":
    (FLOPs, bytes)}."""
    m = cfg["models"]["decoder"]
    h, s = m["hidden_dim"], 2 if m.get("bidirectional", True) else 1
    w = s * h * 3 * h * 4
    flops = 2.0 * s * batch * h * 3 * h
    operands = s * batch * (h + 3 * h) * 4
    return {"forward": (flops, w + operands), "reverse": (flops, w + operands)}
