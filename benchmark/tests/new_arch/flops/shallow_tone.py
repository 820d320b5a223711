"""FLOPs of ``shallow_tone``: its own layer list on ``harness/flopcount.py``'s rules."""

from benchmark.harness import flopcount as fc


def train_flops_per_trial(cfg) -> float:
    m = cfg["models"]["clf"]
    return fc.train_flops([
        fc.dense("hidden", m["hidden_dim"], m["input_channels"] * m["input_length"],
                 input_grad=False),
        fc.dense("output", m["n_classes"], m["hidden_dim"])])
