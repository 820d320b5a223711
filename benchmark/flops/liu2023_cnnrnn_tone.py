"""FLOPs and bytes of ``liu2023_cnnrnn_tone``: the CNN-RNN tone classifier
trained alone (``harness/flopcount.py`` for the counting rules)."""

from benchmark.harness import flopcount as fc


def train_flops_per_trial(cfg) -> float:
    """One forward and backward of one trial."""
    return fc.train_flops(fc.cnnrnn_layers(cfg["models"]["tone"]))


def lstm_recurrent_products(cfg, seeds: int, batch: int):
    """The recurrent products of both LSTMs in one seed-batched step."""
    m = cfg["models"]["tone"]
    t, h = m["input_length"], m.get("lstm_dim", 800)
    t2 = ((t - 6) // 2 - 12) // 3
    return (fc.recurrent_products(h, t, batch, seeds)
            + fc.recurrent_products(512, t2, batch, seeds))
