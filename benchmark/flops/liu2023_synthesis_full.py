"""FLOPs and bytes of ``liu2023_synthesis_full``: SynthesisFull trained
on frozen label dynamics, and the whole decode stack (CNN syllables,
CNN-RNN tones, SynthesisFull) run forward on a window
(``harness/flopcount.py`` for the counting rules)."""

from benchmark.harness import flopcount as fc


def _synthesis(cfg):
    return fc.synthesis_cnn_layers(cfg["models"]["synthesis"], cfg["dynamics"]["n_dynamics"])


def train_flops_per_trial(cfg) -> float:
    """One forward and backward of SynthesisFull on one trial (the frozen
    classifiers' dynamics are computed once a fit, before its steps)."""
    return fc.train_flops(_synthesis(cfg))


def forward_flops_per_window(cfg) -> float:
    """Both classifiers and SynthesisFull, forward, on one window."""
    m = cfg["models"]
    return fc.forward_flops(fc.cnn_layers(m["syllable"]) + fc.cnnrnn_layers(m["tone"])
                            + _synthesis(cfg))


def lstm_recurrent_products(cfg, seeds: int, batch: int):
    """The label LSTM's recurrent products in one seed-batched step."""
    m = cfg["models"]["synthesis"]
    hid = fc.synthesis_latent_length(m["n_timepoints"]) * m["n_channels"] * m.get("lstm_channels", 6)
    return fc.recurrent_products(hid, cfg["dynamics"]["n_dynamics"], batch, seeds)
