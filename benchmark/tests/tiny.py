"""Small sizes of the benchmark's configurations and mixes, for the CPU
tests: the same architectures and traffic, cut in length, channels,
trials, seeds and mel size so that a run takes seconds on one CPU."""

import copy

from benchmark.harness import cells


def config(name: str):
    cfg = copy.deepcopy(cells.config(name))
    models = cfg["models"]
    if "synthesis" in models:
        cfg["channels"] = {"tone": 2, "syllable": 2, "non_discriminative": 3}
        for key in ("tone", "syllable"):
            models[key].update(input_channels=2, input_length=128)
        models["tone"]["lstm_dim"] = 128
        models["synthesis"].update(n_channels=3, n_timepoints=128, output_dim=16)
        cfg["dynamics"]["n_dynamics"] = 10
        cfg["mel"] = {"n_mels": 4, "n_frames": 4, "n_fft": 64, "hop_length": 16,
                      "sample_rate_hz": 800, "griffinlim_iterations": 32}
        cfg["fit"]["trials"] = 12
    else:
        models["tone"].update(input_channels=2, input_length=40, lstm_dim=80)
        cfg["fit"]["trials"] = 40
        cfg["data"]["planted_channels"] = 2
    return cfg


def mix(name: str):
    m = copy.deepcopy(cells.mix(name))
    if m["driver"] == "fit_steps":
        m.update(seeds=2, batch=4, trace_steps=2)
    elif m["driver"] == "stream_realtime":
        m.update(window=128, hop=32, trace_windows=3)
    else:
        m.update(recording_s=2, window=128, hop=32, trace_passes=1)
    return m


# At these sizes a fit's float32 gaps read otherwise than at the cells'
# (on the CPU: the CNN-RNN's first-gradient gap 1.4e-4 to 1.7e-4 over
# four seeds, against a median of 1.5e-5 at its published widths on the card), so
# the fits are held to limits read here: above four seeds of the port and
# below the TF32 control (first loss 8.3e-7 and 9.3e-6, first gradient
# 1.1e-3 and 8.5e-3). The decode cells keep their own limits.
FIT_LIMITS = {"loss_gap_first": 3e-7, "loss_gap_later": 1e-3, "grad_norm_gap": 5e-4,
              "change_norm_gap": 1e-2}


def limits(cell_name: str):
    own = cells.limits(cell_name)
    return dict(FIT_LIMITS) if set(own) == set(FIT_LIMITS) else own
