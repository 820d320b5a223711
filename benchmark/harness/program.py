"""The port's objects, built from a configuration and the harness's
seeded weights. The only harness module besides the traffic drivers that
imports the port."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..reference.decode import ARCHS
from . import inputs, weights


def spec(m: Dict):
    """A model's tensors (name, shape, init, fan-in), the port's names."""
    return ARCHS[m["arch"]].param_spec(m)


def build(m: Dict, device: Optional[torch.device] = None) -> torch.nn.Module:
    """The port's module for model entry ``m``; with ``device`` its
    tensors are allocated there, unfilled, and the module's own
    initialisation is skipped."""
    from decode_tonal_langauge_tpu_torch.models.factory import (build_synthesis_model,
                                                                get_classifier_by_name)

    def make():
        if m["arch"] == "SynthesisFull":
            return build_synthesis_model("SynthesisFull", m["output_dim"], m["n_channels"],
                                         m["n_timepoints"], dtype="float32")
        extra = {k: m[k] for k in ("lstm_dim",) if k in m}
        return get_classifier_by_name(m["arch"], m["n_classes"], m["input_channels"],
                                      m["input_length"], extra)

    if device is None:
        return make()
    with torch.device("meta"):
        module = make()
    return module.to_empty(device=device)


def frozen(m: Dict, w: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The port's module with weights ``w`` loaded, in eval mode."""
    module = build(m, device)
    module.load_state_dict(w)
    return module.eval()


def decode_weights(cfg: Dict, seed: int, device, keys=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of a decode stack's models (``keys``, default all),
    drawn from the run's seed. The synthesizer's output bias is a seeded
    mean mel, as a fit starts it from its train mels' mean."""
    out = {}
    for key in keys or cfg["models"]:
        m = cfg["models"][key]
        out[key] = weights.draw(spec(m), inputs.sub_seeds(seed, f"weights/{key}", 1)[0], device)
        if m["arch"] == "SynthesisFull":
            mean = inputs.mels(inputs.rng(seed, "mel_bias"), 96, m["output_dim"]).mean(0)
            out[key]["output_layer.bias"] = torch.as_tensor(mean, device=device)
    return out


def scalers(cfg: Dict, seed: int) -> Dict[str, tuple]:
    """(mu, sd) of each classifier's inputs."""
    out = {}
    for key in ("tone", "syllable"):
        m = cfg["models"][key]
        out[key] = inputs.scaler(inputs.rng(seed, f"scaler/{key}"), m["input_channels"],
                                 m["input_length"])
    return out


def decoder(cfg: Dict, w: Dict, sc: Dict, device):
    """The port's ``TonalDecoder`` over the configuration's three models."""
    from decode_tonal_langauge_tpu_torch.serving import TonalDecoder

    models = {k: frozen(m, w[k], device) for k, m in cfg["models"].items()}
    return TonalDecoder(models["tone"], models["syllable"], mapping(cfg),
                        synthesis_model=models["synthesis"], tone_scaler=sc["tone"],
                        syllable_scaler=sc["syllable"], device=device)


def mapping(cfg: Dict):
    return inputs.tone_mapping(cfg["models"]["tone"]["n_classes"], cfg["dynamics"]["n_dynamics"])


def mel_kwargs(cfg: Dict) -> Dict:
    mel = cfg["mel"]
    return {"n_mels": mel["n_mels"], "n_fft": mel["n_fft"], "hop_length": mel["hop_length"]}


def init_phase(cfg: Dict, seed: int, device) -> torch.Tensor:
    """Griffin-Lim's first phase, uniform on [-pi, pi), drawn from the seed."""
    mel = cfg["mel"]
    r = inputs.rng(seed, "init_phase")
    phase = r.uniform(-np.pi, np.pi, (1 + mel["n_fft"] // 2, mel["n_frames"]))
    return torch.as_tensor(phase, dtype=torch.float32, device=device)
