"""The port's objects, built from a configuration and the harness's
seeded weights. The only harness module besides the traffic drivers that
imports the port.

A model entry says how the port builds it, under ``"port"``: ``factory``,
the dotted path of a function or class of the port; ``args``, the entry's
keys whose values it takes in order; ``kwargs``, keyword arguments whose
value is an entry key, or an object of names to entry keys (passed as a
dict); ``const``, keyword arguments given as they stand. So a new
architecture of the port is a model entry, and no file here names it."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch

from ..reference import module_of
from . import inputs, weights

PORT = "decode_tonal_langauge_tpu_torch"


def spec(m: Dict):
    """A model's tensors (name, shape, init, fan-in), the port's names."""
    return module_of(m).param_spec(m)


def _factory(path: str):
    module, _, name = path.rpartition(".")
    if module.split(".")[0] != PORT:
        raise ValueError(f"a model entry's port factory {path!r} is not in {PORT}")
    return getattr(importlib.import_module(module), name)


def build(m: Dict, device: Optional[torch.device] = None) -> torch.nn.Module:
    """The port's module for model entry ``m``; with ``device`` its
    tensors are allocated there, unfilled, and the module's own
    initialisation is skipped."""
    port = m["port"]
    factory = _factory(port["factory"])
    args = [m[k] for k in port.get("args", ())]
    kwargs = {name: ({k: m[v] for k, v in key.items()} if isinstance(key, dict) else m[key])
              for name, key in port.get("kwargs", {}).items()}
    kwargs.update(port.get("const", {}))

    if device is None:
        return factory(*args, **kwargs)
    with torch.device("meta"):
        module = factory(*args, **kwargs)
    return module.to_empty(device=device)


def frozen(m: Dict, w: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The port's module with weights ``w`` loaded, in eval mode."""
    module = build(m, device)
    module.load_state_dict(w)
    return module.eval()


def decode_weights(cfg: Dict, seed: int, device, keys=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of a decode stack's models (``keys``, default all),
    drawn from the run's seed. A synthesizer's output bias (its reference
    module's ``MEAN_MEL_BIAS``) is a seeded mean mel, as a fit starts it
    from its train mels' mean."""
    out = {}
    for key in keys or cfg["models"]:
        m = cfg["models"][key]
        out[key] = weights.draw(spec(m), inputs.sub_seeds(seed, f"weights/{key}", 1)[0], device)
        bias = getattr(module_of(m), "MEAN_MEL_BIAS", None)
        if bias is not None:
            mean = inputs.mels(inputs.rng(seed, "mel_bias"), 96, m["output_dim"]).mean(0)
            out[key][bias] = torch.as_tensor(mean, device=device)
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
