"""Checkpoints on ``torch.save`` / ``torch.load(weights_only=True)``.

Counterpart of ``decode_tonal_langauge_tpu/runtime/checkpoint.py``
(Orbax directories there, one torch file here):

- model checkpoints ``{"params": state_dict[, "scaler": {"mu", "sd"}]}``,
  which the training stage writes and the serving path reads;
- full train states: params, optimizer moments and step, the generators'
  states, the early-stopping tuple, the epochs done and the metric
  history, so that a resumed fit continues an interrupted one exactly.

Every leaf is a tensor, a number, a string or a container of those, which
is what ``weights_only`` loading accepts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn


def save_checkpoint(path: str, module: Union[nn.Module, Mapping[str, torch.Tensor]],
                    scaler=None) -> str:
    """Write ``{"params": state_dict[, "scaler": {"mu", "sd"}]}`` from a
    module or a state dict."""
    state = module.state_dict() if isinstance(module, nn.Module) else module
    tree: Dict[str, Any] = {"params": {k: v.detach().cpu() for k, v in state.items()}}
    if scaler is not None:
        tree["scaler"] = {
            "mu": torch.as_tensor(np.asarray(scaler[0]), dtype=torch.float32),
            "sd": torch.as_tensor(np.asarray(scaler[1]), dtype=torch.float32),
        }
    torch.save(tree, path)
    return path


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[tuple]]:
    """``(state_dict, (mu, sd) or None)`` of a model checkpoint."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    scaler = tree.get("scaler")
    if scaler is not None:
        scaler = (scaler["mu"], scaler["sd"])
    return tree["params"], scaler


def save_train_state(path: str, state: dict) -> str:
    """Save a full training state (tensors moved to the host first)."""
    def host(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu()
        if isinstance(leaf, dict):
            return {k: host(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [host(v) for v in leaf]
        return leaf

    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    torch.save(host(state), path)
    return path


def load_train_state(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def train_state_exists(path: str) -> bool:
    return os.path.isfile(path)
