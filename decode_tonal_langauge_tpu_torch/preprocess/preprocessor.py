"""Preprocessor core: per-modality sequential step application.

Counterpart of ``decode_tonal_langauge_tpu/preprocess/preprocessor.py``:
- per modality, clone the base params and inject ``signal_freq`` from
  ``<modality>_sf``;
- move the block to the device once and apply each configured step's
  ``run(data, params)`` in order, eagerly; every step follows the data;
- reject parameter-name collisions between steps;
- optionally write before/after figures per step.
"""

from __future__ import annotations

import os
from argparse import Namespace
from copy import deepcopy
from typing import Optional

import numpy as np
import torch

from .. import registry
from ..runtime.device import DeviceLike, resolve_device


def preprocess_modalities(
    data_dict: dict,
    modalities_cfg: dict,
    base_params: Namespace,
    figure_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> dict:
    """Preprocess each modality according to its type and configured
    steps, in place in ``data_dict``. ``device=None`` means the card."""
    for modality, cfg in modalities_cfg.items():
        mod_type = cfg.get("type")
        if mod_type is None:
            raise KeyError(f"Modality '{modality}' missing 'type' field in config")

        steps = cfg.get("preprocessing", {}).get("steps", [])
        if not steps:
            continue

        mod_fig_dir = os.path.join(figure_dir, modality) if figure_dir else None
        if mod_fig_dir:
            os.makedirs(mod_fig_dir, exist_ok=True)

        params = deepcopy(base_params)

        if mod_type == "signal":
            params.signal_freq = data_dict.get(f"{modality}_sf")
            processed, freq = preprocess_signal(
                data_dict[modality], steps, params, figure_dir=mod_fig_dir,
                device=device,
            )
            if freq is not None:
                data_dict[f"{modality}_sf"] = freq
            data_dict[modality] = processed
        else:
            raise ValueError(
                f"Unsupported modality type '{mod_type}' for '{modality}'."
            )

    return data_dict


def _host(data: torch.Tensor) -> np.ndarray:
    return data.detach().cpu().numpy()


def preprocess_signal(
    data,
    steps: list,
    block_params: Namespace,
    figure_dir: Optional[str] = None,
    num_channels: int = 5,
    duration: float = 1.0,
    device: DeviceLike = None,
):
    """Apply the steps in order; returns (tensor on the device, final
    freq). ``data`` (array or tensor) is moved to ``device`` once
    (``None`` means the card; it raises without one)."""
    _apply_step_params(steps, block_params)
    data = torch.as_tensor(data).to(resolve_device(device))

    for i, step in enumerate(steps):
        module_name = step["module"]
        # The pre-step signal costs a copy to the host: only for figures.
        before_data = _host(data) if figure_dir else None
        before_freq = block_params.signal_freq

        module = registry.resolve(module_name)
        data = module.run(data, block_params)

        if figure_dir and data.ndim == 2:
            from ..utils.visualise import plot_preprocessing_step

            plot_preprocessing_step(
                before_data,
                before_freq,
                _host(data),
                block_params.signal_freq,
                figure_dir,
                i,
                module_name,
                num_channels=num_channels,
                duration=duration,
            )

    return data, block_params.signal_freq


def _apply_step_params(steps: list, block_params: Namespace) -> None:
    """Install each step's params on the shared namespace, rejecting
    collisions."""
    for step in steps:
        for key, value in (step.get("params", {}) or {}).items():
            if hasattr(block_params, key):
                raise ValueError(
                    f"Parameter '{key}' already exists in params. "
                    "Please ensure no conflicting parameter names "
                    "in each preprocessing step."
                )
            setattr(block_params, key, value)
