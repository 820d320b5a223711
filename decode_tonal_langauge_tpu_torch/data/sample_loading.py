"""Sample loading for classifier training.

A copy of ``decode_tonal_langauge_tpu/data/sample_loading.py`` (plain
numpy): loads the sample npz, combines multi-target labels with a
mixed-radix code (first-target-minor: ``labels += label_i *
prod(n_classes[:i])``), filters channels as the union of
``<target>_discriminative`` selections from a channel JSON, and prepares
Cartesian-product class-label strings. Arrays stay numpy; device
placement happens in the trainer.
"""

from __future__ import annotations

import json
from argparse import Namespace
from itertools import product
from typing import Dict, List, Optional

import numpy as np


class ClassificationSampleHandler:
    """Loads and prepares (features, labels, channels) from a sample npz."""

    def __init__(self, params: Namespace):
        self.sample_path = params.sample_path
        self.channel_file = getattr(params, "channel_file", None)
        self.dataset = np.load(self.sample_path)
        self.channels: Optional[np.ndarray] = None
        self.targets = getattr(params, "targets", None)
        if isinstance(self.targets, str):
            self.targets = [self.targets]
        self.params = params

    def load_data(self) -> dict:
        """Returns features (N, C', T), combined labels (N,), the selected
        channels, and per-target class counts."""
        feature_key = getattr(self.params, "features", "ecog")
        if feature_key not in self.dataset:
            raise KeyError(
                f"Feature array '{feature_key}' missing from {self.sample_path}; "
                f"Available keys: {', '.join(self.dataset.keys())}"
            )
        features = self.dataset[feature_key]

        # expected_n_classes ({target: count}) pins the label space to a
        # TRAINING run's counts: evaluating/serving a data subset that
        # happens to miss a class entirely must still encode the
        # mixed-radix label with the radix the checkpoint was trained
        # with (the evaluation stage reads the counts training recorded).
        expected = getattr(self.params, "expected_n_classes", None) or {}

        target_labels = []
        n_classes_dict: Dict[str, int] = {}
        for target in self.targets:
            if target not in self.dataset:
                raise KeyError(
                    f"Label array '{target}' missing from the sample file; "
                    f"Available keys: {', '.join(self.dataset.keys())}"
                )
            digit = self.dataset[target].flatten()
            target_labels.append(digit)
            if target in expected:
                count = int(expected[target])
                # Only the pinned (evaluation/serving) path validates:
                # the training path derives its counts from this very
                # data, so there is no run to mismatch.
                if digit.size and int(digit.max()) >= count:
                    raise ValueError(
                        f"Label '{target}' holds value {int(digit.max())} "
                        f"but the training run's class count is {count} — "
                        "the sample file does not match the training "
                        "run's label space."
                    )
            else:
                count = len(np.unique(self.dataset[target]))
            n_classes_dict[target] = count

        # mixed-radix combine: each target contributes one digit whose
        # radix is that target's class count
        labels = np.zeros_like(target_labels[0], dtype=int)
        radix = 1
        for target, digit in zip(self.targets, target_labels):
            labels += digit * radix
            radix *= n_classes_dict[target]

        self.channels = self._filter_channels(features.shape[1])
        features = features[:, self.channels, :]

        return {
            "features": features,
            "labels": labels,
            "selected_channels": self.channels,
            "n_classes_dict": n_classes_dict,
        }

    def _filter_channels(self, n_channels: int) -> np.ndarray:
        if self.channel_file is None:
            return np.arange(n_channels)

        with open(self.channel_file, "r") as f:
            channel_selections = json.load(f)

        channels: set = set()
        for target in self.targets:
            key = f"{target}_discriminative"
            if key not in channel_selections:
                raise KeyError(
                    f"Channel selection for '{key}' not found in the file "
                    f"{self.channel_file}. "
                    f"Available keys: {', '.join(channel_selections.keys())}"
                )
            channels.update(channel_selections[key])

        if not channels:
            raise ValueError(
                f"Empty channel union for targets {', '.join(self.targets)} -- "
                f"Please check the channel file {self.channel_file}"
            )

        return np.array(sorted(channels))

    def prepare_class_labels(
        self, n_classes_dict: Optional[Dict[str, int]] = None
    ) -> List[str]:
        """Class-label strings; Cartesian product across multiple targets."""
        class_labels_dict = getattr(self.params, "class_labels", {}) or {}

        if len(self.targets) > 1:
            per_target = []
            for target in self.targets:
                given = class_labels_dict.get(target)
                if given is None:
                    if n_classes_dict is None or target not in n_classes_dict:
                        raise ValueError(
                            f"Missing class count for target '{target}' in class_labels."
                        )
                    per_target.append(
                        [str(i) for i in range(1, n_classes_dict[target] + 1)]
                    )
                else:
                    per_target.append(list(given))
            return ["_".join(combo) for combo in product(*per_target)]

        target = self.targets[0]
        given = class_labels_dict.get(target)
        if given is None:
            if n_classes_dict is None or target not in n_classes_dict:
                raise ValueError(
                    f"Missing class count for target '{target}' in class_labels."
                )
            return [str(i) for i in range(1, n_classes_dict[target] + 1)]
        return list(given)
