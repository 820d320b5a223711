"""String-addressed plugin resolution.

Counterpart of ``decode_tonal_langauge_tpu/registry.py``: config module
names (the reference repo's dotted paths, or short names) map onto the
port's modules, and any other dotted path is imported as given. It holds
the JAX registry's names: every pipeline stage, preprocess plugin and
step, channel-selection method and model class.
"""

from __future__ import annotations

import importlib
from typing import Dict

_PKG = "decode_tonal_langauge_tpu_torch"
_STEPS = (
    "downsample",
    "frequency_filter",
    "car_rereference",
    "zscore_rereference",
    "channel_zscore",
    "rolling_zscore",
)

# Reference dotted path -> the port's module path.
_ALIASES: Dict[str, str] = {
    "preprocess_main": f"{_PKG}.preprocess.main",
    "preprocess.pipelines.subject_block": f"{_PKG}.preprocess.pipelines.subject_block",
    "preprocess.io.tdt_blocks": f"{_PKG}.preprocess.io.tdt_blocks",
    "preprocess.io.npz_blocks": f"{_PKG}.preprocess.io.npz_blocks",
    "preprocess.preprocessor": f"{_PKG}.preprocess.preprocessor",
    # signal steps, in the example config's short form "preprocess.<op>"
    # and the reference's path "preprocess.signal.<op>"
    **{f"preprocess.{s}": f"{_PKG}.preprocess.signal.{s}" for s in _STEPS},
    **{f"preprocess.signal.{s}": f"{_PKG}.preprocess.signal.{s}" for s in _STEPS},
    "extract_samples": f"{_PKG}.data.extract_samples",
    "channel_selection_main": f"{_PKG}.channel_selection.main",
    "train_classifier": f"{_PKG}.training.train_classifier",
    "evaluation_main": f"{_PKG}.evaluation.main",
    "visualisation_main": f"{_PKG}.visualisation.main",
    "channel_selection.active": f"{_PKG}.channel_selection.active",
    "channel_selection.discriminative": f"{_PKG}.channel_selection.discriminative",
    # model classes, as the `model:` config section names them
    "models.simple_classifiers.LogisticRegressionClassifier": f"{_PKG}.models.simple.LogisticRegressionClassifier",
    "models.simple_classifiers.ShallowNNClassifier": f"{_PKG}.models.simple.ShallowNNClassifier",
    "models.deep_classifiers.CNNClassifier": f"{_PKG}.models.deep.CNNClassifier",
    "models.deep_classifiers.CNNRNNClassifier": f"{_PKG}.models.deep.CNNRNNClassifier",
    "models.synthesis_models.SynthesisModelCNN": f"{_PKG}.models.synthesis.SynthesisModelCNN",
    "models.synthesis_models.SynthesisLite": f"{_PKG}.models.synthesis.SynthesisLite",
}

# Short names for new-style configs.
_SHORT_NAMES: Dict[str, str] = {
    **{s: f"{_PKG}.preprocess.signal.{s}" for s in _STEPS},
    "active": f"{_PKG}.channel_selection.active",
    "discriminative": f"{_PKG}.channel_selection.discriminative",
}


def canonical_module_path(name: str) -> str:
    """Map a config-supplied module name to the module path to import."""
    if name in _ALIASES:
        return _ALIASES[name]
    return _SHORT_NAMES.get(name, name)


def resolve(name: str):
    """Import and return the plugin module for a config-supplied name."""
    return importlib.import_module(canonical_module_path(name))


def register_alias(name: str, target: str) -> None:
    """Register an extra plugin alias at runtime (user extension hook)."""
    _ALIASES[name] = target
