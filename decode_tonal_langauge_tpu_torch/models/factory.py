"""Model factory: classifier names -> modules with signature-filtered
kwargs, and ``build_synthesis_model``.

Counterpart of ``decode_tonal_langauge_tpu/models/factory.py`` and of
``training/train_synthesizer.build_synthesis_model``. A model is named by
the serving CLI's short name (``CNN``, ``CNNRNN``, ``ShallowNN``,
``logistic``) or by a dotted path whose last part is the class name (the
JAX package's and the reference's paths both resolve; the registry maps
the latter onto the port's modules).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from torch import nn

from ..registry import canonical_module_path
from .deep import CNNClassifier, CNNRNNClassifier
from .simple import LogisticRegressionClassifier, ShallowNNClassifier
from .synthesis import SynthesisLite, SynthesisModelCNN

CLASSIFIERS = {
    cls.__name__: cls
    for cls in (CNNClassifier, CNNRNNClassifier, ShallowNNClassifier,
                LogisticRegressionClassifier)
}
CLASSIFIER_SHORT_NAMES = {
    "CNN": "CNNClassifier",
    "CNNRNN": "CNNRNNClassifier",
    "ShallowNN": "ShallowNNClassifier",
    "logistic": "LogisticRegressionClassifier",
}
SYNTHESIS_MODELS = {"SynthesisFull": SynthesisModelCNN,
                    "SynthesisLite": SynthesisLite}


def resolve_model_class(name: str) -> type:
    """Short name or dotted path -> the port's classifier class."""
    path = canonical_module_path(CLASSIFIER_SHORT_NAMES.get(name, name))
    cls_name = path.rsplit(".", 1)[-1]
    if cls_name not in CLASSIFIERS:
        raise ValueError(
            f"Unknown classifier '{name}'; the port has "
            f"{sorted(CLASSIFIERS)} (short names {sorted(CLASSIFIER_SHORT_NAMES)})."
        )
    return CLASSIFIERS[cls_name]


def _check_dtype(kwargs: Dict[str, Any]) -> None:
    dtype = kwargs.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise ValueError(
            f"compute dtype {dtype!r}: the port computes in float32 only"
        )


def get_classifier_by_name(
    model_path: str,
    n_classes: int,
    n_channels: int,
    seq_length: int,
    classifier_kwargs: Optional[Dict[str, Any]] = None,
) -> nn.Module:
    """Build a classifier with the kwargs its constructor accepts, from
    the superset {n_classes, n_channels, seq_length, input_channels,
    input_length, input_dim} plus ``classifier_kwargs``."""
    cls = resolve_model_class(model_path)
    kwargs: Dict[str, Any] = {
        "n_classes": n_classes,
        "n_channels": n_channels,
        "seq_length": seq_length,
        "input_channels": n_channels,
        "input_length": seq_length,
        "input_dim": n_channels * seq_length,
        **(classifier_kwargs or {}),
    }
    _check_dtype(kwargs)
    allowed = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in allowed})


def build_synthesis_model(
    name: str, output_dim: int, n_channels: int, n_timepoints: int,
    dtype: str = "float32",
) -> nn.Module:
    """``SynthesisFull`` (SynthesisModelCNN) or ``SynthesisLite``; a
    compute ``dtype`` other than float32 raises."""
    _check_dtype({"dtype": dtype})
    if name not in SYNTHESIS_MODELS:
        raise ValueError(
            f"Unknown synthesis model '{name}'; expected one of "
            f"{sorted(SYNTHESIS_MODELS)}."
        )
    return SYNTHESIS_MODELS[name](
        output_dim=output_dim, n_channels=n_channels, n_timepoints=n_timepoints
    )
