"""Model factory: classifier names -> modules with signature-filtered
kwargs, and ``build_synthesis_model``.

Counterpart of ``decode_tonal_langauge_tpu/models/factory.py`` and of
``training/train_synthesizer.build_synthesis_model``; the sequence
decoders (``models/sequence.py``, which the JAX package lacks) are built by
``build_sequence_model``. A model is named by
the serving CLI's short name (``CNN``, ``CNNRNN``, ``ShallowNN``,
``logistic``) or by a dotted path: the JAX package's and the reference's
paths resolve to the port's classes (the registry maps the latter onto
the port's modules), and any other path is imported as given. A
``dtype`` kwarg names the compute dtype (``models/base.compute_dtype``);
as every other kwarg, it reaches only classes whose constructor takes it
(``logistic`` and ``ShallowNN`` drop it, as JAX's dataclass-field filter
does).
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, Optional

from torch import nn

from ..registry import _PKG, canonical_module_path
from .base import compute_dtype
from .deep import CNNClassifier, CNNRNNClassifier
from .sequence import GRUDecoder
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
SEQUENCE_MODELS = {"GRUDecoder": GRUDecoder}


def resolve_model_class(name: str) -> type:
    """Short name or dotted path -> a classifier class.

    The port's short names and the reference's and JAX package's paths
    map onto the port's four classifiers; any other dotted path is
    imported as given (the registry's escape hatch for a user's own
    model) and must name a ``torch.nn.Module`` subclass."""
    path = canonical_module_path(CLASSIFIER_SHORT_NAMES.get(name, name))
    module_name, _, cls_name = path.rpartition(".")
    # the port's own paths, and the JAX package's, name the port's classes
    if cls_name in CLASSIFIERS and module_name.split(".")[0] in (
        "", _PKG, "decode_tonal_langauge_tpu"
    ):
        return CLASSIFIERS[cls_name]
    if not module_name:
        raise ValueError(
            f"Unknown classifier '{name}'; the port has "
            f"{sorted(CLASSIFIERS)} (short names {sorted(CLASSIFIER_SHORT_NAMES)}), "
            "or name a torch.nn.Module subclass by its dotted path."
        )
    try:
        cls = getattr(importlib.import_module(module_name), cls_name)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"cannot import classifier '{name}' ({path}): {e}") from e
    if not (isinstance(cls, type) and issubclass(cls, nn.Module)):
        raise TypeError(
            f"classifier '{name}' resolves to {cls!r}, which is not a "
            "torch.nn.Module subclass"
        )
    return cls


def get_classifier_by_name(
    model_path: str,
    n_classes: int,
    n_channels: int,
    seq_length: int,
    classifier_kwargs: Optional[Dict[str, Any]] = None,
) -> nn.Module:
    """Build a classifier with the kwargs its constructor accepts, from
    the superset {n_classes, n_channels, seq_length, input_channels,
    input_length, input_dim} plus ``classifier_kwargs``; a ``dtype`` name
    there becomes a ``torch.dtype`` (an unknown or non-floating one
    raises, whether or not the class takes it)."""
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
    if "dtype" in kwargs:
        kwargs["dtype"] = compute_dtype(kwargs["dtype"])
    allowed = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in allowed})


def build_synthesis_model(
    name: str, output_dim: int, n_channels: int, n_timepoints: int,
    dtype: Any = "float32",
) -> nn.Module:
    """``SynthesisFull`` (SynthesisModelCNN) or ``SynthesisLite``,
    computing in ``dtype`` (a name or a ``torch.dtype``)."""
    dtype = compute_dtype(dtype)
    if name not in SYNTHESIS_MODELS:
        raise ValueError(
            f"Unknown synthesis model '{name}'; expected one of "
            f"{sorted(SYNTHESIS_MODELS)}."
        )
    return SYNTHESIS_MODELS[name](
        output_dim=output_dim, n_channels=n_channels, n_timepoints=n_timepoints,
        dtype=dtype,
    )


def build_sequence_model(name: str, **kwargs: Any) -> nn.Module:
    """A sequence decoder by name (``GRUDecoder``: the GRU-CTC phoneme
    decoder), built with ``kwargs`` (its constructor's)."""
    if name not in SEQUENCE_MODELS:
        raise ValueError(
            f"Unknown sequence model '{name}'; expected one of {sorted(SEQUENCE_MODELS)}."
        )
    return SEQUENCE_MODELS[name](**kwargs)
