"""Configuration helpers: YAML loading, namespace views, hashed names.

Counterpart of ``decode_tonal_langauge_tpu/config.py``, with the
provenance chaining of ``config.yaml`` and the one flattening of a
training run's provenance that training, evaluation and serving share. ``yaml`` is imported
where a file is read or written. :func:`generate_hash_name_from_config`
hashes exactly as the JAX package does, so both packages name an
experiment's log directory alike.
"""

from __future__ import annotations

import hashlib
import json
import os
from argparse import Namespace
from typing import Any, Dict, Iterable, Optional


def load_config(path: str) -> dict:
    """Load a YAML configuration file into a plain dict."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def save_config(path: str, config: dict) -> None:
    """Write a config dict as YAML."""
    import yaml

    with open(path, "w") as f:
        yaml.dump(config, f)


def dict_to_namespace(d: Any, exclude_keys: Optional[Iterable[str]] = None) -> Any:
    """Recursively convert a dict into an ``argparse.Namespace``; keys in
    ``exclude_keys`` keep their raw dict/list values."""
    exclude_keys = set(exclude_keys or ())
    if isinstance(d, dict):
        return Namespace(
            **{
                k: (dict_to_namespace(v, exclude_keys) if k not in exclude_keys else v)
                for k, v in d.items()
            }
        )
    if isinstance(d, list):
        return [dict_to_namespace(v, exclude_keys) for v in d]
    return d


def namespace_to_dict(ns: Any) -> Any:
    """Inverse of :func:`dict_to_namespace` (for provenance dumps)."""
    if isinstance(ns, Namespace):
        return {k: namespace_to_dict(v) for k, v in vars(ns).items()}
    if isinstance(ns, (list, tuple)):
        return [namespace_to_dict(v) for v in ns]
    return ns


def append_data_json(output_file: str, output_data: dict) -> None:
    """Merge ``output_data`` into the JSON object in ``output_file``
    (a missing or unreadable file counts as empty) and write it back."""
    existing = {}
    if os.path.exists(output_file):
        with open(output_file, "r") as f:
            try:
                existing = json.load(f)
            except json.JSONDecodeError:
                pass
    existing.update(output_data)
    with open(output_file, "w") as f:
        json.dump(existing, f, indent=4)


def update_configuration(
    output_path: str,
    previous_config_path: str,
    new_module: str,
    new_module_cfg: dict,
) -> None:
    """Provenance chaining: the upstream stage's ``config.yaml`` (empty
    when absent) with this stage's section set, written to
    ``output_path``."""
    previous_cfg = {}
    if os.path.exists(previous_config_path):
        previous_cfg = load_config(previous_config_path) or {}
    previous_cfg[new_module] = new_module_cfg
    save_config(output_path, previous_cfg)


def _stable_json(config: Any) -> str:
    """Deterministically serialize a config for hashing."""
    return json.dumps(config, sort_keys=True, default=str)


def generate_hash_name_from_config(base_name: str, config: dict) -> str:
    """``<base>__<md5[:6]>`` content-hashed run name: identical configs
    map to identical directories."""
    hash_part = hashlib.md5(_stable_json(config).encode()).hexdigest()[:6]
    return f"{base_name}__{hash_part}"


def flatten_sections(cfg: Dict[str, Any], sections: Iterable[str]) -> Dict[str, Any]:
    """Merge the listed sub-sections of ``cfg`` into one flat dict (the
    training stage flattens ``io``/``experiment``/``training``)."""
    flat: Dict[str, Any] = {}
    for section in sections:
        flat.update(cfg.get(section, {}) or {})
    return flat


# Keys whose values stay raw dicts/lists when a training config (or its
# provenance) is namespaced: free-form mappings consumed as dicts.
PROVENANCE_EXCLUDE_KEYS = ("class_labels", "model_kwargs", "per_target")


def flatten_training_provenance(provenance: Dict[str, Any]) -> Dict[str, Any]:
    """A training config (or a training run's provenance ``config.yaml``)
    flattened to the training stage's params dict: the io/experiment/
    training sections, then dataset and model.

    Training, evaluation and ``serving --training_dir`` all flatten
    through this one function, so checkpoint names and split
    reproduction cannot drift from what was trained."""
    flat = flatten_sections(
        (provenance.get("training", {}) or {}).get("params", {}) or {},
        ("io", "experiment", "training"),
    )
    flat.update(provenance.get("dataset", {}) or {})
    flat.update(provenance.get("model", {}) or {})
    return flat


def namespace_training_params(flat: Dict[str, Any]) -> Namespace:
    """``dict_to_namespace`` with :data:`PROVENANCE_EXCLUDE_KEYS` kept raw
    and ``model_name`` defaulting to the class name of the model path."""
    params = dict_to_namespace(flat, exclude_keys=PROVENANCE_EXCLUDE_KEYS)
    if getattr(params, "model_name", None) is None and "model" in flat:
        params.model_name = flat["model"].split(".")[-1]
    return params
