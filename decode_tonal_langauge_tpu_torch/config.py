"""Configuration helpers: YAML loading, namespace views, hashed names.

Counterpart of the part of ``decode_tonal_langauge_tpu/config.py`` that
the preprocess and classifier-training stages use. ``yaml`` is imported
where a file is read or written. :func:`generate_hash_name_from_config`
hashes exactly as the JAX package does, so both packages name an
experiment's log directory alike.
"""

from __future__ import annotations

import hashlib
import json
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
