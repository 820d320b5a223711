"""Configuration helpers: YAML loading and namespace views.

Counterpart of the part of ``decode_tonal_langauge_tpu/config.py`` that
the preprocess stage uses. ``yaml`` is imported where a file is read.
"""

from __future__ import annotations

from argparse import Namespace
from typing import Any, Iterable, Optional


def load_config(path: str) -> dict:
    """Load a YAML configuration file into a plain dict."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


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
