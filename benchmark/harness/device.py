"""The device a run measures, and the guards around it."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "decode_tonal_langauge_tpu")


def set_cache_dirs(checkout: Path) -> None:
    """Every build and kernel cache the program could fill, at fixed
    folders inside the checkout, so that only a checkout's first run
    builds. Set before torch is imported."""
    cache = checkout / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the latter)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card(index: int = 0) -> Dict:
    """The card's name (torch's), and its power limit where nvidia-smi
    reads one."""
    import torch

    info = {"kind": torch.cuda.get_device_name(index)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={index}"], capture_output=True, text=True, timeout=20, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info
