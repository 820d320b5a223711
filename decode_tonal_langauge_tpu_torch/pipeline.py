"""YAML pipeline runner, the framework's top-level API.

Counterpart of ``decode_tonal_langauge_tpu/pipeline.py``: run the stages
of ``STAGES`` in order, resolve each stage's ``module`` (function ``run``
unless ``function`` says otherwise) through the registry, and thread
string results (output directories) into downstream stages' ``params.io``
sections. The device is resolved once (``None``: the card; it raises
without one) and passed to every stage function that takes ``device``; a
user module's function is called with the config alone.

Under a launcher (``torchrun --nproc_per_node N -m
decode_tonal_langauge_tpu_torch config.yaml``) the process group is
joined first, before anything touches the card
(``parallel.distributed.initialize``), and every rank waits for the others
after each stage, since a stage reads the files the previous one wrote.
The stages split their subjects or blocks between the ranks, and the
``parallel:`` section makes the training stage data-parallel
(``parallel/mesh.py``).

A top-level ``profiling`` section: ``trace_dir`` runs every stage inside
a ``torch.profiler`` trace (a Chrome trace file per stage, holding the
port's layer spans), ``timing: true`` (the default) prints each stage's
wall time at the end, then the five layer spans with the most self time
(``runtime/profiling.py``). The
``compilation_cache`` section is accepted with a note: the port compiles
nothing.

    python -m decode_tonal_langauge_tpu_torch.pipeline <config.yaml> [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect
from typing import Any, Dict

from . import registry
from .config import load_config
from .parallel.distributed import barrier, initialize, process_count, process_index
from .runtime.device import DeviceLike, resolve_device
from .runtime.profiling import StageTimer, trace

STAGES = [
    "preprocess",
    "sample_collection",
    "channel_selection",
    "training",
    "evaluation",
    "visualisation",
]


def run_pipeline(config_path_or_dict, device: DeviceLike = None) -> Dict[str, str]:
    """Execute the pipeline stages of a config file or dict; returns the
    map of stage -> output directory."""
    if initialize(device=device):
        print(f"multi-process runtime: process {process_index()} of {process_count()}")
    device = resolve_device(device)
    if isinstance(config_path_or_dict, str):
        config: Dict[str, Any] = load_config(config_path_or_dict)
    else:
        config = config_path_or_dict
    stage_outputs: Dict[str, str] = {}

    if config.get("compilation_cache") not in (None, False):
        print("compilation_cache: accepted, but the port compiles nothing; ignoring")

    profiling_cfg = config.get("profiling") or {}
    trace_dir = profiling_cfg.get("trace_dir")
    timer = StageTimer()

    for stage in STAGES:
        stage_cfg = config.get(stage)
        if not stage_cfg:
            continue

        module_name = stage_cfg.get("module")
        func_name = stage_cfg.get("function", "run")
        if module_name is None:
            continue

        print(f"----------- Running stage: {stage} -----------")

        update_stage_cfg_io(stage_outputs, stage, stage_cfg)
        config[stage] = stage_cfg

        module = registry.resolve(module_name)
        try:
            func = getattr(module, func_name)
        except AttributeError:
            raise ImportError(
                f"Module '{module_name}' does not have a function '{func_name}'"
                f"Available functions: {', '.join(dir(module))}"
            )
        kwargs = {}
        if "device" in inspect.signature(func).parameters:
            kwargs["device"] = device

        with timer.span(stage), trace(trace_dir, name=stage):
            result = func(config, **kwargs)
        if isinstance(result, str):
            stage_outputs[stage] = result
        barrier(f"stage:{stage}")

    if timer.spans and profiling_cfg.get("timing", True):
        print("----------- Stage timing -----------")
        print(timer.summary())
        layers = timer.layers(5)
        if layers:
            print("----------- Layer spans, most self time -----------")
            print(layers)

    return stage_outputs


def update_stage_cfg_io(stage_outputs: dict, stage: str, stage_cfg: dict) -> None:
    """Thread upstream output dirs into this stage's io params."""
    if stage == "sample_collection":
        params_io = stage_cfg.setdefault("params", {}).setdefault("io", {})
        if "recording_dir" not in params_io and "preprocess" in stage_outputs:
            params_io["recording_dir"] = stage_outputs["preprocess"]
    elif stage == "channel_selection":
        io_cfg = stage_cfg.setdefault("params", {}).setdefault("io", {})
        if "sample_dir" not in io_cfg and "sample_collection" in stage_outputs:
            io_cfg["sample_dir"] = stage_outputs["sample_collection"]
    elif stage == "training":
        params_io = stage_cfg.setdefault("params", {}).setdefault("io", {})
        if "sample_dir" not in params_io and "sample_collection" in stage_outputs:
            params_io["sample_dir"] = stage_outputs["sample_collection"]
        if (
            "channel_selection_dir" not in params_io
            and "channel_selection" in stage_outputs
        ):
            params_io["channel_selection_dir"] = stage_outputs["channel_selection"]
    elif stage == "evaluation":
        params_io = stage_cfg.setdefault("params", {}).setdefault("io", {})
        if "training_dir" not in params_io and "training" in stage_outputs:
            params_io["training_dir"] = stage_outputs["training"]
        if "sample_dir" not in params_io and "sample_collection" in stage_outputs:
            params_io["sample_dir"] = stage_outputs["sample_collection"]
        if (
            "channel_selection_dir" not in params_io
            and "channel_selection" in stage_outputs
        ):
            params_io["channel_selection_dir"] = stage_outputs["channel_selection"]
    elif stage == "visualisation":
        params_io = stage_cfg.setdefault("params", {}).setdefault("io", {})
        if "results_dir" not in params_io and "training" in stage_outputs:
            params_io["results_dir"] = stage_outputs["training"]
        if (
            "channel_selection_dir" not in params_io
            and "channel_selection" in stage_outputs
        ):
            params_io["channel_selection_dir"] = stage_outputs["channel_selection"]


def main(argv=None) -> Dict[str, str]:
    parser = argparse.ArgumentParser(
        prog="python -m decode_tonal_langauge_tpu_torch",
        description="Run every stage of a YAML pipeline config.",
    )
    parser.add_argument("config", help="path to the YAML config")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    args = parser.parse_args(argv)
    return run_pipeline(args.config, device=args.device)


if __name__ == "__main__":
    main()
