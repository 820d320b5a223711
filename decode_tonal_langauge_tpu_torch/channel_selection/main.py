"""Channel-selection stage entry.

Counterpart of ``decode_tonal_langauge_tpu/channel_selection/main.py``.
``run(config, device=None) -> output_dir``: for every subject sample npz,
run each configured selection plugin, collect its ``selected_channels``
under its ``selection_name``, draw its figures where ``figures`` is on and
matplotlib imports, and write a per-subject JSON into
``<sample dir base>__<md5[:6]>`` (the JAX stage's directory name), with
the provenance ``config.yaml`` chained. The port's plugins run their
ANOVA on ``device`` (``None``: the card; it raises without one); a user
plugin is called as ``run(data, params)``. Several processes split the
subjects (``parallel.distributed.host_shard``); each writes its subjects'
JSONs, and rank 0 the ``config.yaml``.

    python -m decode_tonal_langauge_tpu_torch.channel_selection.main <config.yaml> [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import warnings

import numpy as np

from .. import registry
from ..config import (
    dict_to_namespace,
    generate_hash_name_from_config,
    load_config,
    update_configuration,
)
from ..parallel.distributed import host_shard, process_index
from ..runtime.device import DeviceLike, resolve_device


def run(config: dict, device: DeviceLike = None) -> str:
    device = resolve_device(device)
    ch_cfg = config.get("channel_selection", {})
    ch_params = ch_cfg.get("params", {})
    io_dict = ch_params.get("io", {})

    params = dict_to_namespace(io_dict)
    figures = getattr(params, "figures", True)
    if figures:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            print(f"no channel-selection figures ({e})")
            figures = False

    output_dir_name = generate_hash_name_from_config(
        os.path.basename(os.path.normpath(params.sample_dir)), ch_cfg
    )
    output_dir = os.path.join(params.output_dir, output_dir_name)
    os.makedirs(output_dir, exist_ok=True)

    figure_root = os.path.join(output_dir, "figures")
    if figures:
        os.makedirs(figure_root, exist_ok=True)

    if process_index() == 0:
        update_configuration(
            output_path=os.path.join(output_dir, "config.yaml"),
            previous_config_path=os.path.join(params.sample_dir, "config.yaml"),
            new_module="channel_selection",
            new_module_cfg=ch_cfg,
        )

    subject_files = host_shard([
        f
        for f in sorted(os.listdir(params.sample_dir))
        if f.endswith(".npz") and f.startswith("subject_")
    ])
    for file_name in subject_files:
        subject_id = file_name.split("_")[1].split(".")[0]
        data = np.load(os.path.join(params.sample_dir, file_name))

        subject_results = {}

        for module_cfg in ch_params.get("selections", []):
            module_name = module_cfg["module"]
            selection_name = module_cfg["selection_name"]
            module_params = module_cfg.get("params", {})

            module = registry.resolve(module_name)
            kwargs = {}
            if "device" in inspect.signature(module.run).parameters:
                kwargs["device"] = device
            module_results = module.run(data, module_params, **kwargs)

            subject_results[selection_name] = [
                int(c) for c in module_results["selected_channels"]
            ]

            if len(subject_results[selection_name]) == 0:
                warnings.warn(
                    "No active channels found for selection "
                    f"{selection_name} in subject {subject_id}."
                )

            if figures and hasattr(module, "generate_figures"):
                module_figure_dir = os.path.join(
                    figure_root, selection_name, f"subject_{subject_id}"
                )
                os.makedirs(module_figure_dir, exist_ok=True)
                module.generate_figures(
                    data, module_results, module_params, figure_dir=module_figure_dir
                )

        output_file = os.path.join(output_dir, f"subject_{subject_id}.json")
        with open(output_file, "w") as f:
            json.dump(subject_results, f, indent=4)

    return output_dir


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        prog="python -m decode_tonal_langauge_tpu_torch.channel_selection.main",
        description="Run the channel-selection stage of a YAML config.",
    )
    parser.add_argument("config", help="path to the YAML config")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    args = parser.parse_args(argv)
    output_dir = run(load_config(args.config), device=args.device)
    print(output_dir)
    return output_dir


if __name__ == "__main__":
    main()
