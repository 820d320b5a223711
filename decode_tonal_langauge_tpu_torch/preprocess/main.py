"""Preprocess stage entry.

``run(config, device=None) -> setup_dir`` resolves the pipeline, IO and
preprocessor plugins from the config and runs the pipeline on ``device``
(``None``: the card, the rank's own under a process group; it raises
without one). Several processes split the blocks between them
(``pipelines/subject_block.py``); with a ``parallel:`` mesh a pipeline
plugin that takes ``devices`` gets this rank's card, as the JAX stage
passes each process its local devices.

    python -m decode_tonal_langauge_tpu_torch.preprocess.main <config.yaml> [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect

from .. import registry
from ..config import dict_to_namespace, load_config
from ..parallel.mesh import mesh_from_config
from ..runtime.device import DeviceLike, resolve_device


def run(config: dict, device: DeviceLike = None) -> str:
    device = resolve_device(device)
    pre_cfg = config.get("preprocess", {}).get("params", {})

    pipeline_cfg = pre_cfg.get("pipeline", {})
    io_cfg = pre_cfg.get("io", {})
    preprocessor_cfg = pre_cfg.get(
        "preprocessor", {"module": "preprocess.preprocessor"}
    )
    modalities_cfg = pre_cfg.get("modalities", {})

    pipeline_module = registry.resolve(pipeline_cfg.get("module"))
    preprocessor_module = registry.resolve(preprocessor_cfg.get("module"))
    io_module = registry.resolve(io_cfg.get("module"))

    pipeline_params = dict_to_namespace(pipeline_cfg.get("params", {}))
    io_params = dict_to_namespace(io_cfg.get("params", {}))

    # A custom pipeline plugin may have the reference's five-argument run.
    kwargs = {}
    accepted = inspect.signature(pipeline_module.run).parameters
    if "device" in accepted:
        kwargs["device"] = device
    if mesh_from_config(config.get("parallel")) is not None:
        if "devices" in accepted:
            kwargs["devices"] = [device]
            print(f"preprocess on {device} (blocks split between the ranks)")
        else:
            print(
                "parallel: set but the pipeline plugin takes no `devices` "
                "argument; preprocessing single-device"
            )

    return pipeline_module.run(
        pipeline_params, io_params, io_module, preprocessor_module,
        modalities_cfg, **kwargs,
    )


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        prog="python -m decode_tonal_langauge_tpu_torch.preprocess.main",
        description="Run the preprocess stage of a YAML config.",
    )
    parser.add_argument("config", help="path to the YAML config")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    args = parser.parse_args(argv)
    setup_dir = run(load_config(args.config), device=args.device)
    print(setup_dir)
    return setup_dir


if __name__ == "__main__":
    main()
