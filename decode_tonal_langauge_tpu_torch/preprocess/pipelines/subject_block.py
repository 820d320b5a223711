"""Subject/block preprocessing pipeline.

Counterpart of ``decode_tonal_langauge_tpu/preprocess/pipelines/subject_block.py``:
iterates ``HS<subject>-B<block>`` directories under the IO root, loads
each block through the IO backend, preprocesses every modality on one
device, and saves the outputs into a content-hash-named setup directory
(``<step names>_<md5(steps)[:6]>``) with a provenance ``config.yaml``.
Each process takes its round-robin share of the blocks
(``parallel.distributed.host_shard``; one process takes them all); a
one-thread writer saves a block while the next one loads and computes.
"""

from __future__ import annotations

import hashlib
import inspect
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ...config import dict_to_namespace, namespace_to_dict
from ...parallel.distributed import host_shard
from ...runtime.device import DeviceLike

# Block saves in flight before the loop waits for the oldest: one being
# written while the next block computes, which bounds the device memory
# that pending saves hold.
MAX_PENDING_SAVES = 2


def get_block_id(dirname: str) -> Optional[int]:
    """Extract the block ID from an ``HS<subject>-B<block>`` directory name."""
    try:
        return int(dirname.split("-")[-1].replace("B", ""))
    except ValueError:
        print(
            f"Skipping directory '{dirname}' as it does not match expected format.",
            "Expected format: 'HS<subject_id>-<block_id>'.",
        )
        return None


def iter_blocks(root_dir: str, subject_dirs, subject_ids=None):
    """Yield (subject_id, block_id, block_path) tuples."""
    if subject_ids is None:
        subject_ids = [i + 1 for i in range(len(subject_dirs))]

    for subject_id, subject_dir in zip(subject_ids, subject_dirs):
        subject_path = os.path.join(root_dir, subject_dir)
        for dir_name in sorted(os.listdir(subject_path)):
            block_id = get_block_id(dir_name)
            if block_id is None:
                continue
            yield subject_id, block_id, os.path.join(subject_path, dir_name)


def generate_setup_name(modalities_cfg: Dict[str, Any]) -> str:
    """Readable + hashed setup name from the configured step list."""
    steps = []
    for mod_cfg in modalities_cfg.values():
        steps.extend(mod_cfg.get("preprocessing", {}).get("steps", []))
    readable_parts = [step["module"].split(".")[-1] for step in steps]
    readable_name = "__".join(readable_parts) if readable_parts else "raw"
    setup_str = "_".join(
        f"{step['module']}_{step.get('params', {})}" for step in steps
    )
    hash_part = hashlib.md5(setup_str.encode()).hexdigest()[:6]
    return f"{readable_name}_{hash_part}" if readable_parts else readable_name


def run(pipeline_params, io_params, io_module, preprocessor_module,
        modalities_cfg, device: DeviceLike = None, devices=None):
    """Preprocess this process's blocks on ``device`` (``None``: the card)
    and return the setup directory. ``devices``, a list of devices, runs
    block i on ``devices[i % len(devices)]`` instead (the preprocess stage
    passes a rank its one card under a ``parallel:`` mesh)."""
    import yaml

    setup_name = generate_setup_name(modalities_cfg)
    setup_dir = os.path.join(io_params.output_dir, setup_name)
    os.makedirs(setup_dir, exist_ok=True)

    figures = getattr(pipeline_params, "figures", True)
    figure_root = os.path.join(setup_dir, "figures")
    if figures:
        os.makedirs(figure_root, exist_ok=True)

    with open(os.path.join(setup_dir, "config.yaml"), "w") as f:
        yaml.dump(
            {
                "preprocess": {
                    "pipeline": namespace_to_dict(pipeline_params),
                    "io": namespace_to_dict(io_params),
                    "modalities": modalities_cfg,
                }
            },
            f,
        )

    blocks = host_shard(list(
        iter_blocks(
            io_params.root_dir,
            pipeline_params.subject_dirs,
            getattr(pipeline_params, "subject_ids", None),
        )
    ))

    # A custom preprocessor plugin may take no `device` argument.
    takes_device = "device" in inspect.signature(
        preprocessor_module.preprocess_modalities).parameters
    if not takes_device and (device is not None or devices):
        print(f"preprocessor plugin takes no `device` argument; {devices or device} "
              "not passed")

    pending = []
    with ThreadPoolExecutor(max_workers=1) as writer:
        for i, (subject_id, block_id, block_path) in enumerate(blocks):
            print(f"Processing block {block_id} of subject {subject_id}...")

            data_dict = io_module.load_block(block_path)

            block_params = dict_to_namespace(
                {
                    **{
                        k: v
                        for k, v in vars(io_params).items()
                        if k not in ("root_dir", "output_dir")
                    },
                    "block_id": block_id,
                    "subject_id": subject_id,
                }
            )

            block_figure_dir = None
            if figures:
                block_figure_dir = os.path.join(
                    figure_root, f"subject_{subject_id}", f"block_{block_id}"
                )
                os.makedirs(block_figure_dir, exist_ok=True)

            kwargs = {}
            if takes_device:
                kwargs["device"] = devices[i % len(devices)] if devices else device
            preprocessor_module.preprocess_modalities(
                data_dict, modalities_cfg, block_params,
                figure_dir=block_figure_dir, **kwargs,
            )

            pending.append(
                writer.submit(
                    io_module.save_block, setup_dir, subject_id, block_id, data_dict
                )
            )
            while len(pending) >= MAX_PENDING_SAVES:
                pending.pop(0).result()  # raise writer errors early

        for future in pending:
            future.result()

    return setup_dir
