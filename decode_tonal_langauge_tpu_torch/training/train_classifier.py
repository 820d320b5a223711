"""Classifier-training stage entry.

Counterpart of ``decode_tonal_langauge_tpu/training/train_classifier.py``.
``run(config, device=None) -> log_dir`` flattens the io/experiment/training
sections plus dataset/model (``config.flatten_training_provenance``, the
flattening evaluation and serving repeat on the run's provenance) and
the evaluation section into one params namespace,
discovers ``subject_*.npz`` sample files, derives the hashed experiment
log dir (the JAX stage's name for the same config) with merged provenance
``config.yaml``, draws the per-repeat seeds from the base seed, and runs
the separate/joint regime per subject on ``device`` (``None``: the card,
the rank's own under a process group; it raises without one).

Several processes (``torchrun --nproc_per_node N``, see
``parallel/distributed.py``) run in one of the JAX stage's two regimes:

- with a ``parallel:`` mesh every rank runs every subject in lockstep,
  each fit data-parallel over the ranks, and ranks other than 0 write
  their per-subject files under ``log_dir/.process<k>``; every rank
  returns rank 0's ``log_dir``, so the next stage reads its files;
- without one, :func:`~..parallel.distributed.host_shard` splits the
  subjects between the ranks.

Each process appends its rows to ``results.process<k>.csv``; after a
barrier rank 0 folds the shards into ``results.csv``
(:func:`merge_process_results`).

    python -m decode_tonal_langauge_tpu_torch.training.train_classifier <config.yaml> [--device cpu]
    torchrun --nproc_per_node N -m decode_tonal_langauge_tpu_torch.training.train_classifier <config.yaml>
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
from argparse import Namespace

from ..config import (
    flatten_training_provenance,
    generate_hash_name_from_config,
    load_config,
    namespace_training_params,
    save_config,
)
from ..parallel.distributed import (
    barrier,
    host_shard,
    initialize,
    process_count,
    process_index,
)
from ..parallel.mesh import mesh_from_config
from ..runtime.device import DeviceLike, resolve_device
from ..utils.seeding import seed_stream
from .classifier_pipeline import (
    _append_rows,
    save_and_plot_results,
    train_joint_targets,
    train_separate_targets,
)

# Resume-control keys stay out of the experiment hash: a resumed run must
# land in the same log dir as the fit it continues.
_UNHASHED = ("resume", "train_state_dir", "checkpoint_every")


def run(config: dict, device: DeviceLike = None) -> str:
    device = resolve_device(device)
    print("Running train_classifier ...")

    training_section = config.get("training", {})
    model_cfg = config.get("model", {})
    dataset_cfg = config.get("dataset", {})
    evaluation_cfg = config.get("evaluation", {})

    combined_cfg = {**flatten_training_provenance(config), **evaluation_cfg}
    # The evaluation section documents `metric_aggregates` as the
    # results.csv aggregate columns; the results writer reads `aggregates`.
    if "metric_aggregates" in combined_cfg and "aggregates" not in combined_cfg:
        combined_cfg["aggregates"] = combined_cfg["metric_aggregates"]
    params = namespace_training_params(combined_cfg)
    params.device = device
    # The mesh stays out of combined_cfg: a layout never changes results,
    # so it must not change the experiment hash.
    params.mesh = mesh_from_config(config.get("parallel"))
    if params.mesh is not None:
        print(f"training on mesh {dict(zip(params.mesh.mesh_dim_names, params.mesh.shape))}")

    sample_dir = getattr(params, "sample_dir", "data/samples")
    if not os.path.exists(sample_dir):
        raise FileNotFoundError(
            f"Sample directory {sample_dir} does not exist."
            "Please specify a valid sample_dir in the config."
        )
    subject_files = [
        f for f in sorted(os.listdir(sample_dir))
        if f.endswith(".npz") and f.startswith("subject_")
    ]
    if not subject_files:
        raise FileNotFoundError(
            f"No subject files found in {sample_dir}. "
            "Ensure files are named like 'subject_<id>.npz'."
        )

    base_log_dir = getattr(params, "log_dir", "logs")
    hash_cfg = {k: v for k, v in combined_cfg.items() if k not in _UNHASHED}
    exp_name = generate_hash_name_from_config(
        getattr(params, "model_name", "model"), config=hash_cfg
    )
    params.log_dir = os.path.join(base_log_dir, exp_name)
    os.makedirs(params.log_dir, exist_ok=True)

    # Merge upstream provenance configs into the experiment log dir.
    merged_cfg = {}
    for upstream in ("sample_dir", "channel_selection_dir"):
        upstream_dir = getattr(params, upstream, None)
        if upstream_dir:
            cfg_path = os.path.join(upstream_dir, "config.yaml")
            if os.path.exists(cfg_path):
                merged_cfg.update(load_config(cfg_path) or {})
    merged_cfg.update({
        "model": model_cfg,
        "training": training_section,
        "dataset": dataset_cfg,
        "evaluation": evaluation_cfg,
    })
    if process_index() == 0:
        save_config(os.path.join(params.log_dir, "config.yaml"), merged_cfg)

    seeds = seed_stream(getattr(params, "seed", 42), getattr(params, "repeat", 1))
    subject_filter = _prepare_subject_filter(params, subject_files)

    log_dir = params.log_dir
    if params.mesh is not None and process_count() > 1:
        if process_index() != 0:  # lockstep: rank 0's files are canonical
            params.log_dir = os.path.join(params.log_dir, f".process{process_index()}")
            os.makedirs(params.log_dir, exist_ok=True)
    else:
        subject_files = host_shard(subject_files)

    for subject_file in subject_files:
        subject_id = subject_file.split("_")[1].split(".")[0]
        if subject_id not in subject_filter:
            continue
        print(f"--------- Processing file: {subject_file} ---------")
        subject_params = _prepare_subject_params(params, subject_id)
        if getattr(params, "separate_models", False):
            results, conf_mat, labels = train_separate_targets(subject_params, seeds)
        else:
            results, conf_mat, labels = train_joint_targets(subject_params, seeds)
        save_and_plot_results(subject_params, results, conf_mat, labels)
    merge_process_results(params.log_dir)
    return log_dir  # every rank returns rank 0's directory


def merge_process_results(log_dir: str) -> None:
    """Several processes: after a barrier, rank 0 appends every
    ``results.process<k>.csv`` shard in ``log_dir`` to ``results.csv``
    (the ``csv`` module; columns in order of first appearance) and
    removes the shards. A no-op with one process."""
    if process_count() <= 1:
        return
    barrier("train_classifier:results")
    if process_index() != 0:
        return
    shards = sorted(glob.glob(os.path.join(log_dir, "results.process*.csv")))
    rows = []
    for path in shards:
        with open(path, newline="") as f:
            rows += list(csv.DictReader(f))
    if rows:
        _append_rows(os.path.join(log_dir, "results.csv"), rows)
    for path in shards:
        os.remove(path)
    print(f"Merged {len(shards)} process result shards into "
          f"{os.path.join(log_dir, 'results.csv')}")


def _prepare_subject_params(base_params: Namespace, subject_id: str) -> Namespace:
    subject_params = Namespace(**vars(base_params))
    subject_params.subject_id = subject_id
    subject_params.sample_path = os.path.join(
        base_params.sample_dir, f"subject_{subject_id}.npz"
    )
    channel_dir = getattr(base_params, "channel_selection_dir", None)
    if channel_dir:
        subject_params.channel_file = os.path.join(
            channel_dir, f"subject_{subject_id}.json"
        )
    return subject_params


def _prepare_subject_filter(params: Namespace, subject_files: list) -> list:
    subject_ids = getattr(params, "subject_ids", None)
    if subject_ids:
        return [str(s) for s in subject_ids]
    return [
        f.replace(".npz", "").replace("subject_", "")
        for f in subject_files
        if f.startswith("subject_")
    ]


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        prog="python -m decode_tonal_langauge_tpu_torch.training.train_classifier",
        description="Run the classifier-training stage of a YAML config.",
    )
    parser.add_argument("config", help="path to the YAML config")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    args = parser.parse_args(argv)
    initialize(device=args.device)
    log_dir = run(load_config(args.config), device=args.device)
    print(log_dir)
    return log_dir


if __name__ == "__main__":
    main()
