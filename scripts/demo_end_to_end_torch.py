#!/usr/bin/env python
"""End-to-end demo on the PyTorch port: raw ECoG -> decoded labels -> speech.

The counterpart of ``scripts/demo_end_to_end.py``: the same five steps,
the same configs and the same outputs, run through
``decode_tonal_langauge_tpu_torch`` with no JAX installed. It runs on the
CUDA card unless ``--device`` names another device (``--device cpu``);
without a card and without ``--device`` it raises.

    1. synthesize a raw subject (blocks + TextGrids)
    2. YAML pipeline: preprocess -> epochs -> channel selection ->
       per-target classifier training (logistic syllable + shallow-MLP
       tone via ``model.per_target``, 2 repeat seeds as one batched fit)
       -> frozen evaluation stage -> figures (none without matplotlib)
    3. synthesizer CLI: SynthesisLite regresses mel spectrograms from
       non-discriminative channels + predicted label dynamics
    4. serving CLI: the training checkpoints + the synthesizer
       checkpoint decode the epochs to labels, mels, and Griffin-Lim
       waveforms (classifier flags recovered from the training run via
       --training_dir)
    5. streaming serving: a continuous preprocessed block decoded as
       sliding windows into per-window predictions + run-length events +
       mels + a WAV

The port's modules it drives, in the order it reaches them (under
``decode_tonal_langauge_tpu_torch/``):

    1. data/synthetic.py
    2. pipeline.py with config.py and registry.py
    3. preprocess/main.py, preprocess/pipelines/subject_block.py,
       preprocess/io/npz_blocks.py, preprocess/preprocessor.py
    4. the Hilbert band and z-score steps: ops/hilbert.py, ops/rereference.py
    5. data/extract_samples.py with data/text_align.py and data/textgrid.py
    6. channel_selection/{main,active,discriminative}.py with ops/anova.py
    7. training/train_classifier.py, training/classifier_pipeline.py and
       the seed dispatch into training/seed_parallel.py
    8. evaluation/main.py
    9. visualisation/main.py
    10. training/train_synthesizer.py with training/synthesis_trainer.py
    11. serving.py in epoch mode, then in stream mode (decode_stream)
    12. ops/griffinlim.py, utils/audio.py

Usage:
    python scripts/demo_end_to_end_torch.py [workdir=demo_run] [--device cpu]

Each step's wall time and the whole run's are printed before the JSON
summary of the two serving runs.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from decode_tonal_langauge_tpu_torch import serving  # noqa: E402
from decode_tonal_langauge_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSpec,
    write_subject,
)
from decode_tonal_langauge_tpu_torch.pipeline import run_pipeline  # noqa: E402
from decode_tonal_langauge_tpu_torch.runtime.device import resolve_device  # noqa: E402
from decode_tonal_langauge_tpu_torch.training import train_synthesizer  # noqa: E402

# The pipeline config and the synthesizer config of
# scripts/demo_end_to_end.py, verbatim, so the two demos run one experiment.
PIPELINE_CONFIG = {
    "dataset": {
        "syllable_labels": ["mi", "ma"],
        "tone_labels": ["tone1", "tone2", "tone3", "tone4"],
    },
    "preprocess": {
        "module": "preprocess_main",
        "params": {
            "pipeline": {
                "module": "preprocess.pipelines.subject_block",
                "params": {
                    "subject_dirs": ["Sub1"],
                    "subject_ids": [1],
                    "figures": False,
                },
            },
            "io": {
                "module": "preprocess.io.npz_blocks",
                "params": {"root_dir": "raw", "output_dir": "processed"},
            },
            "preprocessor": {"module": "preprocess.preprocessor"},
            "modalities": {
                "ecog": {
                    "type": "signal",
                    "preprocessing": {
                        "steps": [
                            {
                                "module": "preprocess.frequency_filter",
                                "params": {
                                    "bands": [
                                        {
                                            "method": "hilbert",
                                            "params": {
                                                "freq_ranges": [70, 120],
                                                "envelope": True,
                                            },
                                        }
                                    ]
                                },
                            },
                            {
                                "module": "preprocess.zscore_rereference",
                                "params": {
                                    "rereference_interval": [0.0, 5.0]
                                },
                            },
                        ]
                    },
                },
                "audio": {"type": "signal"},
            },
        },
    },
    "sample_collection": {
        "module": "extract_samples",
        "params": {
            "io": {
                "output_dir": "samples",
                "textgrid_root": "raw",
                "figures": False,
            },
            "subjects": {
                1: {
                    "start_offset": 0.1,
                    "sample_length": 0.4,
                    "rest_period": [0.0, 5.0],
                    "textgrid_dir": "annotations/subject_1",
                    "tier_list": ["success"],
                }
            },
            "settings": {"syllable_identifiers": ["i", "a"]},
        },
    },
    "channel_selection": {
        "module": "channel_selection_main",
        "params": {
            "io": {"output_dir": "channel_selection", "figures": False},
            "selections": [
                {
                    "module": "channel_selection.active",
                    "selection_name": "active_channels",
                    "params": {
                        "p_threshold": 0.05,
                        "active_time_threshold": 0.05,
                        "rest_name": "ecog_rest",
                        "erp_name": "ecog",
                    },
                },
                {
                    "module": "channel_selection.discriminative",
                    "selection_name": "tone_discriminative",
                    "params": {
                        "p_threshold": 0.05,
                        "active_time_threshold": 0.05,
                        "label": "tone",
                        "recording_name": "ecog",
                    },
                },
                {
                    "module": "channel_selection.discriminative",
                    "selection_name": "syllable_discriminative",
                    "params": {
                        "p_threshold": 0.05,
                        "active_time_threshold": 0.05,
                        "label": "syllable",
                        "recording_name": "ecog",
                    },
                },
            ],
        },
    },
    "model": {
        "model": "models.simple_classifiers.LogisticRegressionClassifier",
        "model_name": "logistic",
        "model_kwargs": {},
        # the per-target hook the paper's CNN+CNN-RNN pairing uses
        # (configs/fast_bf16.yaml); light models here so the demo
        # runs anywhere
        "per_target": {
            "tone": {
                "model": "models.simple_classifiers.ShallowNNClassifier",
                "model_kwargs": {"hidden_dim": 32},
            }
        },
    },
    "training": {
        "module": "train_classifier",
        "params": {
            "io": {"log_dir": "logs"},
            "experiment": {
                "targets": ["syllable", "tone"],
                "features": "ecog",
                "separate_models": True,
                "seed": 42,
                "repeat": 2,
                "verbose": 0,
                "subject_ids": None,
            },
            "training": {
                "train_ratio": 0.7,
                "vali_ratio": 0.1,
                "test_ratio": 0.2,
                "batch_size": 16,
                "epochs": 60,
                "lr": 0.0005,
                "patience": 60,
                "weight_decay": 0.01,
                "standardize": True,
                "save_checkpoints": True,
            },
        },
    },
    "evaluation": {
        "module": "evaluation_main",
        "metrics": ["accuracy", "f1_score", "confusion_matrix"],
        "metric_aggregates": ["mean", "std"],
    },
    "visualisation": {
        "module": "visualisation_main",
        "params": {
            "metrics": ["accuracy"],
            "chance_levels": {
                "accuracy": {
                    "syllable, tone": 0.125,
                    "syllable": 0.5,
                    "tone": 0.25,
                }
            },
        },
    },
}

SYNTH_CONFIG = {
    "mel_kwargs": {"n_fft": 128, "hop_length": 64, "n_mels": 16},
    "tone_dynamic_mapping": {
        "0": [1.0, 1.0, 1.0],
        "1": [1.0, 2.0, 3.0],
        "2": [3.0, 2.0, 1.0],
        "3": [2.0, 1.0, 2.0],
    },
    "n_syllables": 2,
    "n_tones": 4,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("workdir", nargs="?", default="demo_run")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return parser


def main(argv=None) -> dict:
    """Run the five steps in ``workdir``; returns the stage outputs and
    the synthesizer checkpoint (paths relative to ``workdir``), the
    summaries and each step's wall time in seconds."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device: raise before writing anything
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)  # the configs' paths, and so the hashed names, are relative
    try:
        return _run(workdir, args.device)
    finally:
        os.chdir(cwd)


def _run(workdir: str, device) -> dict:
    print(f"== demo workdir: {workdir}")
    device_flag = [] if device is None else ["--device", device]
    walls = {}
    start = step_start = time.perf_counter()

    def lap(step: str) -> None:
        nonlocal step_start
        now = time.perf_counter()
        walls[step] = now - step_start
        print(f"   {step}: {walls[step]:.2f} s")
        step_start = now

    print("== 1/5 generating a synthetic subject")
    spec = SyntheticSpec(
        n_channels=12,
        n_blocks=2,
        trials_per_block=48,
        ecog_sf=400.0,
        audio_sf=800.0,
        # 8-11: active but NOT discriminative — the synthesizer's input
        # set (active minus tone/syllable-discriminative) must be
        # non-empty
        active_channels=tuple(range(12)),
        tone_channels=(0, 1, 2, 3),
        syllable_channels=(4, 5, 6, 7),
    )
    write_subject("raw", 1, spec)
    lap("synthetic")

    print("== 2/5 running the YAML pipeline (per-target classifiers)")
    outputs = run_pipeline(copy.deepcopy(PIPELINE_CONFIG), device=device)
    print(f"   training results: {outputs['training']}/results.csv")
    print(f"   frozen evaluation: {outputs['evaluation']}/results.csv")
    lap("pipeline")

    print("== 3/5 training the speech synthesizer (SynthesisLite)")
    with open("synth_config.json", "w") as f:
        json.dump(SYNTH_CONFIG, f)
    sample_npz = os.path.join(outputs["sample_collection"], "subject_1.npz")
    channel_json = os.path.join(outputs["channel_selection"], "subject_1.json")
    synth_args = train_synthesizer.build_parser().parse_args(
        [
            "--sample_path", sample_npz,
            "--subject_id", "1",
            "--result_file", "synth/results.csv",
            "--figure_dir", "synth/figures",
            "--audio_dir", "synth/wavs",
            "--channel_file", channel_json,
            "--config_file", "synth_config.json",
            "--model_name", "demo_lite",
            "--synthesis_model_name", "SynthesisLite",
            "--syllable_model_name", "logistic",
            "--tone_model_name", "logistic",
            "--checkpoint_dir", "synth/ckpt",
            "--epochs", "30",
            "--batch_size", "16",
            "--audio_sampling_rate", "800",
            "--verbose", "0",
        ] + device_flag
    )
    synth_summary = train_synthesizer.run(synth_args)
    print(
        f"   synthesis test MCD {synth_summary['mcd_mean']:.1f} dB, "
        f"mel Pearson r {synth_summary.get('mel_pearson_r_mean', float('nan')):.3f}"
    )
    lap("synthesizer")

    print("== 4/5 serving: checkpoints decode the epochs to labels + speech")
    synth_ckpt = os.path.join("synth/ckpt", sorted(os.listdir("synth/ckpt"))[0])
    serve_args = serving.build_parser().parse_args(
        [
            "--sample_path", sample_npz,
            "--training_dir", outputs["training"],
            "--config_file", "synth_config.json",
            "--synthesis_model_name", "SynthesisLite",
            "--synthesis_model_path", synth_ckpt,
            "--audio_sampling_rate", "800",
            "--output_dir", "decoded",
            "--n_wavs", "2",
        ] + device_flag
    )
    summary = serving.run(serve_args)
    print("   decoded/ holds predictions.csv, mels.npz, WAVs")
    lap("serving")

    print("== 5/5 streaming: sliding-window decode of a continuous block")
    block_npz = os.path.join(outputs["preprocess"], "subject_1", "B1_ecog.npz")
    stream_args = serving.build_parser().parse_args(
        [
            "--stream_recording", block_npz,
            "--stream_window_s", "0.4",  # = the training sample_length
            "--stream_hop_s", "0.1",
            "--training_dir", outputs["training"],
            "--subject_id", "1",
            "--config_file", "synth_config.json",
            "--synthesis_model_name", "SynthesisLite",
            "--synthesis_model_path", synth_ckpt,
            "--audio_sampling_rate", "800",
            "--output_dir", "streamed",
            "--n_wavs", "1",
        ] + device_flag
    )
    stream_summary = serving.run(stream_args)
    print(
        f"   streamed/ holds windows.csv ({stream_summary['n_windows']} "
        f"windows), events.csv ({stream_summary['n_events']} events), "
        "mels, WAV"
    )
    lap("stream")
    walls["total"] = time.perf_counter() - start
    print(f"== done in {walls['total']:.2f} s (device: {device or 'the CUDA card'})")
    print("   step walls (s): " + json.dumps(walls))
    print(json.dumps({"epochs": summary, "stream": stream_summary}, indent=2))
    return {"outputs": outputs, "epochs": summary, "stream": stream_summary,
            "synthesizer": synth_summary, "synth_ckpt": synth_ckpt, "walls": walls}


if __name__ == "__main__":
    main()
