"""Synthesizer-training stage entry and CLI.

Counterpart of ``decode_tonal_langauge_tpu/training/train_synthesizer.py``:
the channel JSON gives the non-discriminative, syllable and tone channel
subsets (the classifier subsets sorted, as the classifier stage lays
them out); each trial's audio becomes a flattened dB mel; the frozen
classifiers are built by short name and loaded from the port's
checkpoints (with their scaler); the repeat seeds come from
``default_rng(seed).integers(0, 10000, repeat)``, each with its own
split; each seed trains and evaluates a synthesizer; one summary row is
appended to the results CSV (pandas' layout, written with ``csv``), and,
where matplotlib imports, the loss curves and mel figures are drawn,
then 2 x n_waves WAVs come from one batched ``mels_to_audio``.

    python -m decode_tonal_langauge_tpu_torch.training.train_synthesizer --help

Runs on ``--device`` (default the CUDA card, and it raises without one).
``--parallel_data N`` (or ``auto``) makes each seed's fit data-parallel
over N ranks, one per card, launched with ``torchrun --nproc_per_node N
-m decode_tonal_langauge_tpu_torch.training.train_synthesizer ...``
(``parallel/``); rank 0 writes the checkpoints, the results row, the
figures and the WAVs. With ``--seed_parallel 1`` (the default) and more
than one seed, every seed is fitted in one batched fit
(``synthesis_trainer.seed_parallel_fit_eval``); a mesh,
``--train_state_dir`` and ``--evaluate_only`` run the seeds one at a time,
as the JAX stage does. ``--no_compilation_cache`` is accepted and changes
nothing: there is no compile cache. ``--dtype bfloat16`` builds the
synthesizer computing in bfloat16 (parameters float32); the frozen
classifiers stay float32. Config JSON keys: ``mel_kwargs``, ``tone_dynamic_mapping``,
``n_syllables``, ``n_tones``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
from torch import nn

from ..data.splits import split_indices
from ..data.utils import select_non_discriminative_channels
from ..models.base import init_params
from ..models.factory import CLASSIFIER_SHORT_NAMES, build_synthesis_model, get_classifier_by_name
from ..parallel.distributed import initialize, process_index
from ..parallel.mesh import mesh_from_config
from ..runtime.device import resolve_device
from ..utils.audio import audio_to_mel, compare_mels, mels_to_audio, write_wav
from ..utils.visualise import plot_training_losses
from .classifier_pipeline import _append_rows
from .synthesis_trainer import SynthesisTrainer, seed_loop_fit_eval, seed_parallel_fit_eval

__all__ = ["build_parser", "build_classifier", "build_synthesis_model", "run", "main"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m decode_tonal_langauge_tpu_torch.training.train_synthesizer",
        description="Train an audio synthesizer on ECoG data (PyTorch port).",
    )
    # ----- I/O -----
    parser.add_argument("--sample_path", type=str, required=True)
    parser.add_argument("--subject_id", type=str, required=True)
    parser.add_argument("--result_file", type=str, required=True)
    parser.add_argument("--figure_dir", type=str, default=None)
    parser.add_argument("--audio_dir", type=str, default=None)
    parser.add_argument("--channel_file", type=str, default="channel_selections.json")
    parser.add_argument("--config_file", type=str, default="config.json")
    parser.add_argument(
        "--checkpoint_dir", type=str, default=None,
        help="Save each seed's trained synthesizer (a torch file "
             "<synthesis_model_name>_seed_<s>) here; the serving module "
             "loads these.",
    )
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--syllable_model_path", type=str, default=None)
    parser.add_argument("--tone_model_path", type=str, default=None)
    parser.add_argument("--synthesis_model_name", type=str, required=True)
    parser.add_argument(
        "--target_mean_init", action=argparse.BooleanOptionalAction, default=True,
        help="Initialise the synthesis output bias with the train-split mel "
             "mean; --no-target_mean_init keeps the seeded (zero) bias.",
    )
    parser.add_argument(
        "--dtype", type=str, default="float32",
        help="Synthesis-model compute dtype (params stay f32): bfloat16 "
             "runs the convs, the label LSTM and the output layer in it.",
    )
    parser.add_argument("--syllable_model_name", type=str, required=True)
    parser.add_argument("--tone_model_name", type=str, required=True)
    # ----- Audio -----
    parser.add_argument("--audio_sampling_rate", type=int, default=24414)
    parser.add_argument("--n_mels", type=int, default=None,
                        help="Override mel_kwargs['n_mels'] from the config JSON.")
    parser.add_argument("--n_fft", type=int, default=None,
                        help="Override mel_kwargs['n_fft'] from the config JSON.")
    parser.add_argument("--hop_length", type=int, default=None,
                        help="Override mel_kwargs['hop_length'] from the config JSON.")
    # ----- Experiment -----
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument(
        "--seed_parallel", type=int, default=1,
        help="Fit all repeat seeds as one batched fit (1, default) or loop "
             "seeds sequentially (0). A mesh, --train_state_dir and "
             "--evaluate_only use the loop.",
    )
    parser.add_argument("--verbose", type=int, default=1)
    # ----- Training -----
    parser.add_argument("--train_ratio", type=float, default=0.9)
    parser.add_argument(
        "--vali_ratio", type=float, default=None,
        help="Optional validation fraction; with --test_ratio it forms a "
             "3-way split (otherwise test = 1 - train_ratio).",
    )
    parser.add_argument("--test_ratio", type=float, default=None)
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the CPU).",
    )
    parser.add_argument(
        "--parallel_data", type=str, default=None,
        help="Data-parallel width: a rank count (one rank per card, launched "
             "with torchrun) or 'auto' for every rank running.",
    )
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.0005)
    # ----- Optimizer (NAdam) -----
    parser.add_argument("--beta_1", type=float, default=0.9)
    parser.add_argument("--beta_2", type=float, default=0.999)
    parser.add_argument("--epsilon", type=float, default=1e-8)
    parser.add_argument(
        "--schedule_decay", type=float, default=0.004,
        help="Weight decay on every parameter (the reference feeds its "
             "schedule_decay to NAdam's weight_decay).",
    )
    parser.add_argument(
        "--moment_dtype", type=str, default=None, choices=["float32", "bfloat16"],
        help="Store the NAdam moments in this dtype at rest (the update "
             "math stays float32).",
    )
    # ----- Full train-state checkpointing -----
    parser.add_argument(
        "--train_state_dir", type=str, default=None,
        help="Save the full per-seed train state (weights, NAdam moments, "
             "generators, epoch counter, history) there.",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="Continue a fit from --train_state_dir exactly where it left "
             "off (--epochs counts the total).",
    )
    parser.add_argument(
        "--checkpoint_every", type=int, default=None,
        help="Checkpoint the train state every N epochs (default: once at "
             "the end of the fit).",
    )
    parser.add_argument(
        "--evaluate_only", action="store_true",
        help="No training: load each seed's synthesizer from "
             "--checkpoint_dir, reproduce that seed's test split and "
             "recompute the test MCD / mel Pearson r rows.",
    )
    parser.add_argument(
        "--no_compilation_cache", action="store_true",
        help="Accepted for the JAX stage's CLI; the port compiles nothing.",
    )
    return parser


def build_classifier(name: str, n_classes: int, n_channels: int, seq_length: int) -> nn.Module:
    """A classifier by short name: CNN, ShallowNN, logistic or CNNRNN,
    with its constructor's defaults."""
    if name not in CLASSIFIER_SHORT_NAMES:
        raise ValueError(
            f"Unknown classifier name '{name}'; expected CNN/ShallowNN/logistic/CNNRNN."
        )
    return get_classifier_by_name(name, n_classes, n_channels, seq_length)


def _init_classifier_variables(model: nn.Module, sample: np.ndarray, path: Optional[str],
                               seed: int = 0):
    """Returns (model, scaler): the model's weights seeded from ``seed``,
    then replaced by the checkpoint at ``path`` when given; the scaler is
    the checkpoint's train-split (mu, sd), or None. ``sample`` is accepted
    for the JAX function's signature."""
    init_params(model, seed)
    if not path:
        return model, None
    from ..runtime.checkpoint import load_checkpoint

    params, scaler = load_checkpoint(path)
    model.load_state_dict(params)
    return model, scaler


def _split_ratios(params: argparse.Namespace) -> list:
    vali_ratio = getattr(params, "vali_ratio", None)
    test_ratio = getattr(params, "test_ratio", None)
    if vali_ratio is not None and test_ratio is not None:
        ratios = [params.train_ratio, vali_ratio, test_ratio]
    elif test_ratio is not None:
        ratios = [params.train_ratio, test_ratio]
    elif vali_ratio is not None:
        ratios = [params.train_ratio, vali_ratio, 1.0 - params.train_ratio - vali_ratio]
    else:
        ratios = [params.train_ratio, 1.0 - params.train_ratio]
    if abs(sum(ratios) - 1.0) > 1e-6 or any(r <= 0 for r in ratios[:1] + ratios[-1:]):
        raise ValueError(
            f"Split ratios {ratios} must be positive and sum to 1 "
            "(check --train_ratio/--vali_ratio/--test_ratio)."
        )
    return ratios


def _note_jax_only_flags(params: argparse.Namespace) -> None:
    """One line naming the JAX stage's flag that changes nothing here."""
    if getattr(params, "no_compilation_cache", False):
        print("--no_compilation_cache: accepted, but the port compiles nothing; ignoring")


def _figures(params, history, origin_mels, recon_mels, n_mels: int) -> None:
    """The loss curves (after a fit) and one mel comparison a wave, where
    matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"no figures ({e})")
        return
    if history is not None:
        plot_training_losses(history, labels=("L1 loss", "MCD"),
                             figure_path=os.path.join(params.figure_dir, "training_losses.png"))
    for i, (origin, recon) in enumerate(zip(origin_mels, recon_mels)):
        compare_mels(origin.reshape(n_mels, -1), recon.reshape(n_mels, -1),
                     audio_sampling_rate=params.audio_sampling_rate, title1="Original",
                     title2="Reconstruction",
                     file_path=os.path.join(params.figure_dir, f"mel_compare_{i}.png"))


def run(params: argparse.Namespace) -> dict:
    """Train (or, with ``evaluate_only``, re-evaluate) the synthesizer
    for every repeat seed; returns the summary row, also appended to the
    results CSV."""
    initialize(device=getattr(params, "device", None))
    device = resolve_device(getattr(params, "device", None))
    _note_jax_only_flags(params)
    pd = getattr(params, "parallel_data", None)
    mesh = mesh_from_config({"data": pd} if pd else None)
    writer = process_index() == 0
    evaluate_only = bool(getattr(params, "evaluate_only", False))
    if evaluate_only and not getattr(params, "checkpoint_dir", None):
        raise ValueError(
            "--evaluate_only needs --checkpoint_dir pointing at the "
            "synthesizer checkpoints a previous fit saved."
        )
    if not os.path.exists(params.sample_path):
        raise FileNotFoundError(f"Data file '{params.sample_path}' does not exist.")
    for d in (params.figure_dir, params.audio_dir):
        if d:
            os.makedirs(d, exist_ok=True)
    result_dir = os.path.dirname(params.result_file)
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)

    with open(params.channel_file) as f:
        channel_selections = json.load(f)
    non_discriminative = select_non_discriminative_channels(
        channel_selections, ["tone_discriminative", "syllable_discriminative"]
    )
    if params.verbose > 0:
        print(f"Found {len(non_discriminative)} non-discriminative channels.")

    with open(params.config_file) as f:
        config = json.load(f)
    mel_kwargs = dict(config["mel_kwargs"])
    for key in ("n_mels", "n_fft", "hop_length"):
        value = getattr(params, key, None)
        if value is not None:
            mel_kwargs[key] = value

    dataset = np.load(params.sample_path)
    ecog = dataset["ecog"]
    ecog_non = ecog[:, non_discriminative, :]
    # Sorted, as the classifier stage lays out its channel union.
    ecog_syllables = ecog[:, sorted(channel_selections["syllable_discriminative"]), :]
    ecog_tones = ecog[:, sorted(channel_selections["tone_discriminative"]), :]
    mels = np.stack([
        audio_to_mel(audio, params.audio_sampling_rate, mel_kwargs=mel_kwargs, device=device)
        for audio in dataset["audio"]
    ])
    if params.verbose > 0:
        print("Number of Mel spectrogram coefficients", mels.shape[1:])

    n_timepoints = ecog_non.shape[2]
    syllable_model, syllable_scaler = _init_classifier_variables(
        build_classifier(params.syllable_model_name, config["n_syllables"],
                         ecog_syllables.shape[1], n_timepoints),
        ecog_syllables, params.syllable_model_path)
    tone_model, tone_scaler = _init_classifier_variables(
        build_classifier(params.tone_model_name, config["n_tones"],
                         ecog_tones.shape[1], n_timepoints),
        ecog_tones, params.tone_model_path)

    seeds = np.random.default_rng(params.seed).integers(0, 10000, params.repeat)
    ratios = _split_ratios(params)

    def make_trainer(seed: int) -> SynthesisTrainer:
        model = build_synthesis_model(
            params.synthesis_model_name, mels.shape[1], ecog_non.shape[1], n_timepoints,
            dtype=getattr(params, "dtype", "float32"))
        return SynthesisTrainer(
            model, tone_model, syllable_model, config["tone_dynamic_mapping"],
            learning_rate=params.lr, beta_1=getattr(params, "beta_1", 0.9),
            beta_2=getattr(params, "beta_2", 0.999), epsilon=getattr(params, "epsilon", 1e-8),
            schedule_decay=getattr(params, "schedule_decay", 0.004), seed=seed,
            verbose=params.verbose > 0, tone_scaler=tone_scaler,
            syllable_scaler=syllable_scaler,
            moment_dtype=getattr(params, "moment_dtype", None), device=device,
            mesh=mesh,
        )

    def ckpt_path(root: str, seed) -> str:
        return os.path.join(root, f"{params.synthesis_model_name}_seed_{int(seed)}")

    arrays = (ecog_non, ecog_syllables, ecog_tones, mels)
    splits = [split_indices(ecog_non.shape[0], ratios, seed=int(seed)) for seed in seeds]
    test_stacks = tuple(np.stack([a[s[-1]] for s in splits]) for a in arrays)
    trainer = make_trainer(int(seeds[0]))
    # All repeat seeds as one batched fit, under the JAX stage's rule: a
    # mesh keeps the loop (each seed's fit data-parallel), and so do
    # per-seed train states (the batched fit has no per-seed resume).
    train_state_dir = getattr(params, "train_state_dir", None)
    seed_parallel = (
        bool(getattr(params, "seed_parallel", True))
        and len(seeds) > 1
        and mesh is None
        and not train_state_dir
        and not evaluate_only
    )
    if evaluate_only:
        per_seed = []
        for i, seed in enumerate(seeds):
            path = ckpt_path(params.checkpoint_dir, seed)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"Synthesizer checkpoint {path} not found: run the fit with "
                    "--checkpoint_dir first (and the same --seed/--repeat so the "
                    "seed streams line up)."
                )
            seed_trainer = trainer.for_seed(int(seed))
            seed_trainer.load_checkpoint(path)
            per_seed.append((None,) + seed_trainer.evaluate(
                tuple(a[i] for a in test_stacks), batch_size=params.batch_size))
    else:
        train_stacks = tuple(np.stack([a[s[0]] for s in splits]) for a in arrays)
        target_means = (np.stack([mels[s[0]].mean(axis=0) for s in splits])
                        if getattr(params, "target_mean_init", True) else None)
        fit_args = (trainer, seeds, train_stacks, test_stacks, params.epochs,
                    params.batch_size, target_means)
        if seed_parallel:
            per_seed = seed_parallel_fit_eval(*fit_args)
        else:
            per_seed = seed_loop_fit_eval(
                *fit_args, verbose=params.verbose > 1,
                train_state_dirs=([ckpt_path(train_state_dir, s) for s in seeds]
                                  if train_state_dir else None),
                resume=bool(getattr(params, "resume", False)),
                checkpoint_every=getattr(params, "checkpoint_every", None))
        if getattr(params, "checkpoint_dir", None) and writer:
            from ..runtime.checkpoint import save_checkpoint

            os.makedirs(params.checkpoint_dir, exist_ok=True)
            for seed, state in zip(seeds, trainer.seed_params):
                save_checkpoint(ckpt_path(params.checkpoint_dir, seed), state)

    mcds, pearson_rs = [], []
    for seed, (_, mcd, recon_mels, origin_mels) in zip(seeds, per_seed):
        mcds.append(mcd)
        pearson_rs.append(float(np.corrcoef(np.asarray(recon_mels).ravel(),
                                            np.asarray(origin_mels).ravel())[0, 1]))
        if params.verbose > 0:
            print(f"Seed {seed}: test MCD = {mcd:.4f}, mel Pearson r = {pearson_rs[-1]:.4f}")

    summary = {
        "model_name": params.model_name,
        "synthesis_model": params.synthesis_model_name,
        "subject": params.subject_id,
        "model_size": trainer.n_params(),
        "seeds": str(list(map(int, seeds))),
        "mcd_mean": float(np.mean(mcds)),
        "mcd_std": float(np.std(mcds)),
        "mcd_all": str([float(m) for m in mcds]),
        "mel_pearson_r_mean": float(np.mean(pearson_rs)),
        "mel_pearson_r_std": float(np.std(pearson_rs)),
    }
    if not writer:
        return summary
    _append_rows(params.result_file, [summary])

    history, _, recon_mels, origin_mels = per_seed[-1]
    n_mels = mel_kwargs.get("n_mels", 128)
    n_waves = min(10, recon_mels.shape[0])
    if params.figure_dir:
        _figures(params, history, origin_mels[:n_waves], recon_mels[:n_waves], n_mels)
    if params.audio_dir and n_waves:
        # All 2 * n_waves inversions (origin, then reconstruction) in one batch.
        waves = mels_to_audio(
            np.concatenate([origin_mels[:n_waves], recon_mels[:n_waves]], axis=0),
            n_mels=n_mels, audio_sampling_rate=params.audio_sampling_rate,
            n_fft=mel_kwargs.get("n_fft", 2048), hop_length=mel_kwargs.get("hop_length", 512),
            device=device,
        )
        for i in range(n_waves):
            for tag, wave in (("origin", waves[i]), ("recon", waves[n_waves + i])):
                write_wav(os.path.join(params.audio_dir, f"{tag}_{i}.wav"), wave,
                          params.audio_sampling_rate)
    return summary


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
