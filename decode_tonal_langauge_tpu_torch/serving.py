"""End-to-end inference: trained artifacts -> decoded labels + speech.

Counterpart of ``decode_tonal_langauge_tpu/serving.py``:

    epochs (B, C, T)
      -> tone + syllable classifier probabilities        (frozen models)
      -> predicted label dynamics (dense-table gather, on device)
      -> synthesizer mel spectrograms
      -> Griffin-Lim waveforms (batched NNLS + momentum GL)

Checkpoints are torch files ``{"params": state_dict, "scaler": {"mu",
"sd"}}`` (the scaler only where the classifier was trained on
standardised inputs); ``scripts/flax_checkpoint_to_torch.py`` writes them
from the JAX package's Orbax checkpoints. CLI:

    python -m decode_tonal_langauge_tpu_torch.serving \
        --sample_path samples.npz --channel_file channels.json \
        --config_file config.json \
        --tone_model_name CNNRNN --tone_model_path tone.pt \
        --syllable_model_name CNN --syllable_model_path syll.pt \
        --synthesis_model_name SynthesisLite --synthesis_model_path syn.pt \
        --output_dir decoded/ [--n_wavs 4] [--device cuda]

or ``--training_dir <training output> [--seed S] [--subject_id ID]`` in
place of the four classifier flags (and, for a classifier-only decode,
of ``--channel_file`` and ``--config_file``): models, kwargs, checkpoints
and channels come from the run's provenance, as the evaluation stage
recovers them. ``--stream_recording rec.npz --stream_window_s 0.5
[--stream_hop_s 0.1]`` in place of ``--sample_path`` decodes sliding
windows (with ``--training_dir`` the window must equal the run's epoch
length). Writes
``predictions.csv`` (or ``windows.csv`` + ``events.csv``), ``mels.npz``,
the first N ``decoded_*.wav`` and ``summary.json``. When the epoch npz
carries ``audio``, the summary adds the decoded mels' MCD and Pearson r
against the true audio's mels.

``--parallel_data N`` decodes over N ranks, one per card (``torchrun
--nproc_per_node N -m decode_tonal_langauge_tpu_torch.serving ...``,
``parallel/``): the batch is padded to a multiple of N with repeats of its
last row, each rank decodes its slice, the slices are gathered and the
padding stripped, so every rank holds the whole result; rank 0 writes the
files.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .data.utils import select_non_discriminative_channels, tone_dynamics_table
from .models.factory import build_synthesis_model, get_classifier_by_name
from .ops.framing import extract_epochs
from .parallel.distributed import initialize, process_index
from .parallel.mesh import DataParallelLayout, fetch_global, mesh_from_config
from .runtime.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .runtime.device import DeviceLike, exact_f32, resolve_device

_DISCRIMINATIVE = ["tone_discriminative", "syllable_discriminative"]


class TonalDecoder:
    """Frozen-model decoder: ECoG epochs -> labels (+ mels, + audio).

    ``tone_model``, ``syllable_model`` and ``synthesis_model`` are the
    port's modules with their weights loaded; scalers are ``(mu, sd)``
    pairs. Everything moves to ``device`` (``None`` means CUDA). With a
    ``mesh`` the decode batch is split over its ``data`` axis (module
    docstring).
    """

    def __init__(
        self,
        tone_model: nn.Module,
        syllable_model: nn.Module,
        tone_dynamic_mapping: Dict[str, Any],
        synthesis_model: Optional[nn.Module] = None,
        tone_scaler=None,
        syllable_scaler=None,
        device: DeviceLike = None,
        mesh=None,
    ) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
        self._layout = DataParallelLayout(mesh)
        put = lambda m: m.to(self.device).eval() if m is not None else None  # noqa: E731
        self.tone_model = put(tone_model)
        self.syllable_model = put(syllable_model)
        self.synthesis_model = put(synthesis_model)
        self.tone_scaler = self._scaler(tone_scaler)
        self.syllable_scaler = self._scaler(syllable_scaler)
        table, _ = tone_dynamics_table(tone_dynamic_mapping)
        self.dynamics_table = torch.as_tensor(
            table, dtype=torch.float32, device=self.device
        )

    def _scaler(self, scaler):
        if scaler is None:
            return None
        return tuple(
            torch.as_tensor(np.array(v, dtype=np.float32), device=self.device)
            for v in scaler
        )

    @torch.no_grad()
    def _decode(self, x_tone, x_syll, ecog_non):
        with exact_f32():
            if self.tone_scaler is not None:
                mu, sd = self.tone_scaler
                x_tone = (x_tone - mu) / sd
            if self.syllable_scaler is not None:
                mu, sd = self.syllable_scaler
                x_syll = (x_syll - mu) / sd
            tone_probs = self.tone_model(x_tone)
            syll_probs = self.syllable_model(x_syll)
            tones = torch.argmax(tone_probs, dim=1)
            sylls = torch.argmax(syll_probs, dim=1)
            mel = None
            if self.synthesis_model is not None:
                contour = self.dynamics_table[tones]  # (B, n_dynamics)
                syll_seq = sylls[:, None].to(torch.float32).expand(contour.shape)
                dynamics = torch.stack([syll_seq, contour], dim=1)
                mel = self.synthesis_model(ecog_non, dynamics)
        return tones, sylls, tone_probs, syll_probs, mel

    def decode(self, ecog_samples, channel_selections: Dict[str, Any]):
        """Decode epochs (B, C_total, T), numpy or a tensor: returns
        predicted tone and syllable ids, class probabilities and (with a
        synthesizer) the flattened mels, as numpy arrays. Channel subsets
        are sorted, as the training stage lays out weights and scalers."""
        n = ecog_samples.shape[0]
        if n == 0:
            raise ValueError(
                "decode() received zero trials — the ecog array in the "
                "sample npz is empty."
            )
        if not isinstance(ecog_samples, torch.Tensor):  # a copy: numpy may be read-only
            ecog_samples = torch.tensor(np.asarray(ecog_samples, dtype=np.float32))
        x = ecog_samples.to(device=self.device, dtype=torch.float32)
        pad = self._layout.round_batch(n) - n
        if pad:
            x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
        x = self._layout.shard(x)
        idx = lambda ch: torch.as_tensor(sorted(ch), dtype=torch.long,  # noqa: E731
                                         device=self.device)
        non = select_non_discriminative_channels(channel_selections, _DISCRIMINATIVE)
        tones, sylls, tone_probs, syll_probs, mel = self._decode(
            x[:, idx(channel_selections["tone_discriminative"])],
            x[:, idx(channel_selections["syllable_discriminative"])],
            x[:, idx(non)],
        )
        fetch = lambda t: fetch_global(self.mesh, t)[:n]  # noqa: E731
        out = {
            "tone": fetch(tones),
            "syllable": fetch(sylls),
            "tone_probs": fetch(tone_probs),
            "syllable_probs": fetch(syll_probs),
        }
        if mel is not None:
            out["mel"] = fetch(mel)
        return out

    def decode_stream(
        self,
        recording: np.ndarray,
        channel_selections: Dict[str, Any],
        window: int,
        hop: int,
        max_batch: int = 1024,
    ) -> Dict[str, np.ndarray]:
        """Sliding-window decode of a continuous recording (C, T): every
        ``hop``-spaced window of ``window`` samples, gathered on the
        device and decoded in chunks of at most ``max_batch`` windows.
        Returns the epoch-decode outputs plus ``window_start``."""
        recording = np.asarray(recording, dtype=np.float32)
        if recording.ndim != 2:
            raise ValueError(
                f"decode_stream expects a (channels, samples) recording; "
                f"got shape {recording.shape}"
            )
        window, hop = int(window), int(hop)
        if hop < 1:
            raise ValueError(f"hop must be at least 1 sample, got {hop}")
        n_samples = recording.shape[1]
        if window > n_samples:
            raise ValueError(
                f"window ({window} samples) exceeds the recording "
                f"({n_samples} samples)"
            )
        starts = np.arange(0, n_samples - window + 1, hop, dtype=np.int64)
        max_batch = max(int(max_batch), 1)
        rec = torch.tensor(recording, device=self.device)
        chunks = [
            self.decode(
                extract_epochs(rec, torch.as_tensor(starts[lo : lo + max_batch]), window),
                channel_selections,
            )
            for lo in range(0, len(starts), max_batch)
        ]
        out = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        out["window_start"] = starts
        return out

    def synthesize_wavs(
        self,
        mels_flat: np.ndarray,
        sr: int,
        mel_kwargs: Dict[str, Any],
        n: Optional[int] = None,
        init_phase: Optional[torch.Tensor] = None,
    ) -> list:
        """Griffin-Lim waveforms of the first ``n`` flattened mels, the
        whole batch at once."""
        from .utils.audio import mels_to_audio

        n = mels_flat.shape[0] if n is None else min(n, mels_flat.shape[0])
        if n <= 0:
            return []
        waves = mels_to_audio(
            mels_flat[:n],
            n_mels=mel_kwargs.get("n_mels", 128),
            audio_sampling_rate=sr,
            n_fft=mel_kwargs.get("n_fft", 2048),
            hop_length=mel_kwargs.get("hop_length", 512),
            init_phase=init_phase,
            device=self.device,
        )
        return list(waves)


# ----------------------------------------------------------------------
def _mel_dim_from_params(params) -> Optional[int]:
    """Synthesizer output dim from the head bias: ``output_layer``
    (SynthesisModelCNN) or ``fc2`` (SynthesisLite)."""
    for head in ("output_layer.bias", "fc2.bias"):
        if head in params:
            return int(params[head].shape[0])
    return None


def load_decoder(
    channel_selections: Dict[str, Any],
    dataset_config: Dict[str, Any],
    n_timepoints: int,
    tone_model_name: str,
    tone_model_path: str,
    syllable_model_name: str,
    syllable_model_path: str,
    synthesis_model_name: Optional[str] = None,
    synthesis_model_path: Optional[str] = None,
    mel_dim: Optional[int] = None,
    tone_model_kwargs: Optional[Dict[str, Any]] = None,
    syllable_model_kwargs: Optional[Dict[str, Any]] = None,
    synthesis_dtype: Any = "float32",
    device: DeviceLike = None,
    mesh=None,
) -> TonalDecoder:
    """Rebuild the frozen models from checkpoints and wire a decoder. The
    classifiers' compute dtype comes in their kwargs (``dtype``), the
    synthesizer's as ``synthesis_dtype``; the checkpoints hold float32
    parameters either way."""
    if bool(synthesis_model_name) != bool(synthesis_model_path):
        raise ValueError(
            "synthesis_model_name and synthesis_model_path must be given "
            "together (got one without the other)."
        )
    device = resolve_device(device)

    def classifier(name, n_classes, key, path, kwargs):
        model = get_classifier_by_name(
            name, n_classes, len(channel_selections[key]), n_timepoints, kwargs
        )
        params, scaler = load_checkpoint(path)
        model.load_state_dict(params)
        return model, scaler

    tone_model, tone_scaler = classifier(
        tone_model_name, dataset_config["n_tones"], "tone_discriminative",
        tone_model_path, tone_model_kwargs,
    )
    syll_model, syll_scaler = classifier(
        syllable_model_name, dataset_config["n_syllables"],
        "syllable_discriminative", syllable_model_path, syllable_model_kwargs,
    )
    synthesis_model = None
    if synthesis_model_name:
        non = select_non_discriminative_channels(channel_selections, _DISCRIMINATIVE)
        params, _ = load_checkpoint(synthesis_model_path)
        # The checkpoint's head is authoritative for the output dim.
        mel_dim = _mel_dim_from_params(params) or mel_dim
        if mel_dim is None:
            raise ValueError(
                "could not determine the synthesizer output dim: the "
                "checkpoint has no known output head (output_layer/fc2) "
                "and no mel_dim was supplied."
            )
        synthesis_model = build_synthesis_model(
            synthesis_model_name, mel_dim, len(non), n_timepoints,
            dtype=synthesis_dtype,
        )
        synthesis_model.load_state_dict(params)

    return TonalDecoder(
        tone_model, syll_model, dataset_config["tone_dynamic_mapping"],
        synthesis_model=synthesis_model, tone_scaler=tone_scaler,
        syllable_scaler=syll_scaler, device=device, mesh=mesh,
    )


# ----------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Decode ECoG epochs with trained models (serving path, "
                    "PyTorch port)."
    )
    p.add_argument("--sample_path", type=str, default=None,
                   help="Epoch npz (ecog (N,C,T) [+ tone/syllable]) to "
                        "decode. Required unless --stream_recording is given.")
    p.add_argument("--stream_recording", type=str, default=None,
                   help="STREAMING mode: a continuous-recording npz, either "
                        "{data: (C,T), sf} or {ecog, ecog_sf}, decoded as "
                        "hop-spaced sliding windows.")
    p.add_argument("--stream_window_s", type=float, default=None,
                   help="Streaming window length in seconds; must equal the "
                        "training epochs' length.")
    p.add_argument("--stream_hop_s", type=float, default=0.1,
                   help="Streaming hop between windows in seconds.")
    p.add_argument("--stream_min_windows", type=int, default=3,
                   help="Streaming event rule: an event is a run of at least "
                        "this many windows predicting the same labels.")
    p.add_argument("--channel_file", type=str, default=None)
    p.add_argument("--config_file", type=str, default=None)
    p.add_argument("--training_dir", type=str, default=None,
                   help="A training-stage output dir (save_checkpoints: true): "
                        "the classifier models, kwargs (model.per_target "
                        "included), checkpoint paths and the default "
                        "channel_file come from its provenance config.yaml, "
                        "in place of the four --*_model_name/--*_model_path "
                        "flags.")
    p.add_argument("--seed", type=int, default=None,
                   help="With --training_dir: the repeat seed whose "
                        "checkpoints to serve (in the run's seed stream; "
                        "default: the first).")
    p.add_argument("--subject_id", type=str, default=None,
                   help="With --training_dir: the subject whose checkpoints "
                        "to load (default: parsed from a sample file named "
                        "'subject_<id>.npz').")
    p.add_argument("--tone_model_name", type=str, default=None)
    p.add_argument("--tone_model_path", type=str, default=None)
    p.add_argument("--syllable_model_name", type=str, default=None)
    p.add_argument("--syllable_model_path", type=str, default=None)
    p.add_argument("--synthesis_model_name", type=str, default=None)
    p.add_argument("--synthesis_model_path", type=str, default=None)
    p.add_argument("--tone_model_kwargs", type=str, default=None,
                   help='JSON dict of model kwargs used at training time, '
                        'e.g. \'{"lstm_dim": 400, "dtype": "bfloat16"}\'.')
    p.add_argument("--syllable_model_kwargs", type=str, default=None)
    p.add_argument("--synthesis_dtype", type=str, default="float32",
                   help="Synthesis-model compute dtype (match "
                        "train_synthesizer's --dtype; the checkpoint's "
                        "params are float32 either way).")
    p.add_argument("--audio_sampling_rate", type=int, default=24414)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--n_wavs", type=int, default=4)
    p.add_argument("--benchmark", action="store_true",
                   help="Also report single-trial end-to-end decode latency.")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU).")
    p.add_argument("--parallel_data", type=int, default=None,
                   help="Split the decode batch over this many ranks, one "
                        "per card, launched with torchrun.")
    p.add_argument("--no_compilation_cache", action="store_true",
                   help="Accepted for the JAX CLI's sake; the port compiles "
                        "nothing.")
    return p


def _configure_from_training_dir(params: argparse.Namespace) -> Dict[str, Any]:
    """Fill the classifier model and checkpoint flags from a training run.

    Reads the run's provenance ``config.yaml``, flattened as training and
    evaluation flatten it, and resolves per target the model path and
    kwargs (``model.per_target`` overrides included) and the
    ``checkpoint_name``-keyed checkpoint. Returns the dataset-config
    pieces the provenance gives (label counts), used when no
    ``--config_file`` is given."""
    from .config import flatten_training_provenance, load_config, namespace_training_params
    from .training.classifier_pipeline import checkpoint_name, target_model_params
    from .utils.seeding import seed_stream

    conflicting = [
        f"--{a}"
        for a in ("tone_model_name", "tone_model_path", "tone_model_kwargs",
                  "syllable_model_name", "syllable_model_path",
                  "syllable_model_kwargs")
        if getattr(params, a, None)
    ]
    if conflicting:
        raise ValueError(
            f"--training_dir recovers the classifier flags from provenance "
            f"and would silently override {', '.join(conflicting)} — pass "
            "either --training_dir or the explicit model flags, not both."
        )

    cfg_path = os.path.join(params.training_dir, "config.yaml")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"No config.yaml in {params.training_dir} — --training_dir "
            "must point at a training-stage output directory."
        )
    provenance = load_config(cfg_path) or {}
    ns = namespace_training_params(flatten_training_provenance(provenance))

    targets = list(getattr(ns, "targets", []) or [])
    if "tone" not in targets or "syllable" not in targets:
        raise ValueError(
            f"--training_dir run trained targets {targets}; serving needs "
            "checkpoints for both 'tone' and 'syllable'."
        )
    if not getattr(ns, "separate_models", False):
        raise ValueError(
            "--training_dir points at a joint-model run (separate_models: "
            "false); serving decodes per-target checkpoints — pass the "
            "model flags explicitly for joint checkpoints."
        )
    if not getattr(ns, "save_checkpoints", False):
        raise ValueError(
            "--training_dir run did not save checkpoints "
            "(training.save_checkpoints: true is required)."
        )

    subject = params.subject_id
    if subject is None:
        stem = os.path.basename(params.sample_path or "")
        if stem.startswith("subject_") and stem.endswith(".npz"):
            subject = stem[len("subject_"):-len(".npz")]
        else:
            raise ValueError(
                "--subject_id is required with --training_dir when the "
                "sample filename is not 'subject_<id>.npz' (streaming "
                "mode has no sample filename to parse)."
            )

    # The subject's epoch length from provenance: a stream must use the
    # same window (weights load into any window length without error).
    subjects_cfg = (
        (provenance.get("sample_collection") or {}).get("params") or {}
    ).get("subjects") or {}
    entry = subjects_cfg.get(subject)
    if entry is None:
        try:
            entry = subjects_cfg.get(int(subject))
        except (TypeError, ValueError):
            entry = None
    if isinstance(entry, dict) and entry.get("sample_length") is not None:
        params._provenance_sample_length = float(entry["sample_length"])

    seeds = [int(s) for s in seed_stream(getattr(ns, "seed", 42), getattr(ns, "repeat", 1))]
    seed = int(params.seed) if params.seed is not None else seeds[0]
    if seed not in seeds:
        raise ValueError(
            f"--seed {seed} is not in this run's seed stream {seeds}."
        )

    for target in ("tone", "syllable"):
        tp = target_model_params(ns, target)
        tp.subject_id = subject
        ckpt = os.path.join(params.training_dir, "model_checkpoints",
                            checkpoint_name(tp, target, seed))
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"Checkpoint {ckpt} not found.")
        setattr(params, f"{target}_model_name", tp.model)
        setattr(params, f"{target}_model_path", ckpt)
        setattr(params, f"{target}_model_kwargs",
                getattr(tp, "model_kwargs", None) or None)

    if params.channel_file is None:
        channel_dir = getattr(ns, "channel_selection_dir", None)
        if channel_dir:
            params.channel_file = os.path.join(channel_dir, f"subject_{subject}.json")

    # A classifier-only decode: label counts and a placeholder dynamics
    # table. A synthesizer decode needs the synthesizer's --config_file
    # (its contours and mel_kwargs are not in this provenance).
    n_tones = len(getattr(ns, "tone_labels", []) or [])
    n_syllables = len(getattr(ns, "syllable_labels", []) or [])
    if n_tones == 0 or n_syllables == 0:
        raise ValueError(
            "The training provenance records no tone_labels/"
            "syllable_labels (dataset section) — pass --config_file with "
            "n_tones/n_syllables to decode without them."
        )
    return {
        "n_tones": n_tones,
        "n_syllables": n_syllables,
        "tone_dynamic_mapping": {str(i): [float(i)] for i in range(n_tones)},
        "mel_kwargs": {},
    }


def run(params: argparse.Namespace) -> Dict[str, Any]:
    initialize(device=params.device)
    if getattr(params, "no_compilation_cache", False):
        print("--no_compilation_cache: accepted, but the port compiles nothing; ignoring")
    pd = getattr(params, "parallel_data", None)
    mesh = mesh_from_config({"data": pd} if pd else None)

    provenance_dataset_config = None
    if getattr(params, "training_dir", None):
        provenance_dataset_config = _configure_from_training_dir(params)
    else:
        missing = [
            f"--{a}"
            for a in ("tone_model_name", "tone_model_path",
                      "syllable_model_name", "syllable_model_path",
                      "channel_file")
            if not getattr(params, a, None)
        ]
        if missing:
            raise ValueError(
                f"{', '.join(missing)} required (or pass --training_dir "
                "to recover them from a training run's provenance)."
            )

    if params.channel_file is None:
        raise ValueError(
            "--channel_file required: the training provenance recorded no "
            "channel_selection_dir to derive it from."
        )
    with open(params.channel_file) as f:
        channel_selections = json.load(f)
    if params.config_file:
        with open(params.config_file) as f:
            dataset_config = json.load(f)
    elif provenance_dataset_config is not None:
        if params.synthesis_model_name or params.synthesis_model_path:
            raise ValueError(
                "a synthesizer decode needs --config_file (the "
                "synthesizer's JSON: tone_dynamic_mapping contours + "
                "mel_kwargs) — the classifier provenance only derives "
                "label counts."
            )
        dataset_config = provenance_dataset_config
    else:
        raise ValueError(
            "--config_file required (or pass --training_dir to derive "
            "label counts from the run's provenance)."
        )

    streaming = bool(params.stream_recording)
    if streaming:
        if params.sample_path:
            raise ValueError(
                "pass either --sample_path (epoch decode) or "
                "--stream_recording (sliding-window decode), not both."
            )
        if not params.stream_window_s:
            raise ValueError(
                "--stream_window_s is required with --stream_recording "
                "(it must equal the training epochs' sample_length)."
            )
        recording, stream_sf = _load_recording(params.stream_recording)
        expect = getattr(params, "_provenance_sample_length", None)
        if expect is not None and abs(params.stream_window_s - expect) > 1e-9:
            raise ValueError(
                f"--stream_window_s {params.stream_window_s} does not "
                f"match the training run's sample_length {expect} "
                "(provenance) — the models were trained on that epoch "
                "length and would decode a different window silently "
                "wrong."
            )
        window = int(round(params.stream_window_s * stream_sf))
        hop = int(round(params.stream_hop_s * stream_sf))
        dataset: Dict[str, Any] = {}
        n_timepoints = window
    elif params.sample_path:
        dataset = dict(np.load(params.sample_path))
        n_timepoints = dataset["ecog"].shape[2]
    else:
        raise ValueError(
            "--sample_path (epoch decode) or --stream_recording "
            "(sliding-window decode) is required."
        )

    mel_kwargs = dict(dataset_config.get("mel_kwargs", {}))
    decoder = load_decoder(
        channel_selections, dataset_config, n_timepoints,
        params.tone_model_name, params.tone_model_path,
        params.syllable_model_name, params.syllable_model_path,
        synthesis_model_name=params.synthesis_model_name,
        synthesis_model_path=params.synthesis_model_path,
        mel_dim=dataset_config.get("mel_dim"),
        tone_model_kwargs=_parse_model_kwargs(params.tone_model_kwargs),
        syllable_model_kwargs=_parse_model_kwargs(params.syllable_model_kwargs),
        synthesis_dtype=params.synthesis_dtype,
        device=params.device,
        mesh=mesh,
    )
    if streaming:
        return _run_stream(params, decoder, recording, stream_sf, window, hop,
                           channel_selections, mel_kwargs)

    ecog = dataset["ecog"]
    out = decoder.decode(ecog, channel_selections)
    # Every rank: under a mesh each decode is collective.
    latency = (_measure_latency(decoder, ecog, channel_selections)
               if params.benchmark else None)
    if process_index() != 0:
        return {"n_trials": int(ecog.shape[0])}
    os.makedirs(params.output_dir, exist_ok=True)
    summary: Dict[str, Any] = {"n_trials": int(ecog.shape[0])}

    has_true = "tone" in dataset and "syllable" in dataset
    rows = []
    for i in range(ecog.shape[0]):
        row = {"trial": i, "tone_pred": int(out["tone"][i]),
               "syllable_pred": int(out["syllable"][i])}
        if has_true:
            row["tone_true"] = int(dataset["tone"][i])
            row["syllable_true"] = int(dataset["syllable"][i])
        rows.append(row)
    fieldnames = ["trial", "tone_pred", "syllable_pred"] + (
        ["tone_true", "syllable_true"] if has_true else []
    )
    _write_csv(os.path.join(params.output_dir, "predictions.csv"), fieldnames, rows)
    if has_true:
        summary["tone_accuracy"] = float(np.mean(out["tone"] == dataset["tone"]))
        summary["syllable_accuracy"] = float(
            np.mean(out["syllable"] == dataset["syllable"])
        )

    if "mel" in out:
        np.savez(os.path.join(params.output_dir, "mels.npz"), mel=out["mel"],
                 n_mels=np.asarray(mel_kwargs.get("n_mels", 128)))
        if "audio" in dataset:
            summary.update(_mel_quality(out["mel"], dataset["audio"],
                                        params.audio_sampling_rate, mel_kwargs,
                                        decoder.device))
        summary["n_wavs"] = _write_wavs(params, decoder, out["mel"], mel_kwargs,
                                        "decoded_{}.wav")

    if latency is not None:
        summary["trial_latency_s"] = latency
    return _write_summary(params.output_dir, summary)


def segment_windows(tones, syllables, starts, window: int, sf: float,
                    min_windows: int = 3) -> list:
    """Group consecutive same-label windows into decoded EVENTS: a run of
    at least ``min_windows`` windows predicting the same (tone, syllable).
    Returns dicts with onset/offset seconds, labels and run length."""
    tones, syllables, starts = map(np.asarray, (tones, syllables, starts))
    events = []
    i, n = 0, len(starts)
    while i < n:
        j = i
        while (j + 1 < n and tones[j + 1] == tones[i]
               and syllables[j + 1] == syllables[i]):
            j += 1
        run_len = j - i + 1
        if run_len >= max(int(min_windows), 1):
            events.append({
                "onset_s": round(float(starts[i]) / sf, 6),
                "offset_s": round((float(starts[j]) + window) / sf, 6),
                "tone": int(tones[i]),
                "syllable": int(syllables[i]),
                "n_windows": int(run_len),
            })
        i = j + 1
    return events


def _load_recording(path: str):
    """Continuous recording npz -> ((C, T) float32, sampling rate): the
    preprocess stage's block schema {data, sf} or a plain {ecog, ecog_sf}."""
    archive = np.load(path)
    if "data" in archive:
        rec, sf = archive["data"], archive.get("sf")
    elif "ecog" in archive:
        rec, sf = archive["ecog"], archive.get("ecog_sf")
    else:
        raise KeyError(
            f"{path} has keys {sorted(archive.files)}; a streaming "
            "recording needs 'data'+'sf' (preprocess block npz) or "
            "'ecog'+'ecog_sf'."
        )
    if sf is None:
        raise KeyError(f"{path} carries no sampling rate (sf/ecog_sf).")
    rec = np.asarray(rec, dtype=np.float32)
    if rec.ndim != 2:
        raise ValueError(
            f"streaming recording must be (channels, samples); got "
            f"shape {rec.shape}"
        )
    return rec, float(sf)


def _run_stream(params, decoder, recording, sf, window, hop,
                channel_selections, mel_kwargs) -> Dict[str, Any]:
    """Streaming decode: windows.csv + events.csv + mels/wavs + summary."""
    out = decoder.decode_stream(recording, channel_selections, window, hop)
    starts = out["window_start"]
    if process_index() != 0:
        return {"n_windows": len(starts)}
    os.makedirs(params.output_dir, exist_ok=True)
    rows = [
        {
            "window": i,
            "start_s": round(float(s) / sf, 6),
            "tone_pred": int(out["tone"][i]),
            "syllable_pred": int(out["syllable"][i]),
            "tone_prob": float(np.max(out["tone_probs"][i])),
            "syllable_prob": float(np.max(out["syllable_probs"][i])),
        }
        for i, s in enumerate(starts)
    ]
    _write_csv(os.path.join(params.output_dir, "windows.csv"),
               list(rows[0].keys()), rows)
    events = segment_windows(out["tone"], out["syllable"], starts, window, sf,
                             min_windows=params.stream_min_windows)
    _write_csv(os.path.join(params.output_dir, "events.csv"),
               ["onset_s", "offset_s", "tone", "syllable", "n_windows"], events)
    summary: Dict[str, Any] = {
        "n_windows": len(starts),
        "n_events": len(events),
        "window_s": window / sf,
        "hop_s": hop / sf,
        "recording_s": recording.shape[1] / sf,
    }
    if "mel" in out:
        np.savez(os.path.join(params.output_dir, "mels.npz"), mel=out["mel"],
                 window_start=starts,
                 n_mels=np.asarray(mel_kwargs.get("n_mels", 128)))
        summary["n_wavs"] = _write_wavs(params, decoder, out["mel"], mel_kwargs,
                                        "decoded_w{}.wav")
    return _write_summary(params.output_dir, summary)


def _mel_quality(mels, audio, sr, mel_kwargs, device) -> Dict[str, float]:
    """Synthesis quality of decoded mels against the mels of the true
    audio: ``mel_mcd`` (dB) and ``mel_pearson_r``; nothing, with a
    warning, when the shapes differ (mel_kwargs unlike the training
    config's)."""
    from .training.synthesis_trainer import compute_mcd
    from .utils.audio import audio_to_mel

    true_mels = np.stack([audio_to_mel(a, sr, mel_kwargs=mel_kwargs, device=device)
                          for a in audio]).astype(np.float32)
    if true_mels.shape != mels.shape:
        print("WARNING: skipping mel quality metrics: ground-truth mels "
              f"{true_mels.shape} vs decoded {mels.shape} (mel_kwargs mismatch "
              "with the training config?)")
        return {}
    return {"mel_mcd": compute_mcd(true_mels, mels),
            "mel_pearson_r": float(np.corrcoef(mels.ravel(), true_mels.ravel())[0, 1])}


def _write_wavs(params, decoder, mels, mel_kwargs, pattern) -> int:
    from .utils.audio import write_wav

    waves = decoder.synthesize_wavs(mels, params.audio_sampling_rate,
                                    mel_kwargs, n=params.n_wavs)
    for i, wave in enumerate(waves):
        write_wav(os.path.join(params.output_dir, pattern.format(i)), wave,
                  params.audio_sampling_rate)
    return len(waves)


def _write_csv(path, fieldnames, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)


def _write_summary(output_dir, summary) -> Dict[str, Any]:
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def _parse_model_kwargs(value) -> Optional[Dict[str, Any]]:
    if not value:
        return None
    return value if isinstance(value, dict) else json.loads(value)


def _measure_latency(decoder, ecog, channel_selections, n_runs: int = 20):
    """Single-trial end-to-end decode latency (epochs -> labels [+ mel]),
    median over n_runs. ``decode`` copies its results to the host, which
    waits for the device."""
    one = ecog[:1]
    decoder.decode(one, channel_selections)  # warm-up
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        decoder.decode(one, channel_selections)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
