"""The port's evaluation stage and ``serving --training_dir``.

Frozen re-evaluation must reproduce the port's own training rows exactly
(separate, joint and ``model.per_target`` regimes, several seeds and
subjects); the provenance recovery (``config.flatten_training_provenance``
and ``namespace_training_params``) and the served flags must equal the
JAX package's on the same provenance; the results schema must equal the
JAX stage's on the same samples; and the error paths must be the JAX
stage's. (The two packages train different weights from one seed, so
their metrics are compared only as a schema.)
"""

import csv
import json
import os
from argparse import Namespace

import numpy as np
import pytest
import torch
import yaml

from decode_tonal_langauge_tpu import config as jconfig
from decode_tonal_langauge_tpu import serving as jserving
from decode_tonal_langauge_tpu.evaluation import main as jevaluation
from decode_tonal_langauge_tpu.training import train_classifier as jtrain
from decode_tonal_langauge_tpu_torch import config, registry, serving
from decode_tonal_langauge_tpu_torch.evaluation import main as evaluation
from decode_tonal_langauge_tpu_torch.models.base import init_params
from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
from decode_tonal_langauge_tpu_torch.runtime.checkpoint import save_checkpoint
from decode_tonal_langauge_tpu_torch.training import classifier_pipeline, train_classifier
from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream


def _samples(root, n=64, subjects=(1,)):
    rng = np.random.default_rng(7)
    syll = np.tile([0, 1], n // 2)
    tone = np.repeat([0, 1, 2, 3], n // 4)  # every (syllable, tone) pair
    d = os.path.join(root, "samples")
    os.makedirs(d)
    for sid in subjects:
        x = rng.standard_normal((n, 6, 10)).astype(np.float32)
        x[syll == 1, :3] += 4.0 * (1 if sid == 1 else -1)
        x[tone == 2, 3:] += 3.0
        np.savez(os.path.join(d, f"subject_{sid}.npz"),
                 ecog=x, ecog_sf=100.0, syllable=syll, tone=tone)
    return d


def _channels(root, subjects=(1,)):
    d = os.path.join(root, "selection")
    os.makedirs(d)
    for sid in subjects:
        with open(os.path.join(d, f"subject_{sid}.json"), "w") as f:
            json.dump({"active_channels": [0, 1, 2, 3, 4, 5],
                       "syllable_discriminative": [0, 1, 2],
                       "tone_discriminative": [3, 4, 5]}, f)
    return d


def _train_config(root, sample_dir, repeat, separate, channel_dir=None,
                  targets=("syllable",), per_target=None):
    io = {"log_dir": os.path.join(root, "logs"), "sample_dir": sample_dir}
    if channel_dir:
        io["channel_selection_dir"] = channel_dir
    model = {"model": "models.simple_classifiers.LogisticRegressionClassifier",
             "model_name": "logistic", "model_kwargs": {}}
    if per_target:
        model["per_target"] = per_target
    return {
        "dataset": {"syllable_labels": ["mi", "ma"],
                    "tone_labels": ["t1", "t2", "t3", "t4"]},
        "model": model,
        "training": {"module": "train_classifier", "params": {
            "io": io,
            "experiment": {"targets": list(targets), "features": "ecog",
                           "separate_models": separate, "seed": 42,
                           "repeat": repeat, "verbose": 0},
            "training": {"train_ratio": 0.6, "vali_ratio": 0.2, "test_ratio": 0.2,
                         "batch_size": 8, "epochs": 12, "lr": 0.01,
                         "standardize": True, "patience": 12,
                         "save_checkpoints": True},
        }},
        "evaluation": {"metrics": ["accuracy", "f1_score", "confusion_matrix"]},
    }


def _eval_config(training_dir, sample_dir, channel_dir=None, **extra):
    io = {"training_dir": training_dir, "sample_dir": sample_dir}
    if channel_dir:
        io["channel_selection_dir"] = channel_dir
    return {"evaluation": {"module": "evaluation_main", "params": {"io": io}, **extra}}


def _rows(path):
    with open(os.path.join(path, "results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _assert_rows_equal(training_dir, eval_dir):
    train, ev = _rows(training_dir), _rows(eval_dir)
    assert [r["target"] for r in ev] == [r["target"] for r in train]
    assert ev == train, "evaluation rows differ from the training rows"


REGIMES = {
    "joint": dict(separate=False, targets=("syllable", "tone")),
    "separate": dict(separate=True, targets=("syllable", "tone")),
    "per_target": dict(separate=True, targets=("syllable", "tone"), per_target={
        "tone": {"model": "models.simple_classifiers.ShallowNNClassifier",
                 "model_kwargs": {"hidden_dim": 16}}}),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_eval_rows_equal_training_rows(tmp_path, regime):
    root = str(tmp_path)
    sample_dir = _samples(root)
    channel_dir = _channels(root) if REGIMES[regime]["separate"] else None
    cfg = _train_config(root, sample_dir, repeat=2, channel_dir=channel_dir,
                        **REGIMES[regime])
    training_dir = train_classifier.run(cfg, device="cpu")
    eval_dir = evaluation.run(_eval_config(training_dir, sample_dir, channel_dir),
                              device="cpu")
    assert eval_dir == os.path.join(training_dir, "evaluation")
    _assert_rows_equal(training_dir, eval_dir)
    cm = "confusion_matrices/subject_1/confusion_matrix.csv"
    with open(os.path.join(training_dir, cm)) as a, open(os.path.join(eval_dir, cm)) as b:
        assert a.read() == b.read()
    if regime == "per_target":
        rows = {r["target"]: r["model_name"] for r in _rows(eval_dir)}
        assert rows == {"syllable, tone": "logistic", "syllable": "logistic",
                        "tone": "ShallowNNClassifier"}


def test_eval_multi_subject_and_metric_override(tmp_path):
    root = str(tmp_path)
    sample_dir = _samples(root, subjects=(1, 2))
    training_dir = train_classifier.run(
        _train_config(root, sample_dir, repeat=2, separate=False), device="cpu")
    eval_dir = evaluation.run(_eval_config(training_dir, sample_dir), device="cpu")
    _assert_rows_equal(training_dir, eval_dir)
    assert [r["subject"] for r in _rows(eval_dir)] == ["1", "2"]
    cfg = _eval_config(training_dir, sample_dir, metrics=["accuracy", "precision", "recall"],
                       metric_aggregates=["mean", "max"])
    cfg["evaluation"]["params"]["io"]["output_dir"] = os.path.join(root, "extra")
    other = evaluation.run(cfg, device="cpu")
    assert other == os.path.join(root, "extra")
    for row in _rows(other):
        for col in ("precision_mean", "recall_max", "accuracy_mean"):
            assert np.isfinite(float(row[col]))


def test_results_schema_equals_jax(tmp_path):
    """Both packages train and evaluate on one subject: the same columns,
    targets, model names, channels and seeds (metrics differ: each trains
    its own weights)."""
    out = {}
    root = str(tmp_path / "run")  # one path: it is part of the hashed config
    for name, train, evaluate in (
        ("jax", jtrain.run, jevaluation.run),
        ("torch", lambda c: train_classifier.run(c, device="cpu"),
         lambda c: evaluation.run(c, device="cpu")),
    ):
        if out:
            os.rename(root, str(tmp_path / "jax"))
        sample_dir, channel_dir = _samples(root), _channels(root)
        cfg = _train_config(root, sample_dir, repeat=2, separate=True,
                            channel_dir=channel_dir, targets=("syllable", "tone"),
                            per_target=REGIMES["per_target"]["per_target"])
        training_dir = train(cfg)
        out[name] = (training_dir, _rows(evaluate(_eval_config(
            training_dir, sample_dir, channel_dir))),
            sorted(os.listdir(os.path.join(training_dir, "model_checkpoints"))))
    (jdir, jrows, jckpts), (tdir, trows, tckpts) = out["jax"], out["torch"]
    assert jdir == tdir and jckpts == tckpts
    assert list(jrows[0]) == list(trows[0])
    for key in ("model_name", "subject", "target", "channels", "seeds"):
        assert [r[key] for r in jrows] == [r[key] for r in trows]


def test_provenance_helpers_equal_jax(tmp_path):
    cfg = _train_config(str(tmp_path), "s", repeat=3, separate=True,
                        per_target=REGIMES["per_target"]["per_target"])
    cfg["model"].pop("model_name")
    flat = config.flatten_training_provenance(cfg)
    assert flat == jconfig.flatten_training_provenance(cfg)
    assert config.PROVENANCE_EXCLUDE_KEYS == jconfig.PROVENANCE_EXCLUDE_KEYS
    got, want = config.namespace_training_params(flat), jconfig.namespace_training_params(flat)
    assert config.namespace_to_dict(got) == jconfig.namespace_to_dict(want)
    assert got.model_name == "LogisticRegressionClassifier"
    assert got.per_target["tone"]["model_kwargs"] == {"hidden_dim": 16}


@pytest.mark.parametrize("name,n_classes", [
    ("logistic", 3), ("ShallowNN", 5), ("CNN", 4), ("none", None), ("missing", None)])
def test_n_classes_from_checkpoint(tmp_path, name, n_classes):
    params = Namespace(training_dir=str(tmp_path), model_name=name, subject_id="1")
    ckpt_dir = tmp_path / "model_checkpoints"
    ckpt_dir.mkdir()
    path = str(ckpt_dir / classifier_pipeline.checkpoint_name(params, "tone", 7))
    if name == "none":  # a user model without a known head name
        save_checkpoint(path, {"proj.bias": torch.zeros(9)})
    elif name != "missing":
        model = init_params(get_classifier_by_name(name, n_classes, 3, 128), seed=0)
        save_checkpoint(path, model)
    cache = {}
    assert evaluation._n_classes_from_checkpoint(params, "tone", 7, cache) == n_classes
    assert (path in cache) == (name not in ("missing",))


def test_eval_joint_radix_pinned_to_training_label_space(tmp_path):
    """An evaluated subset missing a whole tone class keeps the training
    run's label space (n_classes_subject_<id>.json) and head size."""
    rng = np.random.default_rng(3)
    n = 96
    x = rng.standard_normal((n, 6, 10)).astype(np.float32) * 0.1
    tone = np.repeat([0, 1, 2, 3], n // 4)
    syll = np.tile([0, 1], n // 2)
    for t in range(4):
        x[tone == t, t] += 5.0
    x[syll == 1, 4] += 5.0
    root = str(tmp_path)
    sample_dir = os.path.join(root, "samples")
    os.makedirs(sample_dir)
    np.savez(os.path.join(sample_dir, "subject_1.npz"), ecog=x, ecog_sf=100.0,
             tone=tone, syllable=syll)
    cfg = _train_config(root, sample_dir, repeat=1, separate=False,
                        targets=("tone", "syllable"))
    cfg["training"]["params"]["training"].update(epochs=60, patience=60)
    training_dir = train_classifier.run(cfg, device="cpu")
    with open(os.path.join(training_dir, "n_classes_subject_1.json")) as f:
        assert json.load(f) == {"tone": 4, "syllable": 2}
    assert float(_rows(training_dir)[0]["accuracy_mean"]) > 0.9

    keep = tone != 3
    subset = os.path.join(root, "subset")
    os.makedirs(subset)
    np.savez(os.path.join(subset, "subject_1.npz"), ecog=x[keep], ecog_sf=100.0,
             tone=tone[keep], syllable=syll[keep])
    eval_dir = evaluation.run(_eval_config(training_dir, subset), device="cpu")
    assert float(_rows(eval_dir)[0]["accuracy_mean"]) > 0.9


def test_eval_error_paths(tmp_path):
    with pytest.raises(ValueError, match="training_dir"):
        evaluation.run({"evaluation": {"params": {"io": {}}}}, device="cpu")
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        evaluation.run(_eval_config(str(tmp_path), str(tmp_path)), device="cpu")
    root = str(tmp_path)
    sample_dir = _samples(root)
    cfg = _train_config(root, sample_dir, repeat=1, separate=False)
    del cfg["training"]["params"]["training"]["save_checkpoints"]
    training_dir = train_classifier.run(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="save_checkpoints"):
        evaluation.run(_eval_config(training_dir, sample_dir), device="cpu")
    with pytest.raises(FileNotFoundError, match="Sample directory"):
        evaluation.run(_eval_config(training_dir, os.path.join(root, "nowhere")),
                       device="cpu")
    assert registry.resolve("evaluation_main") is evaluation


# ----------------------------------------------------------------------
# serving --training_dir


@pytest.fixture(scope="module")
def served_run(tmp_path_factory):
    """A separate-models run (logistic syllable, ShallowNN tone), 2 seeds,
    checkpoints saved, with the trainer's test predictions recorded."""
    root = str(tmp_path_factory.mktemp("served"))
    sample_dir, channel_dir = _samples(root), _channels(root)
    cfg = _train_config(root, sample_dir, repeat=2, separate=True,
                        channel_dir=channel_dir, targets=("syllable", "tone"),
                        per_target=REGIMES["per_target"]["per_target"])
    cfg["sample_collection"] = {"params": {"subjects": {1: {"sample_length": 0.1}}}}
    fits, fit_all = {}, classifier_pipeline._fit_eval_all_seeds

    def recording(*args, target_str=None, **kwargs):
        results = fit_all(*args, target_str=target_str, **kwargs)
        fits[target_str] = {r.seed: r.test_preds for r in results}
        return results

    classifier_pipeline._fit_eval_all_seeds = recording
    try:
        training_dir = train_classifier.run(cfg, device="cpu")
    finally:
        classifier_pipeline._fit_eval_all_seeds = fit_all
    with open(os.path.join(training_dir, "config.yaml")) as f:
        prov = yaml.safe_load(f)
    prov["sample_collection"] = cfg["sample_collection"]
    with open(os.path.join(training_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(prov, f)
    return {"root": root, "training_dir": training_dir, "fits": fits,
            "sample": os.path.join(sample_dir, "subject_1.npz"),
            "seeds": [int(s) for s in seed_stream(42, 2)]}


def _serve_args(run, out, *extra, sample=True):
    args = ["--training_dir", run["training_dir"], "--output_dir", out,
            "--n_wavs", "0", "--device", "cpu"]
    return args + (["--sample_path", run["sample"]] if sample else []) + list(extra)


@pytest.mark.parametrize("seed_index", [0, 1])
def test_serving_from_training_dir_equals_trainer(served_run, tmp_path, seed_index):
    from decode_tonal_langauge_tpu_torch.data.splits import split_indices

    seed = served_run["seeds"][seed_index]
    out = str(tmp_path / "served")
    extra = ["--seed", str(seed)] if seed_index else []
    summary = serving.run(serving.build_parser().parse_args(
        _serve_args(served_run, out, *extra)))
    assert summary["n_trials"] == 64
    with open(os.path.join(out, "predictions.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    _, _, te = split_indices(64, [0.6, 0.2, 0.2], seed=seed)
    for target in ("tone", "syllable"):
        got = np.array([int(rows[i][f"{target}_pred"]) for i in te])
        np.testing.assert_array_equal(got, served_run["fits"][target][seed])


def test_training_dir_recovers_the_jax_flags(served_run):
    """The flags recovered from one provenance equal JAX's (paths,
    model names, kwargs, channel file, dataset config)."""
    args = _serve_args(served_run, "o")
    got = serving.build_parser().parse_args(args)
    at = args.index("--device")
    want = jserving.build_parser().parse_args(args[:at] + args[at + 2:])
    assert serving._configure_from_training_dir(got) == \
        jserving._configure_from_training_dir(want)
    for key in ("tone_model_name", "tone_model_path", "tone_model_kwargs",
                "syllable_model_name", "syllable_model_path",
                "syllable_model_kwargs", "channel_file", "_provenance_sample_length"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.tone_model_kwargs == {"hidden_dim": 16}


@pytest.mark.parametrize("case", ["conflict", "seed", "subject", "no_provenance",
                                  "synth_no_config", "stream_window", "no_model_flags"])
def test_training_dir_errors(served_run, tmp_path, case):
    out = str(tmp_path / "o")
    args, match, exc = _serve_args(served_run, out), None, ValueError
    if case == "conflict":
        args += ["--tone_model_name", "CNN"]
        match = "not both"
    elif case == "seed":
        args += ["--seed", "12345"]
        match = "seed stream"
    elif case == "subject":
        stream = os.path.join(str(tmp_path), "rec.npz")
        np.savez(stream, data=np.zeros((6, 100), np.float32), sf=100.0)
        args = _serve_args(served_run, out, "--stream_recording", stream,
                           "--stream_window_s", "0.1", sample=False)
        match = "--subject_id"
    elif case == "no_provenance":
        args[1] = str(tmp_path)
        match, exc = "config.yaml", FileNotFoundError
    elif case == "synth_no_config":
        args += ["--synthesis_model_name", "SynthesisLite",
                 "--synthesis_model_path", "x.pt"]
        match = "config_file"
    elif case == "stream_window":
        stream = os.path.join(str(tmp_path), "rec.npz")
        np.savez(stream, data=np.zeros((6, 100), np.float32), sf=100.0)
        args = _serve_args(served_run, out, "--stream_recording", stream,
                           "--stream_window_s", "0.2", "--subject_id", "1",
                           sample=False)
        match = "sample_length"
    else:
        args = ["--sample_path", served_run["sample"], "--output_dir", out]
        match = "--tone_model_name"
    with pytest.raises(exc, match=match):
        serving.run(serving.build_parser().parse_args(args))


def test_training_dir_stream_and_subject_flag(served_run, tmp_path):
    """A stream with --subject_id at the provenance window decodes; the
    JAX-only --no_compilation_cache is accepted with a note, --parallel_data
    1 is one process, and --parallel_data 2 in one process raises."""
    stream = os.path.join(str(tmp_path), "rec.npz")
    rng = np.random.default_rng(0)
    np.savez(stream, data=rng.standard_normal((6, 100)).astype(np.float32), sf=100.0)
    args = lambda *extra: serving.build_parser().parse_args(_serve_args(  # noqa: E731
        served_run, str(tmp_path / "o"), "--stream_recording", stream,
        "--stream_window_s", "0.1", "--stream_hop_s", "0.05", "--subject_id", "1",
        *extra, sample=False))
    summary = serving.run(args("--parallel_data", "1", "--no_compilation_cache"))
    assert summary["n_windows"] == 19
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        serving.run(args("--parallel_data", "2"))
