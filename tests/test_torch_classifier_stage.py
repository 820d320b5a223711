"""The port's classifier-training stage against the JAX package's: the
numpy helpers held exactly, then the whole stage through both packages'
``train_classifier.run`` on one synthetic subject.

The two stages initialise their weights and draw their batch orders from
different generators (``jax.random`` against torch), so whole runs are
held by what must be equal (the hashed log dir, the file tree, CSV
columns and rows, the class counts, checkpoint names) and statistically
by accuracy: both well above chance on a separable subject.
"""

import csv
import json
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu import config as jconfig
from decode_tonal_langauge_tpu.data.sample_loading import (
    ClassificationSampleHandler as JHandler,
)
from decode_tonal_langauge_tpu.data.splits import split_indices as jsplit
from decode_tonal_langauge_tpu.training import train_classifier as jstage
from decode_tonal_langauge_tpu.utils import metrics as jmetrics
from decode_tonal_langauge_tpu.utils.seeding import seed_stream as jseed_stream
from decode_tonal_langauge_tpu_torch import config, registry, serving
from decode_tonal_langauge_tpu_torch.data.sample_loading import ClassificationSampleHandler
from decode_tonal_langauge_tpu_torch.data.splits import batch_iter, split_indices
from decode_tonal_langauge_tpu_torch.training import train_classifier
from decode_tonal_langauge_tpu_torch.training.classifier_pipeline import (
    checkpoint_name,
    target_model_params,
)
from decode_tonal_langauge_tpu_torch.utils import metrics
from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream, set_seeds
from decode_tonal_langauge_tpu_torch.utils.visualise import plot_confusion_matrix


@pytest.mark.parametrize("n,ratios,seed", [
    (100, [0.7, 0.1, 0.2], 42), (37, [0.6, 0.2, 0.2], 7), (10, [0.5, 0.5], 0),
])
def test_split_indices_equal_jax(n, ratios, seed):
    for got, want in zip(split_indices(n, ratios, seed), jsplit(n, ratios, seed)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        split_indices(10, [0.7, 0.5], 0)
    batches = list(batch_iter(10, 4, True, np.random.default_rng(0)))
    assert [len(b) for b in batches] == [4, 4, 2]
    assert sorted(np.concatenate(batches)) == list(range(10))


def test_seed_stream_equals_jax():
    for seed, repeat in ((42, 1), (42, 5), (0, 3)):
        np.testing.assert_array_equal(seed_stream(seed, repeat), jseed_stream(seed, repeat))
    g = set_seeds(3)
    assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=torch.Generator().manual_seed(3)))


_ALL = ["accuracy", "f1_score", "precision", "recall", "cohen_kappa", "confusion_matrix"]


@pytest.mark.parametrize("case", range(4))
def test_metrics_equal_sklearn(case):
    rng = np.random.default_rng(case)
    true = rng.integers(0, 5, 40)
    preds = np.where(rng.random(40) < 0.5, true, rng.integers(0, 6, 40))
    if case == 1:
        true[true == 2] = 3  # a class predicted but never true
    if case == 2:
        preds = np.full(40, 1)  # a single predicted class
    got = metrics.compute_classification_metrics(true, preds, _ALL)
    want = jmetrics.compute_classification_metrics(true, preds, _ALL)
    for m in _ALL:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-12, atol=1e-12, err_msg=m)
        assert type(got[m]) is type(want[m]) or m == "confusion_matrix"
    from sklearn import metrics as skm

    assert metrics.balanced_accuracy(true, preds) == pytest.approx(
        skm.balanced_accuracy_score(true, preds), abs=1e-12)
    assert metrics.macro_f1(true, preds) == pytest.approx(
        skm.f1_score(true, preds, average="macro"), abs=1e-12)
    np.testing.assert_array_equal(
        metrics.confusion_matrix(true, preds, labels=np.arange(7)),
        skm.confusion_matrix(true, preds, labels=np.arange(7)))


def test_joint_metrics_and_sklearn_fallback_equal_jax():
    rng = np.random.default_rng(5)
    true = {"tone": rng.integers(0, 4, 30), "syllable": rng.integers(0, 2, 30)}
    preds = {k: np.where(rng.random(30) < 0.6, v, 0) for k, v in true.items()}
    names = ["accuracy", "f1_score", "balanced_accuracy_score", "matthews_corrcoef"]
    got = metrics.compute_classification_metrics_joint(true, preds, names)
    want = jmetrics.compute_classification_metrics_joint(true, preds, names)
    for m in names:
        assert got[m] == pytest.approx(want[m], abs=1e-12), m
    with pytest.raises(ValueError, match="neither"):
        metrics.compute_classification_metrics([0], [0], ["no_such_metric"])
    with pytest.raises(ValueError):
        metrics.compute_classification_metrics_joint({"a": [0]}, {"b": [0]})


@pytest.fixture
def sample_npz(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "subject_1.npz"
    np.savez(path, ecog=rng.standard_normal((12, 5, 8)).astype(np.float32),
             tone=rng.integers(0, 4, 12), syllable=rng.integers(0, 2, 12))
    channels = tmp_path / "channels.json"
    channels.write_text(json.dumps({"tone_discriminative": [3, 1],
                                    "syllable_discriminative": [1, 4]}))
    return str(path), str(channels)


@pytest.mark.parametrize("targets,with_channels,extra", [
    (["tone"], False, {}),
    (["syllable", "tone"], True, {}),
    (["tone", "syllable"], True, {"class_labels": {"tone": ["a", "b", "c", "d"]}}),
    (["tone"], False, {"expected_n_classes": {"tone": 6}}),
])
def test_sample_handler_equals_jax(sample_npz, targets, with_channels, extra):
    path, channels = sample_npz
    params = Namespace(sample_path=path, targets=targets, features="ecog", **extra)
    if with_channels:
        params.channel_file = channels
    got_h, want_h = ClassificationSampleHandler(params), JHandler(params)
    got, want = got_h.load_data(), want_h.load_data()
    for key in ("features", "labels", "selected_channels"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["n_classes_dict"] == want["n_classes_dict"]
    assert got_h.prepare_class_labels(got["n_classes_dict"]) == \
        want_h.prepare_class_labels(want["n_classes_dict"])


def test_hash_names_equal_jax():
    for cfg in ({}, {"lr": 5e-4, "targets": ["tone"], "model_kwargs": {"lstm_dim": 800}},
                {"b": [1, 2], "a": {"z": None, "y": 1.5}}):
        assert config.generate_hash_name_from_config("m", cfg) == \
            jconfig.generate_hash_name_from_config("m", cfg)
    assert config.flatten_sections({"io": {"a": 1}, "training": {"b": 2}},
                                   ("io", "experiment", "training")) == {"a": 1, "b": 2}


def test_registry_names_the_stage_and_model_paths():
    assert registry.resolve("train_classifier") is train_classifier
    assert registry.canonical_module_path(
        "models.deep_classifiers.CNNRNNClassifier"
    ) == "decode_tonal_langauge_tpu_torch.models.deep.CNNRNNClassifier"
    shipped = config.load_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "example_config.yaml"))
    assert registry.resolve(shipped["training"]["module"]) is train_classifier
    from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name

    assert type(get_classifier_by_name(shipped["model"]["model"], 2, 3, 4)).__name__ == \
        "LogisticRegressionClassifier"


def test_target_model_params_and_checkpoint_name():
    base = Namespace(model="models.deep_classifiers.CNNClassifier", model_name="CNN",
                     model_kwargs={}, subject_id="1",
                     per_target={"tone": {"model": "models.deep_classifiers.CNNRNNClassifier",
                                          "model_kwargs": {"lstm_dim": 800}}})
    tone = target_model_params(base, "tone")
    assert (tone.model_name, tone.model_kwargs) == ("CNNRNNClassifier", {"lstm_dim": 800})
    assert target_model_params(base, "syllable") is base
    assert checkpoint_name(tone, "tone", 7) == "tone_CNNRNNClassifier_subject_1_seed_7"


def test_confusion_figure_is_written(tmp_path):
    path = str(tmp_path / "cm.png")
    plot_confusion_matrix(np.eye(3) * 4, label_names=["a", "b", "c"], figure_path=path)
    assert os.path.getsize(path) > 0


# ----------------------------------------------------------------------
# The whole stage through both packages.
def _subject(root):
    rng = np.random.default_rng(0)
    n = 96
    x = rng.standard_normal((n, 6, 10)).astype(np.float32)
    syll = np.tile(np.repeat([0, 1], 4), n // 8)
    tone = np.tile([0, 1, 2, 3], n // 4)  # every (syllable, tone) pair occurs
    x[syll == 1, :3] += 3.0
    for k in range(4):
        x[tone == k, 3 + k % 3] += 2.0 * (k > 0)
    sample_dir = os.path.join(root, "samples")
    os.makedirs(sample_dir)
    np.savez(os.path.join(sample_dir, "subject_1.npz"), ecog=x, ecog_sf=100.0,
             syllable=syll, tone=tone)
    return sample_dir


def _stage_config(root, sample_dir, separate, **training):
    return {
        "model": {"model": "models.simple_classifiers.LogisticRegressionClassifier",
                  "model_name": "logistic", "model_kwargs": {}},
        "training": {"module": "train_classifier", "params": {
            "io": {"log_dir": os.path.join(root, "logs"), "sample_dir": sample_dir},
            "experiment": {"targets": ["syllable", "tone"], "features": "ecog",
                           "separate_models": separate, "seed": 42, "repeat": 2,
                           "verbose": 0},
            "training": {"train_ratio": 0.7, "vali_ratio": 0.1, "test_ratio": 0.2,
                         "batch_size": 16, "epochs": 8, "lr": 0.01, "patience": 100,
                         "weight_decay": 0.01, "standardize": True,
                         "save_checkpoints": True, **training},
        }},
        "evaluation": {"metrics": ["accuracy", "f1_score", "confusion_matrix"],
                       "metric_aggregates": ["mean", "std"]},
    }


def _tree(root):
    """Relative paths under ``root``, TensorBoard event files left out
    (their names carry a time and a host) and checkpoints by name (Orbax
    writes directories, the port files)."""
    out = set()
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if rel.startswith("model_checkpoints"):
            if rel == "model_checkpoints":
                out.update(os.path.join(rel, n) for n in dirs + files)
                dirs.clear()
            continue
        out.update(os.path.normpath(os.path.join(rel, f)) for f in files
                   if not f.startswith("events.out.tfevents"))
    return out


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
def test_stage_matches_jax_stage(tmp_path, separate):
    sample_dir = _subject(str(tmp_path))
    cfg = _stage_config(str(tmp_path), sample_dir, separate)
    jdir = jstage.run(cfg)  # the log dir is in the hashed config: run in turn
    os.rename(tmp_path / "logs", tmp_path / "jax_logs")
    tdir = train_classifier.run(cfg, device="cpu")
    assert tdir == jdir
    jdir = os.path.join(tmp_path, "jax_logs", os.path.basename(jdir))
    assert _tree(tdir) == _tree(jdir)
    for name in ("n_classes_subject_1.json",):
        with open(os.path.join(tdir, name)) as a, open(os.path.join(jdir, name)) as b:
            assert json.load(a) == json.load(b)
    assert config.load_config(os.path.join(tdir, "config.yaml")) == \
        config.load_config(os.path.join(jdir, "config.yaml"))

    got, want = _rows(os.path.join(tdir, "results.csv")), _rows(os.path.join(jdir, "results.csv"))
    assert got[0] == want[0] and len(got) == len(want)
    col = {c: i for i, c in enumerate(got[0])}
    for g, w in zip(got[1:], want[1:]):
        for c in ("model_name", "model_size", "subject", "target", "channels", "seeds"):
            assert g[col[c]] == w[col[c]], c
    chance = {"syllable": 0.5, "tone": 0.25, "syllable, tone": 0.125}
    for rows in (got, want):
        for r in rows[1:]:
            acc = float(r[col["accuracy_mean"]])
            assert acc >= chance[r[col["target"]]] + 0.3, (r[col["target"]], acc)

    for sub in ("confusion_matrices/subject_1",):
        for name in os.listdir(os.path.join(jdir, sub)):
            g, w = _rows(os.path.join(tdir, sub, name)), _rows(os.path.join(jdir, sub, name))
            assert g[0] == w[0] and len(g) == len(w)  # header and shape
            total = lambda rows: sum(float(v) for r in rows[1:] for v in r)  # noqa: E731
            assert total(g) == total(w)  # every test trial counted once per seed
    seed_dir = next(d for d in _tree(tdir) if d.endswith("metrics.csv"))
    assert _rows(os.path.join(tdir, seed_dir))[0] == _rows(os.path.join(jdir, seed_dir))[0]


def test_stage_checkpoints_serve_the_trained_predictions(tmp_path, monkeypatch):
    """Checkpoints of the port's stage load into the port's serving path,
    which reproduces the trainer's test predictions."""
    from decode_tonal_langauge_tpu_torch.training import classifier_pipeline

    sample_dir = _subject(str(tmp_path))
    preds = {}
    fit_all = classifier_pipeline._fit_eval_all_seeds

    def recording(*args, target_str=None, **kwargs):  # each target's results
        results = fit_all(*args, target_str=target_str, **kwargs)
        preds[target_str] = {r.seed: r.test_preds for r in results}
        return results

    monkeypatch.setattr(classifier_pipeline, "_fit_eval_all_seeds", recording)
    log_dir = train_classifier.run(
        _stage_config(str(tmp_path), sample_dir, True), device="cpu")
    assert sorted(preds) == ["syllable", "tone"]
    data = np.load(os.path.join(sample_dir, "subject_1.npz"))
    chans = list(range(6))
    selections = {"active_channels": chans, "tone_discriminative": chans,
                  "syllable_discriminative": chans}
    ckpt = lambda t, s: os.path.join(  # noqa: E731
        log_dir, "model_checkpoints", f"{t}_logistic_subject_1_seed_{s}")
    for seed in seed_stream(42, 2):
        _, _, te = split_indices(96, [0.7, 0.1, 0.2], seed=int(seed))
        decoder = serving.load_decoder(
            selections, {"n_tones": 4, "n_syllables": 2, "tone_dynamic_mapping": {"0": [0.0]}},
            10, "logistic", ckpt("tone", seed), "logistic", ckpt("syllable", seed),
            device="cpu")
        out = decoder.decode(data["ecog"][te], selections)
        np.testing.assert_array_equal(out["tone"], preds["tone"][seed])
        np.testing.assert_array_equal(out["syllable"], preds["syllable"][seed])


def test_stage_cli_and_separate_train_states(tmp_path):
    """The CLI with --device cpu, and train_state_dir: one resumable state
    per (target, seed), and a resumed run trains on."""
    import yaml

    sample_dir = _subject(str(tmp_path))
    ts_dir = str(tmp_path / "train_state")
    cfg = _stage_config(str(tmp_path), sample_dir, True, train_state_dir=ts_dir, epochs=3)
    cfg["training"]["params"]["experiment"]["repeat"] = 1
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    log_dir = train_classifier.main([str(cfg_path), "--device", "cpu"])
    assert os.path.exists(os.path.join(log_dir, "results.csv"))
    states = sorted(os.listdir(ts_dir))
    assert len(states) == 2 and states[0].startswith("syllable_") and \
        states[1].startswith("tone_") and all("subject_1" in s for s in states)
    cfg["training"]["params"]["training"].update(epochs=6, resume=True)
    log_dir = train_classifier.run(cfg, device="cpu")
    seed_dir = os.path.join(log_dir, "tone_csv", "subject_1")
    with open(os.path.join(seed_dir, os.listdir(seed_dir)[0], "metrics.csv")) as f:
        assert len(f.readlines()) == 1 + 6  # 3 epochs restored with the state, 3 new
