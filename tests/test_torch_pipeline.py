"""The port's YAML pipeline runner against the JAX package's.

One config and one synthetic subject (12 channels, 2 x 48 trials,
logistic classifiers, evaluation and visualisation on) run through
``python -m decode_tonal_langauge_tpu.pipeline`` semantics in-process for
JAX and through ``python -m decode_tonal_langauge_tpu_torch <config>
--device cpu`` for the port, at the same paths: the sample npz's keys,
shapes, labels and rates, the channel JSONs and the class-count JSON
must be equal (its epochs within the preprocess stage's rtol/atol 1e-3,
since the recordings they are cut from agree to float32 rounding, not
bit for bit), ``results.csv``
must have the same columns and target rows, and the port's evaluation
rows must equal its training rows. Also: every stage, plugin and model
path of ``configs/*.yaml`` resolves in the port; a user's own
``nn.Module`` trains through the factory's dotted-path escape hatch; the
profiling hooks and the five figure functions the port adds.
"""

import csv
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from torch import nn

from decode_tonal_langauge_tpu.data.synthetic import SyntheticSpec as JSpec
from decode_tonal_langauge_tpu.data.synthetic import write_subject as jwrite_subject
from decode_tonal_langauge_tpu.pipeline import STAGES as JSTAGES
from decode_tonal_langauge_tpu.pipeline import run_pipeline as jrun_pipeline
from decode_tonal_langauge_tpu.pipeline import update_stage_cfg_io as jupdate_io
from decode_tonal_langauge_tpu_torch import pipeline, registry
from decode_tonal_langauge_tpu_torch.config import load_config
from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject
from decode_tonal_langauge_tpu_torch.models.factory import resolve_model_class
from decode_tonal_langauge_tpu_torch.runtime.profiling import StageTimer, trace
from decode_tonal_langauge_tpu_torch.training import train_classifier
from decode_tonal_langauge_tpu_torch.utils import visualise
from decode_tonal_langauge_tpu_torch.visualisation import main as visualisation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
IDS = [os.path.basename(p) for p in CONFIGS]
SPEC = dict(n_channels=12, n_blocks=2, trials_per_block=48, ecog_sf=400.0,
            audio_sf=800.0, active_channels=tuple(range(8)),
            tone_channels=(0, 1, 2, 3), syllable_channels=(4, 5, 6, 7))


def _config(root):
    """``configs/example_config.yaml`` with its paths under ``root``, the
    synthetic subject's 400 Hz rate (no downsample step), evaluation on
    and checkpoints saved."""
    cfg = load_config(os.path.join(REPO, "configs", "example_config.yaml"))
    pre = cfg["preprocess"]["params"]
    pre["io"]["params"].update(root_dir=f"{root}/raw", output_dir=f"{root}/processed")
    steps = pre["modalities"]["ecog"]["preprocessing"]["steps"]
    steps[1]["params"]["bands"][0]["params"]["freq_ranges"] = [70, 120]
    pre["modalities"]["ecog"]["preprocessing"]["steps"] = steps[1:]
    io = cfg["sample_collection"]["params"]["io"]
    io.update(output_dir=f"{root}/samples", textgrid_root=f"{root}/raw")
    cfg["channel_selection"]["params"]["io"]["output_dir"] = f"{root}/selection"
    cfg["training"]["params"]["io"]["log_dir"] = f"{root}/logs"
    cfg["training"]["params"]["training"]["save_checkpoints"] = True
    cfg["evaluation"]["module"] = "evaluation_main"
    return cfg


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _outputs(out):
    """The files both packages' runs must agree on."""
    with open(os.path.join(out["channel_selection"], "subject_1.json")) as f:
        selection = json.load(f)
    with open(os.path.join(out["training"], "n_classes_subject_1.json")) as f:
        n_classes = json.load(f)
    samples = dict(np.load(os.path.join(out["sample_collection"], "subject_1.npz")))
    return {"selection": selection, "n_classes": n_classes, "samples": samples,
            "results": _rows(os.path.join(out["training"], "results.csv")),
            "evaluation": _rows(os.path.join(out["evaluation"], "results.csv"))}


def test_full_pipeline_equals_jax(tmp_path):
    root = str(tmp_path / "run")  # one path for both: it is in the hashed names
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_config(root), f)
    jwrite_subject(f"{root}/raw", 1, JSpec(**SPEC))
    jout = jrun_pipeline(cfg_path)
    want = _outputs(jout)
    os.rename(root, str(tmp_path / "jax"))

    write_subject(f"{root}/raw", 1, SyntheticSpec(**SPEC))
    proc = subprocess.run(
        [sys.executable, "-m", "decode_tonal_langauge_tpu_torch", cfg_path, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "----------- Stage timing -----------" in proc.stdout
    layers = proc.stdout.split("----------- Layer spans, most self time -----------")[1]
    assert "trainer.step: self " in layers and "optim.nadam: self " in layers
    for stage in ("preprocess", "sample_collection", "channel_selection", "training",
                  "evaluation", "visualisation"):
        assert os.path.exists(jout[stage]), stage
    got = _outputs(jout)

    assert sorted(got["samples"]) == sorted(want["samples"])
    for key, value in want["samples"].items():
        assert got["samples"][key].shape == value.shape, key
        if key in ("ecog", "ecog_rest", "audio"):
            # the preprocessed recordings they are cut from agree within
            # the preprocess stage's tolerance, not bit for bit
            np.testing.assert_allclose(got["samples"][key], value, rtol=1e-3, atol=1e-3)
        else:
            np.testing.assert_array_equal(got["samples"][key], value, err_msg=key)
    assert got["selection"] == want["selection"]
    assert set(got["selection"]["tone_discriminative"]) & {0, 1, 2, 3}
    assert set(got["selection"]["syllable_discriminative"]) & {4, 5, 6, 7}
    assert got["n_classes"] == want["n_classes"]
    for name in ("results", "evaluation"):
        assert list(got[name][0]) == list(want[name][0])
        for key in ("model_name", "subject", "target", "channels", "seeds"):
            assert [r[key] for r in got[name]] == [r[key] for r in want[name]]
    assert got["evaluation"] == got["results"]
    by_target = {r["target"]: r for r in got["results"]}
    assert float(by_target["syllable"]["accuracy_mean"]) > 0.65
    for fig in ("accuracy_by_subject.png", "subject_1_channel_venn.png"):
        assert os.path.exists(os.path.join(jout["visualisation"], fig))


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_shipped_config_paths_resolve_in_the_port(path):
    config = load_config(path)
    resolved = 0
    for stage in pipeline.STAGES:
        stage_cfg = config.get(stage)
        if stage_cfg and stage_cfg.get("module"):
            module = registry.resolve(stage_cfg["module"])
            assert module.__name__.startswith("decode_tonal_langauge_tpu_torch.")
            assert callable(getattr(module, stage_cfg.get("function", "run")))
            resolved += 1
    assert resolved >= 5
    pre = config["preprocess"]["params"]
    for section in ("pipeline", "io", "preprocessor"):
        registry.resolve(pre[section]["module"])
    for modality in pre["modalities"].values():
        for step in (modality.get("preprocessing") or {}).get("steps", []):
            assert callable(registry.resolve(step["module"]).run)
    for sel in config["channel_selection"]["params"]["selections"]:
        assert callable(registry.resolve(sel["module"]).run)
    model_cfg = config["model"]
    paths = [model_cfg["model"]] + [o["model"] for o in
                                    (model_cfg.get("per_target") or {}).values()]
    for model_path in paths:
        assert issubclass(resolve_model_class(model_path), nn.Module)
    for name in ("models.synthesis_models.SynthesisModelCNN",
                 "models.synthesis_models.SynthesisLite"):
        module_path, cls = registry.canonical_module_path(name).rsplit(".", 1)
        assert issubclass(getattr(__import__(module_path, fromlist=[cls]), cls), nn.Module)


def test_stage_list_and_io_threading_equal_jax():
    assert pipeline.STAGES == JSTAGES
    outputs = {s: f"/out/{s}" for s in JSTAGES}
    for stage in JSTAGES:
        for partial in ({}, {"params": {"io": {"sample_dir": "mine"}}}):
            got, want = json.loads(json.dumps(partial)), json.loads(json.dumps(partial))
            pipeline.update_stage_cfg_io(outputs, stage, got)
            jupdate_io(outputs, stage, want)
            assert got == want


def test_run_pipeline_passes_device_and_calls_user_functions(monkeypatch, capsys):
    """A port stage gets the resolved device; a user function gets the
    config alone; the compilation-cache section is noted; ``parallel:
    auto`` in one process is one process, and a parallel section that asks
    for more ranks than run raises once the training stage builds its
    mesh."""
    import types

    calls = []
    user = types.ModuleType("user_stage")
    user.go = lambda config: calls.append(("user", sorted(config))) or "/user/out"
    monkeypatch.setitem(sys.modules, "user_stage", user)
    port = types.ModuleType("port_like_stage")
    port.run = lambda config, device=None: calls.append(("port", device)) or None
    monkeypatch.setitem(sys.modules, "port_like_stage", port)
    out = pipeline.run_pipeline({
        "preprocess": {"module": "user_stage", "function": "go"},
        "training": {"module": "port_like_stage"},
        "parallel": {"data": "auto"}, "compilation_cache": True,
        "profiling": {"timing": False},
    }, device="cpu")
    assert out == {"preprocess": "/user/out"}
    assert calls[0][0] == "user" and calls[1] == ("port", torch.device("cpu"))
    text = capsys.readouterr().out
    assert "parallel:" not in text and "compilation_cache: accepted" in text
    assert "Stage timing" not in text
    from decode_tonal_langauge_tpu_torch.parallel.mesh import mesh_from_config

    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh_from_config({"data": 2})


class TinyClassifier(nn.Module):
    """A user's own classifier, named by dotted path in a config."""

    def __init__(self, n_channels: int, seq_length: int, n_classes: int, width: int = 4):
        super().__init__()
        self.proj = nn.Linear(n_channels * seq_length, width)
        self.head = nn.Linear(width, n_classes)

    def forward(self, x):
        return self.head(torch.tanh(self.proj(x.reshape(x.shape[0], -1))))


def test_factory_escape_hatch_trains_a_user_class(tmp_path):
    path = f"{__name__}.TinyClassifier"
    assert resolve_model_class(path) is TinyClassifier
    with pytest.raises(TypeError, match="nn.Module"):
        resolve_model_class(f"{__name__}.SPEC")
    with pytest.raises(ValueError, match="cannot import"):
        resolve_model_class(f"{__name__}.Missing")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 3, 8)).astype(np.float32)
    syll = np.tile([0, 1], 20)
    x[syll == 1] += 2.0
    samples = tmp_path / "samples"
    samples.mkdir()
    np.savez(samples / "subject_1.npz", ecog=x, ecog_sf=100.0, syllable=syll)
    log_dir = train_classifier.run({
        "model": {"model": path, "model_kwargs": {"width": 6}},
        "training": {"params": {
            "io": {"log_dir": str(tmp_path / "logs"), "sample_dir": str(samples)},
            "experiment": {"targets": ["syllable"], "separate_models": False,
                           "seed": 1, "repeat": 1, "verbose": 0},
            "training": {"train_ratio": 0.6, "vali_ratio": 0.2, "test_ratio": 0.2,
                         "batch_size": 8, "epochs": 1, "lr": 0.01, "patience": 5},
        }},
        "evaluation": {"metrics": ["accuracy"]},
    }, device="cpu")
    rows = _rows(os.path.join(log_dir, "results.csv"))
    assert rows[0]["model_name"] == "TinyClassifier"
    assert int(rows[0]["model_size"]) == 3 * 8 * 6 + 6 + 6 * 2 + 2
    assert np.isfinite(float(rows[0]["accuracy_mean"]))


def test_stage_timer_and_timed():
    timer = StageTimer()
    for name in ("a", "b", "a"):
        with timer.span(name):
            pass
    assert set(timer.spans) == {"a", "b"}
    lines = timer.summary().splitlines()
    assert len(lines) == 2 and all(line.split(":")[0] in "ab" for line in lines)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        pass
    with trace(str(tmp_path), name="training"):
        torch.ones(8).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("training.")
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_new_figures_are_written(tmp_path):
    rng = np.random.default_rng(0)
    rec = rng.standard_normal((4, 1200)).astype(np.float32)
    rows = [{"model_name": "logistic", "model_size": 100, "subject": 1,
             "target": "tone", "accuracy_mean": 0.5, "accuracy_std": 0.1}]
    draws = {
        "diff": lambda p: visualise.compare_confusion_matrices(
            np.eye(3) * 4, np.ones((3, 3)), ["a", "b", "c"], figure_path=p),
        "psd": lambda p: visualise.plot_psd(rec, 400.0, figure_path=p, fmax=100),
        "stats": lambda p: visualise.plot_channel_mean_std(rec, 400.0, figure_path=p),
        "venn": lambda p: visualise.plot_channel_venn_diagram(
            {"a": {1, 2, 3}, "b": {2, 3, 4}, "c": {3, 5}}, figure_path=p),
        "metric": lambda p: visualise.plot_metric(
            rows, "accuracy", chance_level={"tone": 0.25}, figure_path=p),
    }
    for name, draw in draws.items():
        path = str(tmp_path / f"{name}.png")
        draw(path)
        assert os.path.getsize(path) > 0, name
    with pytest.raises(ValueError, match="3 sets"):
        visualise.plot_channel_venn_diagram({"a": set()})


def test_visualisation_stage_reads_results_with_csv(tmp_path, capsys):
    results = tmp_path / "results"
    results.mkdir()
    with open(results / "results.csv", "w") as f:
        f.write("model_name,model_size,subject,target,channels,accuracy_mean,"
                "accuracy_std,f1_score_mean\nlogistic,10,1,tone,\"0,1\",0.5,,0.4\n")
    cfg = {"visualisation": {"params": {"io": {"results_dir": str(results)}}}}
    assert visualisation.run(cfg) == str(results / "figures")
    assert sorted(os.listdir(results / "figures")) == [
        "accuracy_by_subject.png", "f1_score_by_subject.png"]
    columns, rows = visualisation.read_results(str(results / "results.csv"))
    assert visualisation._metrics_in(columns) == ["accuracy", "f1_score"]
    assert rows[0]["subject"] == 1 and rows[0]["channels"] == "0,1"
    assert np.isnan(rows[0]["accuracy_std"])
    empty = {"visualisation": {"params": {"io": {"output_dir": str(tmp_path / "f")}}}}
    assert visualisation.run(empty) is None
    assert "nothing to plot" in capsys.readouterr().out
