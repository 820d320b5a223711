"""The port's end-to-end demo against the JAX package's.

``scripts/demo_end_to_end.py`` (JAX, ``JAX_PLATFORMS=cpu``) and
``scripts/demo_end_to_end_torch.py --device cpu`` run side by side, each
in a subprocess of one torch thread into its own directory. The port's
demo runs with JAX, the JAX package, and the packages the card's machine
lacks (matplotlib, sklearn, pandas, tensorboardX) marked absent, so it
shows the demo runs where JAX is not installed. They are marked absent
the way an uninstalled package is (``sys.modules[name] = None``: import
raises, ``importlib.util.find_spec`` returns None), not with
``tests/test_torch_isolation.py``'s finder that raises: ``torch._dynamo``,
which ``torch.func`` loads for the seed-batched fit, probes third-party
packages with ``find_spec`` and takes None, not an error, for absent.

Held equal between the two: the raw subject of step 1 (byte for byte,
and array for array), the relative file list (a torch checkpoint file
where JAX writes an Orbax directory; no figures and no TensorBoard event
files without matplotlib and tensorboardX), every CSV's header (a confusion
matrix's shape: it has none), the
hashed directory names (the configs' paths are relative to the workdir,
so the names do not depend on it), the channel-selection JSON, the
decoded trial and stream window counts, the synthesizer's model size and
seeds, the mel files' keys and shapes and the WAVs' count, rate and
lengths. Accuracies, MCDs and event counts are not compared: the port's
permutations and dropout come from other random streams than JAX's (a
deliberate difference), so the two runs train to different numbers.
They are checked finite, with the syllable accuracy above chance (0.5).

``scripts/generate_synthetic_data_torch.py`` writes the same files as
``scripts/generate_synthetic_data.py``, byte for byte.
"""

import csv
import glob
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TIMEOUT_S = 600
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "decode_tonal_langauge_tpu",
           "sklearn", "pandas", "matplotlib", "tensorboardX")

_PORT_RUN = r"""
import runpy, sys
BLOCKED = {blocked!r}
for name in BLOCKED:
    sys.modules[name] = None  # absent, as where the package is not installed
sys.argv = [{script!r}, {workdir!r}, "--device", "cpu"]
runpy.run_path({script!r}, run_name="__main__")
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not loaded, loaded
print("no blocked module was loaded", file=sys.stderr)
"""


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core then oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _summary(stdout: str) -> dict:
    """The JSON summary that ends both demos' output."""
    return json.loads(stdout[stdout.rindex("\n{\n") + 1:])


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """Both demos, run at once; returns {name: (workdir, stdout, stderr)}."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    runs = {
        "jax": ([sys.executable, os.path.join(SCRIPTS, "demo_end_to_end.py")],
                {**env, "JAX_PLATFORMS": "cpu"}),
        "port": ([sys.executable, "-c"], env),
    }
    procs, dirs = {}, {}
    for name, (cmd, run_env) in runs.items():
        dirs[name] = str(tmp_path_factory.mktemp(name) / "demo_run")
        if name == "port":
            cmd = cmd + [_PORT_RUN.format(
                blocked=BLOCKED, script=os.path.join(SCRIPTS, "demo_end_to_end_torch.py"),
                workdir=dirs[name])]
        else:
            cmd = cmd + [dirs[name]]
        procs[name] = subprocess.Popen(cmd, cwd=REPO, env=run_env, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, (name, stderr[-4000:])
            out[name] = (dirs[name], stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _layout(root: str) -> set:
    """Relative file paths, each Orbax checkpoint directory as one entry
    (the port writes one torch file under its name)."""
    ckpts = {os.path.relpath(os.path.dirname(p), root) for p in
             glob.glob(os.path.join(root, "**", "_CHECKPOINT_METADATA"), recursive=True)}
    out = set()
    for path in _files(root):
        top = next((c for c in ckpts if path.startswith(c + os.sep)), None)
        out.add(top or path)
    return out


def _table(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _rows(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _hashed_dirs(root: str) -> dict:
    return {stage: sorted(os.listdir(os.path.join(root, stage)))
            for stage in ("processed", "samples", "channel_selection", "logs")}


def test_both_demos_run_and_the_port_loads_no_jax(demos):
    _, stdout, stderr = demos["port"]
    assert "no blocked module was loaded" in stderr
    assert "Visualisation stage made no figures" in stdout
    assert "step walls (s): " in stdout
    walls = json.loads(stdout.split("step walls (s): ")[1].splitlines()[0])
    assert list(walls) == ["synthetic", "pipeline", "synthesizer", "serving", "stream", "total"]
    assert all(np.isfinite(v) and v > 0 for v in walls.values())
    for name in ("jax", "port"):
        assert sorted(_summary(demos[name][1])) == ["epochs", "stream"]


def test_step_1_writes_the_same_raw_subject(demos):
    jdir, pdir = demos["jax"][0], demos["port"][0]
    raw = _files(os.path.join(jdir, "raw"))
    assert raw == _files(os.path.join(pdir, "raw"))
    assert {"Sub1/HS1-B1/raw.npz", "Sub1/HS1-B2/raw.npz", "annotations/subject_1/B1.TextGrid",
            "annotations/subject_1/B2.TextGrid"} <= set(raw)
    for rel in raw:
        with open(os.path.join(jdir, "raw", rel), "rb") as f, \
                open(os.path.join(pdir, "raw", rel), "rb") as g:
            assert f.read() == g.read(), rel
        if rel.endswith(".npz"):
            want, got = np.load(os.path.join(jdir, "raw", rel)), np.load(
                os.path.join(pdir, "raw", rel))
            assert sorted(want) == sorted(got)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{rel}:{key}")


def test_both_demos_write_the_same_file_layout(demos):
    jax_files = _layout(demos["jax"][0])
    figures = {p for p in jax_files if p.endswith(".png")}
    events = {p for p in jax_files if os.path.basename(p).startswith("events.out.tfevents.")}
    assert figures and events  # the JAX side has matplotlib and tensorboardX
    port_files = _layout(demos["port"][0])
    assert port_files == jax_files - figures - events
    ckpts = [p for p in port_files if "model_checkpoints" in p or p.startswith("synth/ckpt")]
    assert len(ckpts) == 5  # 2 targets x 2 seeds, 1 synthesizer
    assert all(os.path.isfile(os.path.join(demos["port"][0], p)) for p in ckpts)


def test_every_csv_has_the_same_header(demos):
    jdir, pdir = demos["jax"][0], demos["port"][0]
    csvs = sorted(p for p in _layout(pdir) if p.endswith(".csv"))
    assert {"synth/results.csv", "decoded/predictions.csv", "streamed/windows.csv",
            "streamed/events.csv"} <= set(csvs)
    for path in ("results.csv", "evaluation/results.csv"):
        assert any(p.startswith("logs/") and p.endswith(path) for p in csvs), path
    for rel in csvs:
        got, want = _table(os.path.join(pdir, rel)), _table(os.path.join(jdir, rel))
        if os.path.basename(rel).startswith("confusion_matrix"):  # no header: the shape
            assert (len(got), len(got[0])) == (len(want), len(want[0])), rel
        else:
            assert got[0] == want[0], rel


def test_hashed_directory_names_are_equal(demos):
    want = _hashed_dirs(demos["jax"][0])
    assert _hashed_dirs(demos["port"][0]) == want
    assert len(want["logs"]) == 1 and want["logs"][0].startswith("logistic__")
    assert len(want["samples"]) == 1 and want["samples"][0].startswith(want["processed"][0] + "__")


def test_counts_and_shapes_are_equal(demos):
    jdir, pdir = demos["jax"][0], demos["port"][0]

    def one(root, pattern):
        (path,) = glob.glob(os.path.join(root, pattern))
        return path

    with open(one(jdir, "channel_selection/*/subject_1.json")) as f, \
            open(one(pdir, "channel_selection/*/subject_1.json")) as g:
        assert json.load(g) == json.load(f)
    jsum, psum = _summary(demos["jax"][1]), _summary(demos["port"][1])
    assert psum["epochs"]["n_trials"] == jsum["epochs"]["n_trials"] == 96
    assert psum["stream"]["n_windows"] == jsum["stream"]["n_windows"] > 0
    for key in ("window_s", "hop_s", "recording_s", "n_wavs"):
        assert psum["stream"][key] == jsum["stream"][key], key
    assert psum["epochs"]["n_wavs"] == jsum["epochs"]["n_wavs"] == 2
    (jrow,), (prow,) = _rows(one(jdir, "synth/results.csv")), _rows(one(pdir, "synth/results.csv"))
    for key in ("model_name", "synthesis_model", "subject", "model_size", "seeds"):
        assert prow[key] == jrow[key], key
    for rel in ("decoded/mels.npz", "streamed/mels.npz"):
        want, got = np.load(os.path.join(jdir, rel)), np.load(os.path.join(pdir, rel))
        assert sorted(got) == sorted(want), rel
        for key in want:
            assert got[key].shape == want[key].shape, (rel, key)
        assert int(got["n_mels"]) == int(want["n_mels"]) == 16
    wavs = sorted(p for p in _layout(jdir) if p.endswith(".wav"))
    assert wavs == sorted(p for p in _layout(pdir) if p.endswith(".wav")) and len(wavs) == 23
    for rel in wavs:
        (jrate, jwav), (prate, pwav) = (wavfile.read(os.path.join(d, rel)) for d in (jdir, pdir))
        assert prate == jrate == 800, rel
        assert pwav.shape == jwav.shape, rel


def test_the_ports_numbers_are_finite_and_above_chance(demos):
    pdir = demos["port"][0]
    epochs = _summary(demos["port"][1])["epochs"]
    assert all(np.isfinite(epochs[k]) for k in ("tone_accuracy", "syllable_accuracy", "mel_mcd",
                                                "mel_pearson_r"))
    assert epochs["syllable_accuracy"] > 0.5
    for rel in sorted(p for p in _layout(pdir) if p.endswith(".csv")):
        for row in _rows(os.path.join(pdir, rel)):
            for key, value in row.items():
                try:
                    number = float(value)
                except ValueError:
                    continue
                assert np.isfinite(number), (rel, key, value)
    (logs,) = glob.glob(os.path.join(pdir, "logs", "logistic__*"))
    assert _rows(os.path.join(logs, "evaluation", "results.csv")) == _rows(
        os.path.join(logs, "results.csv"))
    assert _summary(demos["port"][1])["stream"]["n_events"] > 0


def test_generate_synthetic_data_torch_equals_the_jax_script(tmp_path, monkeypatch, capsys):
    args = ["--channels", "6", "--blocks", "2", "--trials", "8"]
    for name, script in (("jax", "generate_synthetic_data.py"),
                         ("port", "generate_synthetic_data_torch.py")):
        monkeypatch.setattr(sys, "argv", [script, str(tmp_path / name)] + args)
        runpy.run_path(os.path.join(SCRIPTS, script), run_name="__main__")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].split("->")[0] == out[1].split("->")[0]
    assert "2 blocks, 16 trials, 6 channels" in out[1]
    want = _files(str(tmp_path / "jax"))
    assert want == _files(str(tmp_path / "port")) and len(want) == 4
    for rel in want:
        with open(tmp_path / "jax" / rel, "rb") as f, open(tmp_path / "port" / rel, "rb") as g:
            assert f.read() == g.read(), rel
