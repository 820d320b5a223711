"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (nor flax, optax, sklearn, pandas, matplotlib or tensorboardX,
which the card's machine lacks), and its entry points default to CUDA
instead of falling back to the CPU: serving, preprocessing, classifier
and synthesizer training, sample extraction, channel selection,
evaluation, the pipeline runner and the end-to-end demo
(``scripts/demo_end_to_end_torch.py``, which raises before it writes
anything). The port's scripts ``scripts/demo_end_to_end_torch.py`` and
``scripts/generate_synthetic_data_torch.py`` import without JAX too.
Without matplotlib the visualisation stage makes no figures and returns
None."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "decode_tonal_langauge_tpu",
           "sklearn", "pandas", "matplotlib", "tensorboardX")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
sys.modules["decode_tonal_langauge_tpu"] = None

import decode_tonal_langauge_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
import importlib.util
scripts = {}
for script in ("demo_end_to_end_torch", "generate_synthetic_data_torch"):
    spec = importlib.util.spec_from_file_location(script, f"scripts/{script}.py")
    scripts[script] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scripts[script])  # imported, main not run
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED
            and sys.modules[m] is not None]

import numpy as np
import torch
torch.cuda.is_available = lambda: False  # a machine without a card

from argparse import Namespace

from decode_tonal_langauge_tpu_torch import pipeline
from decode_tonal_langauge_tpu_torch.channel_selection import active, discriminative
from decode_tonal_langauge_tpu_torch.channel_selection import main as cs_main
from decode_tonal_langauge_tpu_torch.data import extract_samples
from decode_tonal_langauge_tpu_torch.evaluation import main as evaluation_main
from decode_tonal_langauge_tpu_torch.visualisation import main as visualisation_main
from decode_tonal_langauge_tpu_torch.models.factory import (
    build_synthesis_model,
    get_classifier_by_name,
)
from decode_tonal_langauge_tpu_torch.preprocess import main as preprocess_main
from decode_tonal_langauge_tpu_torch.preprocess.preprocessor import preprocess_signal
from decode_tonal_langauge_tpu_torch.runtime.device import resolve_device
from decode_tonal_langauge_tpu_torch.serving import TonalDecoder
from decode_tonal_langauge_tpu_torch.training import train_classifier, train_synthesizer
from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import SynthesisTrainer
from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer
from decode_tonal_langauge_tpu_torch.utils.audio import audio_to_mel, mels_to_audio

model = get_classifier_by_name("logistic", 2, 2, 4)
synth = build_synthesis_model("SynthesisLite", 8, 2, 4)
synth_data = [np.zeros((4, 2, 4), np.float32)] * 3 + [np.zeros((4, 8), np.float32)]
steps = [{"module": "channel_zscore"}]
import os, tempfile
demo_dir = os.path.join(tempfile.mkdtemp(), "demo_run")
calls = [
    lambda: resolve_device(None),
    lambda: TonalDecoder(model, model, {"0": [0.0]}),
    lambda: mels_to_audio(np.zeros((1, 8), np.float32), n_mels=8),
    lambda: audio_to_mel(np.zeros(4096, np.float32), 8000),
    lambda: preprocess_main.run({"preprocess": {"params": {}}}),
    lambda: preprocess_signal(np.zeros((2, 8), np.float32), steps, Namespace(signal_freq=8.0)),
    lambda: train_classifier.run({"training": {"params": {}}}),
    lambda: ClassifierTrainer(model, 2).fit(*([np.zeros((4, 2, 4), np.float32),
                                              np.zeros(4, np.int64)] * 2)),
    lambda: SynthesisTrainer(synth, model, model, {"0": [0.0]}).train(synth_data, 1),
    lambda: train_synthesizer.main(["--sample_path", "s.npz", "--subject_id", "1",
                                    "--result_file", "r.csv", "--model_name", "m",
                                    "--synthesis_model_name", "SynthesisLite",
                                    "--syllable_model_name", "logistic",
                                    "--tone_model_name", "logistic"]),
    lambda: extract_samples.run({"sample_collection": {"params": {}}}),
    lambda: cs_main.run({"channel_selection": {"params": {}}}),
    lambda: active.run({}, {}),
    lambda: discriminative.run({}, {}),
    lambda: evaluation_main.run({"evaluation": {"params": {}}}),
    lambda: pipeline.run_pipeline({}),
    lambda: scripts["demo_end_to_end_torch"].main([demo_dir]),
]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("an entry point ran without a card")
assert not os.path.exists(demo_dir)  # the demo raised before writing anything
assert str(TonalDecoder(model, model, {"0": [0.0]}, device="cpu").device) == "cpu"
trainer = SynthesisTrainer(synth, model, model, {"0": [0.0], "1": [1.0]}, verbose=False,
                           device="cpu")
assert len(trainer.train(synth_data, 1, batch_size=4, verbose=False)) == 1
out, _ = preprocess_signal(np.ones((2, 8), np.float32), steps, Namespace(signal_freq=8.0),
                           device="cpu")
assert out.device.type == "cpu"
import contextlib, io
note = io.StringIO()
with contextlib.redirect_stdout(note):
    assert visualisation_main.run({"visualisation": {"params": {}}}) is None
assert note.getvalue().startswith("Visualisation stage made no figures"), note.getvalue()
print("isolated", len(names))
"""


def test_port_imports_without_jax_and_defaults_to_cuda():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("isolated")
    assert int(out.stdout.split()[-1]) >= 40  # every module was imported


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Where torch sees no card, chip_smoke exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
